// The Lucas-Kanade iteration loop of one track, shared by the fused LK level
// kernel (lk_level_fused.cu, K3: it builds the template in-kernel) and the
// template-passed-in LK level kernel (lk_level_tmpl.cu, K4).
//
// One warp runs one track.  The search window B1 (WIN x WIN, row-major) and
// the P x P template lie in shared memory; the 32 lanes share the P*P patch
// pixels and meet in five warp butterflies per iteration.
//
// Geometry, relative to the search window's clamped start (never to
// anything else - see lk_common.cuh):
//   each iteration: q = base + v; qi = clip(floor(q), 1, WIN-P-2);
//   f = q - qi is NOT clamped (it extrapolates when the clip bites);
//   sub-window origin = qi - 1.
// Arithmetic follows the plain PyTorch version operation for operation
// (__fmul_rn/__fadd_rn keep the compiler from contracting a*b+c into an fma,
// which rounds once instead of twice); only the order of the P*P sums
// differs (per-lane partial sums, then the butterfly).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sfm {

// w00*(1-fx)*(1-fy) + w01*fx*(1-fy) + w10*(1-fx)*fy + w11*fx*fy, evaluated
// left to right like the plain version, without fma contraction.
__device__ __forceinline__ float bilinear(const float* b, int stride, int y,
                                          int x, float fx, float fy,
                                          float gx, float gy) {
    // gx = 1 - fx, gy = 1 - fy (computed once by the caller)
    float w00 = b[y * stride + x];
    float w01 = b[y * stride + x + 1];
    float w10 = b[(y + 1) * stride + x];
    float w11 = b[(y + 1) * stride + x + 1];
    float a = __fmul_rn(__fmul_rn(w00, gx), gy);
    float c = __fmul_rn(__fmul_rn(w01, fx), gy);
    float d = __fmul_rn(__fmul_rn(w10, gx), fy);
    float e = __fmul_rn(__fmul_rn(w11, fx), fy);
    return __fadd_rn(__fadd_rn(__fadd_rn(a, c), d), e);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// `iters` LK updates of the flow (vx, vy) of one track; every lane of the
// warp returns the same flow.
__device__ __forceinline__ void lk_iterate(const float* B1, int WIN,
                                           const float* tmpl, int P,
                                           float basex, float basey,
                                           int iters, float min_det,
                                           int lane, float& vx, float& vy) {
    const float qhi = (float)(WIN - P - 2);
    for (int it = 0; it < iters; ++it) {
        const float qx = __fadd_rn(basex, vx), qy = __fadd_rn(basey, vy);
        // fmaxf/fminf return the other operand for a NaN: a NaN track gets
        // an in-range origin, and its NaN fraction makes its flow NaN
        const float qix = fminf(fmaxf(floorf(qx), 1.0f), qhi);
        const float qiy = fminf(fmaxf(floorf(qy), 1.0f), qhi);
        const float fx = __fsub_rn(qx, qix), fy = __fsub_rn(qy, qiy);
        const float gx1 = __fsub_rn(1.0f, fx), gy1 = __fsub_rn(1.0f, fy);
        const int ox = (int)qix - 1, oy = (int)qiy - 1;

        float gxx = 0.f, gxy = 0.f, gyy = 0.f, bx = 0.f, by = 0.f;
        for (int i = lane; i < P * P; i += 32) {
            int y = i / P, x = i - y * P;
            int yy = oy + 1 + y, xx = ox + 1 + x;
            float cur = bilinear(B1, WIN, yy, xx, fx, fy, gx1, gy1);
            float gxp = bilinear(B1, WIN, yy, xx + 1, fx, fy, gx1, gy1);
            float gxm = bilinear(B1, WIN, yy, xx - 1, fx, fy, gx1, gy1);
            float gyp = bilinear(B1, WIN, yy + 1, xx, fx, fy, gx1, gy1);
            float gym = bilinear(B1, WIN, yy - 1, xx, fx, fy, gx1, gy1);
            float gx = __fmul_rn(0.5f, __fsub_rn(gxp, gxm));
            float gy = __fmul_rn(0.5f, __fsub_rn(gyp, gym));
            float res = __fsub_rn(tmpl[i], cur);
            gxx = __fadd_rn(gxx, __fmul_rn(gx, gx));
            gxy = __fadd_rn(gxy, __fmul_rn(gx, gy));
            gyy = __fadd_rn(gyy, __fmul_rn(gy, gy));
            bx = __fadd_rn(bx, __fmul_rn(gx, res));
            by = __fadd_rn(by, __fmul_rn(gy, res));
        }
        gxx = warp_sum(gxx);
        gxy = warp_sum(gxy);
        gyy = warp_sum(gyy);
        bx = warp_sum(bx);
        by = warp_sum(by);

        const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
        const float inv_det = fabsf(det) > min_det ? __fdiv_rn(1.0f, det) : 0.0f;
        const float dvx = __fmul_rn(
            __fsub_rn(__fmul_rn(gyy, bx), __fmul_rn(gxy, by)), inv_det);
        const float dvy = __fmul_rn(
            __fsub_rn(__fmul_rn(gxx, by), __fmul_rn(gxy, bx)), inv_det);
        vx = __fadd_rn(vx, dvx);
        vy = __fadd_rn(vy, dvy);
    }
}

}  // namespace sfm
