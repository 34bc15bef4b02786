// The Lucas-Kanade iteration loop of one track, shared by the fused LK level
// kernel (lk_level_fused.cu, K3: it builds the template in-kernel) and the
// template-passed-in LK level kernel (lk_level_tmpl.cu, K4).
//
// One warp runs one track.  The search window B1 (WIN x WIN), the P x P
// template and one (P+2) x (P+2) map buffer M lie in shared memory.  Each
// update:
//   1. the warp evaluates the bilinear map M[y][x] = bilinear(B1, oy+y, ox+x)
//      of the (P+2)^2 pixels around the patch once (sfm::bilinear_map);
//   2. each patch pixel reads cur = M[y+1][x+1] and its four neighbours
//      g+-x = M[y+1][x+1+-1], g+-y = M[y+1+-1][x+1]: the same values the
//      five separate bilinear reads of the plain version compute, bit for
//      bit, since each is the same pixel of the same map;
//   3. the 5 per-lane sums meet in five warp butterflies; the 2x2 solve.
// The lane loops are templates on the patch size kP (kP = 0: P at run
// time), so that for a known P they unroll: constant trip counts, no
// division by a run-time P, independent shared-memory loads in flight
// together.
//
// Bank conflicts: lane l of a warp works on pixel l + 32k of a row-major
// run of rows of width w (w = P+2 for the map, P for the patch).  A buffer
// read that way has row stride = w (mod 32) (bank_stride), so that the 32
// lanes fall on 32 distinct banks at every offset: B1 at bank_stride(P+2,
// WIN), M at bank_stride(P, P+2) = P+32.  (At P = 13 a stride of WIN+1 =
// 29 for B1, or P+2 = 15 for M, puts two lanes on one bank in most loads:
// twice the shared-memory wavefronts.)
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

#include <type_traits>

namespace sfm {

// Tracks (warps) per block of K3 and K4 (2 ran faster than 4 or 8 on an
// H100; PERF.md, Findings).
constexpr int kLkTracksPerBlock = 2;
// patch radii with a compile-time instantiation of the loop; any other
// radius runs the run-time-P instantiation of the same code
constexpr int kLkMaxRadius = 10;

// w00*(1-fx)*(1-fy) + w01*fx*(1-fy) + w10*(1-fx)*fy + w11*fx*fy, evaluated
// left to right like the plain version, without fma contraction; gx = 1 -
// fx, gy = 1 - fy (computed once by the caller).
__device__ __forceinline__ float blend(float w00, float w01, float w10,
                                       float w11, float fx, float fy,
                                       float gx, float gy) {
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

// Pixels per lane when the warp shares n pixels.
__host__ __device__ constexpr int lane_slots(int n) { return (n + 31) / 32; }

// The least row stride >= min_stride that is = width (mod 32).
__host__ __device__ constexpr int bank_stride(int width, int min_stride) {
    return width + 32 * ((min_stride - width + 31) / 32);
}

// The S x S bilinear map out[y * out_stride + x] = blend of b's 2 x 2
// pixels at (oy + y, ox + x); lane l evaluates pixels j = l, l+32, ...
// (y = j / S, x = j % S).  kS > 0: S = kS at compile time, and a lane
// issues all its loads before its first store (b and out never overlap,
// but a store the compiler cannot prove apart from the next loads would
// make the map one chain of dependent loads); kS = 0: S = s at run time.
template <int kS>
__device__ __forceinline__ void bilinear_map(const float* __restrict__ b,
                                             int stride, int oy, int ox,
                                             float fx, float fy, float gx,
                                             float gy,
                                             float* __restrict__ out,
                                             int out_stride, int s,
                                             int lane) {
    const int S = kS > 0 ? kS : s;
    const int n = S * S;
    const float* b0 = b + oy * stride + ox;
    if constexpr (kS > 0) {
        constexpr int kSlots = lane_slots(kS * kS);
        float w[kSlots][4];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int j = lane + 32 * k;
            if (j < n) {
                const float* q = b0 + (j / S) * stride + j % S;
                w[k][0] = q[0];
                w[k][1] = q[1];
                w[k][2] = q[stride];
                w[k][3] = q[stride + 1];
            }
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int j = lane + 32 * k;
            if (j < n)
                out[(j / S) * out_stride + j % S] = blend(
                    w[k][0], w[k][1], w[k][2], w[k][3], fx, fy, gx, gy);
        }
    } else {
        for (int j = lane; j < n; j += 32) {
            const float* q = b0 + (j / S) * stride + j % S;
            out[(j / S) * out_stride + j % S] =
                blend(q[0], q[1], q[stride], q[stride + 1], fx, fy, gx, gy);
        }
    }
}

// `iters` LK updates of the flow (vx, vy) of one track; every lane of the
// warp returns the same flow.  B1: the WIN x WIN search window at row
// stride WINS = bank_stride(P+2, WIN); M: map_floats(P) floats of scratch;
// kP > 0: P = kP at compile time; kP = 0: P = p at run time.
template <int kP>
__device__ __forceinline__ void lk_iterate(const float* __restrict__ B1,
                                           int WIN, int WINS,
                                           float* __restrict__ M,
                                           const float* __restrict__ tmpl,
                                           int p,
                                           float basex, float basey,
                                           int iters, float min_det,
                                           int lane, float& vx, float& vy) {
    constexpr int kS = kP > 0 ? kP + 2 : 0;
    const int P = kP > 0 ? kP : p;
    const int S = P + 2;
    const int SM = bank_stride(P, S);  // M's row stride
    const int n = P * P;
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

        bilinear_map<kS>(B1, WINS, oy, ox, fx, fy, gx1, gy1, M, SM, S,
                         lane);
        __syncwarp();

        float gxx = 0.f, gxy = 0.f, gyy = 0.f, bx = 0.f, by = 0.f;
#pragma unroll
        for (int k = 0; k < lane_slots(n); ++k) {
            const int i = lane + 32 * k;
            if (i < n) {
                const int y = i / P, x = i - y * P;
                const float* m = M + (y + 1) * SM + (x + 1);
                const float cur = m[0];
                const float gx = __fmul_rn(0.5f, __fsub_rn(m[1], m[-1]));
                const float gy = __fmul_rn(0.5f, __fsub_rn(m[SM], m[-SM]));
                const float res = __fsub_rn(tmpl[i], cur);
                gxx = __fadd_rn(gxx, __fmul_rn(gx, gx));
                gxy = __fadd_rn(gxy, __fmul_rn(gx, gy));
                gyy = __fadd_rn(gyy, __fmul_rn(gy, gy));
                bx = __fadd_rn(bx, __fmul_rn(gx, res));
                by = __fadd_rn(by, __fmul_rn(gy, res));
            }
        }
        __syncwarp();  // M is read; the next update may overwrite it
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

// Shared floats of the update's map buffer M: P+2 rows at stride
// bank_stride(P, P+2).
__host__ __device__ constexpr int map_floats(int P) {
    return (P + 2) * bank_stride(P, P + 2);
}

// Calls f(std::integral_constant<int, P>{}) with P = 2 * radius + 1 for a
// radius in 1..kLkMaxRadius, and with P = 0 (the run-time-P instantiation)
// for any other radius; returns what f returns.
template <int R = 1, class F>
int dispatch_patch(int radius, F&& f) {
    if constexpr (R > kLkMaxRadius) {
        return f(std::integral_constant<int, 0>{});
    } else {
        if (radius == R) return f(std::integral_constant<int, 2 * R + 1>{});
        return dispatch_patch<R + 1>(radius, f);
    }
}

}  // namespace sfm
