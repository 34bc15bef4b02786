// K3 lk_level_fused: all LK iterations of one pyramid level, for all tracks.
//
// Replaces: sfm_tpu/ops/pallas/block_gather_kernel.py load_blocks_pair_pallas
//   together with sfm_tpu/ops/pallas/lk_iter_kernel.py lk_iter_tmpl_pallas
//   (the pair gather + the VMEM-resident iteration loop with in-kernel
//   template), i.e. the fused branch of sfm_tpu/ops/klt.py _lk_level.
//
// Per track: gather the (P+3)^2 template window of img0 and the
// (P+2*margin+3)^2 search window of img1 into shared memory, build the P x P
// bilinear template once, then run `iters` Lucas-Kanade updates out of shared
// memory and write the final flow.  Device memory sees the two windows read
// once and 8 bytes written per track; nothing else leaves the SM.
//
// Geometry (what an earlier port of this loop got wrong, and what the test on
// the card holds hardest):
//   o0 = p0 - radius                      template origin
//   start0 = clip(floor(nan_to_num(o0)) - 1, 0, [W-WIN0, H-WIN0])
//   o1 = (p0 + v_in) - radius             search origin
//   start1 = clip(floor(nan_to_num(o1)) - (margin+1), 0, [W-WIN, H-WIN])
//   f0 = (o0 - start0) - 1                template fraction; the template
//                                         sub-window is rows/cols [0, P+3)
//   base = o0 - start1
//   each iteration: q = base + v; qi = clip(floor(q), 1, WIN-P-2);
//   f = q - qi is NOT clamped (it extrapolates when the clip bites);
//   sub-window origin = qi - 1 relative to start1 - the clamp bounds are
//   relative to the clamped window start and to nothing else.
//
// Arithmetic follows the plain PyTorch version operation for operation
// (__fmul_rn/__fadd_rn keep the compiler from contracting a*b+c into an fma,
// which rounds once instead of twice); only the order of the P*P sums
// differs (per-lane partial sums, then a warp butterfly).
//
// Bound: operations, nominally.  The function's inputs are the two level
// images (2*H*W*4 B, 2.5 MB at 640x480) and 24 B per track; what it must
// compute per track and iteration is one bilinear map of (P+2)^2 px (cur and
// the four gradient neighbours are that map at shifted pixels) at ~7 flops
// and ~15 flops per patch pixel for differences, residual, products and
// sums: at T=2200, P=13, 16 iterations about 1.5e8 float32 operations, which
// outweigh the bytes at the card's peak rates.  Both are a few microseconds,
// far below a launch's latency.  This kernel does not reach that count: it
// evaluates the five bilinear reads of a pixel separately (about three times
// the operations) to repeat the plain version's arithmetic bit for bit.  What
// it actually waits for is the chain of `iters` dependent updates, each a
// pass over P^2 pixels plus five warp reductions.  Design for that: one warp
// per track (no block barrier in the loop, only __syncwarp), windows in
// shared memory so every iteration's 12 reads per pixel are shared-memory
// reads, four tracks per block so 550 blocks spread over the SMs.

#include "lk_common.cuh"

namespace {

constexpr int kTracksPerBlock = 4;

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

__global__ void lk_level_fused_kernel(const float* __restrict__ img0,
                                      const float* __restrict__ img1, int H,
                                      int W, const float* __restrict__ p0,
                                      const float* __restrict__ v_in, int T,
                                      int radius, int margin, int iters,
                                      float min_det,
                                      float* __restrict__ v_out) {
    extern __shared__ float smem[];
    const int P = 2 * radius + 1;
    const int WIN0 = P + 3;
    const int WIN = P + 2 * margin + 3;
    const int per_track = WIN * WIN + WIN0 * WIN0 + P * P;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * kTracksPerBlock + warp;
    if (t >= T) return;  // whole warp leaves together

    float* B1 = smem + warp * per_track;
    float* B0 = B1 + WIN * WIN;
    float* tmpl = B0 + WIN0 * WIN0;

    const float px = p0[2 * t], py = p0[2 * t + 1];
    float vx = v_in[2 * t], vy = v_in[2 * t + 1];
    const float r = (float)radius;

    const float o0x = __fsub_rn(px, r), o0y = __fsub_rn(py, r);
    const float s0x = sfm::window_start(o0x, 1, W, WIN0);
    const float s0y = sfm::window_start(o0y, 1, H, WIN0);
    const float o1x = __fsub_rn(__fadd_rn(px, vx), r);
    const float o1y = __fsub_rn(__fadd_rn(py, vy), r);
    const float s1x = sfm::window_start(o1x, margin + 1, W, WIN);
    const float s1y = sfm::window_start(o1y, margin + 1, H, WIN);

    sfm::load_window(img0, H, W, (int)s0x, (int)s0y, WIN0, B0, WIN0, lane, 32);
    sfm::load_window(img1, H, W, (int)s1x, (int)s1y, WIN, B1, WIN, lane, 32);
    __syncwarp();

    // template: bilinear read of the fixed sub-window [0, P+3) at (1, 1)
    const float f0x = __fsub_rn(__fsub_rn(o0x, s0x), 1.0f);
    const float f0y = __fsub_rn(__fsub_rn(o0y, s0y), 1.0f);
    {
        const float g0x = __fsub_rn(1.0f, f0x), g0y = __fsub_rn(1.0f, f0y);
        for (int i = lane; i < P * P; i += 32) {
            int y = i / P, x = i - y * P;
            tmpl[i] = bilinear(B0, WIN0, 1 + y, 1 + x, f0x, f0y, g0x, g0y);
        }
    }
    __syncwarp();

    const float basex = __fsub_rn(o0x, s1x), basey = __fsub_rn(o0y, s1y);
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

    if (lane == 0) {
        v_out[2 * t] = vx;
        v_out[2 * t + 1] = vy;
    }
}

}  // namespace

extern "C" int sfm_lk_level_fused(const void* img0, const void* img1, int H,
                                  int W, const void* p0, const void* v_in,
                                  int T, int radius, int margin, int iters,
                                  float min_det, void* v_out, void* stream) {
    if (T <= 0) return 0;
    const int P = 2 * radius + 1;
    const int WIN0 = P + 3;
    const int WIN = P + 2 * margin + 3;
    const size_t bytes = (size_t)kTracksPerBlock *
                         (WIN * WIN + WIN0 * WIN0 + P * P) * sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            lk_level_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (T + kTracksPerBlock - 1) / kTracksPerBlock;
    lk_level_fused_kernel<<<blocks, 32 * kTracksPerBlock, bytes,
                            (cudaStream_t)stream>>>(
        (const float*)img0, (const float*)img1, H, W, (const float*)p0,
        (const float*)v_in, T, radius, margin, iters, min_det,
        (float*)v_out);
    return (int)cudaGetLastError();
}
