// K4 lk_level_tmpl: all LK iterations of one pyramid level, for all tracks,
// with the template built outside and passed in.
//
// Replaces: sfm_tpu/ops/pallas/lk_iter_kernel.py lk_iter_pallas (the
//   VMEM-resident iteration loop fed by load_blocks_pallas and a prebuilt
//   template), i.e. the branch of sfm_tpu/ops/klt.py _lk_level taken when
//   the two images differ in shape or SFM_TPU_LK_FUSED_TMPL=0.
//
// Inputs per track: the (WIN, WIN) search window of img1 (gathered by K5,
// lk_gather_pair.cu, at the clamped start), the P x P template, base =
// (p0 - radius) - start, and the incoming flow.  The TPU kernel takes blocks
// 8 or 16 rows taller, anchored at an aligned row, and a per-track row
// remainder d that its shift ladder composes away; here the window is
// exactly the requested one, so d is 0 by construction and there is no
// ladder.  The loop is sfm::lk_iterate (lk_iterate.cuh), the one K3 runs:
// the same clamp of the sub-window origin relative to the window's start,
// the same un-clamped fraction, the same _rn arithmetic.
//
// Bound: bytes.  The function's inputs are the windows and templates
// themselves, T * (WIN^2 + P^2) * 4 B (8.4 MB at T=2200, WIN=28, P=13), plus
// 24 B per track; its operations are K3's without the template map (one
// (P+2)^2 bilinear map and ~15 flops per patch pixel per iteration, about
// 1.45e8 float32 operations at 16 iterations).  At the card's peak rates the
// bytes weigh slightly more; both are a few microseconds.  What the kernel
// waits for is, as in K3, the chain of `iters` dependent updates.  Design:
// one warp per track, window and template copied once into shared memory
// (coalesced: a track's window is contiguous), four tracks per block.

#include "lk_iterate.cuh"

namespace {

constexpr int kTracksPerBlock = 4;

__global__ void lk_level_tmpl_kernel(const float* __restrict__ blocks,
                                     const float* __restrict__ tmpl_in,
                                     const float* __restrict__ base,
                                     const float* __restrict__ v_in, int T,
                                     int P, int WIN, int iters, float min_det,
                                     float* __restrict__ v_out) {
    extern __shared__ float smem[];
    const int per_track = WIN * WIN + P * P;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * kTracksPerBlock + warp;
    if (t >= T) return;  // whole warp leaves together

    float* B1 = smem + warp * per_track;
    float* tmpl = B1 + WIN * WIN;
    const float* src = blocks + (size_t)t * WIN * WIN;
    for (int i = lane; i < WIN * WIN; i += 32) B1[i] = src[i];
    const float* tsrc = tmpl_in + (size_t)t * P * P;
    for (int i = lane; i < P * P; i += 32) tmpl[i] = tsrc[i];
    __syncwarp();

    float vx = v_in[2 * t], vy = v_in[2 * t + 1];
    sfm::lk_iterate(B1, WIN, tmpl, P, base[2 * t], base[2 * t + 1], iters,
                    min_det, lane, vx, vy);

    if (lane == 0) {
        v_out[2 * t] = vx;
        v_out[2 * t + 1] = vy;
    }
}

}  // namespace

extern "C" int sfm_lk_level_tmpl(const void* blocks, const void* tmpl,
                                 const void* base, const void* v_in, int T,
                                 int P, int WIN, int iters, float min_det,
                                 void* v_out, void* stream) {
    if (T <= 0) return 0;
    const size_t bytes =
        (size_t)kTracksPerBlock * (WIN * WIN + P * P) * sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            lk_level_tmpl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int nblocks = (T + kTracksPerBlock - 1) / kTracksPerBlock;
    lk_level_tmpl_kernel<<<nblocks, 32 * kTracksPerBlock, bytes,
                           (cudaStream_t)stream>>>(
        (const float*)blocks, (const float*)tmpl, (const float*)base,
        (const float*)v_in, T, P, WIN, iters, min_det, (float*)v_out);
    return (int)cudaGetLastError();
}
