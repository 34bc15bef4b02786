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
// the same un-clamped fraction, the same _rn arithmetic, one bilinear map
// per update, the patch size a template parameter (radius 1..10, other
// sizes at run time).
//
// Storage (SFM_TPU_LK_BF16): the windows are float32 or bfloat16, a
// template parameter; the template is float32 either way, as in the JAX
// package's lk_iter_pallas.  bfloat16 windows become float32 as they are
// staged into shared memory (exact), so the loop is the float32 kernel's.
//
// Scene axis: the tracks of S scenes are independent, so a stack of scenes
// is the wrapper's flattened (S * T) table and needs nothing here.
//
// Bound: bytes.  The function's inputs are the windows and templates
// themselves, T * (WIN^2 + P^2) * 4 B (8.4 MB at T=2200, WIN=28, P=13), plus
// 24 B per track; its operations are K3's without the template map (one
// (P+2)^2 bilinear map and ~15 flops per patch pixel per iteration, about
// 1.45e8 float32 operations at 16 iterations).  At the card's peak rates the
// bytes weigh slightly more; both are a few microseconds.  What the kernel
// waits for is, as in K3, the chain of `iters` dependent updates.  Design:
// one warp per track, the window copied once into shared memory with
// 16-byte loads (a track's window is contiguous and, WIN being even,
// 16-byte aligned) at the row stride that keeps the map's loads free of
// bank conflicts (sfm::bank_stride), the template beside it, one map
// buffer, sfm::kLkTracksPerBlock tracks per block.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): 0.0270 ms at
// T=2200, P=13, 16 iterations, the same at every pyramid level (0.0489
// ms with five bilinear reads per patch pixel); PERF.md, Findings.

#include <stdint.h>

#include "lk_common.cuh"
#include "lk_iterate.cuh"

namespace {

constexpr int kTracksPerBlock = sfm::kLkTracksPerBlock;

// Shared floats per track: the window, the update's map, the template.
__host__ __device__ inline int tmpl_floats_per_track(int P, int WIN) {
    return WIN * sfm::bank_stride(P + 2, WIN) + sfm::map_floats(P) + P * P;
}

template <int kP, class Blk>
__global__ void lk_level_tmpl_kernel(const Blk* __restrict__ blocks,
                                     const float* __restrict__ tmpl_in,
                                     const float* __restrict__ base,
                                     const float* __restrict__ v_in, int T,
                                     int p, int WIN, int iters, float min_det,
                                     float* __restrict__ v_out) {
    extern __shared__ float smem[];
    const int P = kP > 0 ? kP : p;
    const int WINS = sfm::bank_stride(P + 2, WIN);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * kTracksPerBlock + warp;
    if (t >= T) return;  // whole warp leaves together

    float* B1 = smem + warp * tmpl_floats_per_track(P, WIN);
    float* M = B1 + WIN * WINS;
    float* tmpl = M + sfm::map_floats(P);
    const Blk* src = blocks + (size_t)t * WIN * WIN;
    if ((WIN & 1) == 0 && ((uintptr_t)blocks & (4 * sizeof(Blk) - 1)) == 0) {
        // WIN even: WIN^2 is a multiple of 4, every window's start aligned
        // for one load of 4 values (16 B of float32, 8 B of bfloat16)
        for (int q = lane; q < WIN * WIN / 4; q += 32) {
            float e[4];
            sfm::load4(src + 4 * q, e);
            int r = 4 * q / WIN, c = 4 * q - r * WIN;
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // the 4 values may end a row
                B1[r * WINS + c] = e[k];
                if (++c == WIN) { c = 0; ++r; }
            }
        }
    } else {
        for (int i = lane; i < WIN * WIN; i += 32)
            B1[(i / WIN) * WINS + i % WIN] = sfm::to_float(src[i]);
    }
    const float* tsrc = tmpl_in + (size_t)t * P * P;
    for (int i = lane; i < P * P; i += 32) tmpl[i] = tsrc[i];
    __syncwarp();

    float vx = v_in[2 * t], vy = v_in[2 * t + 1];
    sfm::lk_iterate<kP>(B1, WIN, WINS, M, tmpl, P, base[2 * t],
                        base[2 * t + 1], iters, min_det, lane, vx, vy);

    if (lane == 0) {
        v_out[2 * t] = vx;
        v_out[2 * t + 1] = vy;
    }
}

template <int kP, class Blk>
int launch(const Blk* blocks, const float* tmpl, const float* base,
           const float* v_in, int T, int P, int WIN, int iters,
           float min_det, float* v_out, cudaStream_t stream) {
    const size_t bytes = (size_t)kTracksPerBlock *
                         tmpl_floats_per_track(P, WIN) * sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            lk_level_tmpl_kernel<kP, Blk>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int nblocks = (T + kTracksPerBlock - 1) / kTracksPerBlock;
    lk_level_tmpl_kernel<kP, Blk><<<nblocks, 32 * kTracksPerBlock, bytes,
                                    stream>>>(blocks, tmpl, base, v_in, T, P,
                                              WIN, iters, min_det, v_out);
    return (int)cudaGetLastError();
}

}  // namespace

// blocks: T windows, float32 (bf16 = 0) or bfloat16 (bf16 = 1); tmpl,
// base, v_in, v_out float32.
extern "C" int sfm_lk_level_tmpl(const void* blocks, const void* tmpl,
                                 const void* base, const void* v_in, int T,
                                 int P, int WIN, int iters, float min_det,
                                 void* v_out, int bf16, void* stream) {
    if (T <= 0) return 0;
    return sfm::dispatch_storage(bf16, [&](auto* blk_type) {
        using Blk = std::remove_pointer_t<decltype(blk_type)>;
        // an even P has no radius: the run-time-P instantiation takes it
        return sfm::dispatch_patch((P & 1) ? (P - 1) / 2 : 0, [&](auto kp) {
            return launch<decltype(kp)::value, Blk>(
                (const Blk*)blocks, (const float*)tmpl, (const float*)base,
                (const float*)v_in, T, P, WIN, iters, min_det, (float*)v_out,
                (cudaStream_t)stream);
        });
    });
}
