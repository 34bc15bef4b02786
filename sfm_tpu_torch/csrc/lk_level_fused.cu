// K3 lk_level_fused: all LK iterations of one pyramid level, for all tracks
// of one scene or of a stack of scenes.
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
// The iteration loop is sfm::lk_iterate (lk_iterate.cuh), which the
// template-passed-in kernel K4 (lk_level_tmpl.cu) runs too.
//
// Scene axis (the JAX package runs this kernel under jax.vmap over scenes,
// sfm_tpu/parallel/multi_scan.py): img0/img1 may be S stacked H x W images
// and the tracks S stacked tables of T_scene tracks each, flattened to
// T = S * T_scene.  Track t belongs to scene t / T_scene and reads that
// scene's images; nothing else changes, so one launch over S scenes gives,
// track for track, the bits of S launches over one scene.  A single image
// pair is the case S = 1 (T_scene = T).
//
// Storage (SFM_TPU_LK_BF16; the JAX package's _lk_dtype): the images are
// float32 or bfloat16, a template parameter of the kernel.  bfloat16 pixels
// become float32 as they are staged into shared memory
// (sfm::load_window_async's bfloat16 twin), exactly, so everything after
// the staging is the float32 kernel's: on bfloat16 images the kernel gives
// the bits of the float32 kernel on the same images rounded to bfloat16.
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
// far below a launch's latency.  What the kernel waits for is the chain of
// `iters` dependent updates, each a pass over the map and the patch plus
// five warp reductions.  Design for that:
//   - one warp per track, no block barrier in the loop (only __syncwarp),
//     windows in shared memory, gathered with cp.async (all of a track's
//     loads in flight at once);
//   - one bilinear map per update, written to shared memory and read at
//     five offsets: 4 loads and 11 flops per map pixel, 6 loads per patch
//     pixel, instead of 20 loads and ~55 flops per patch pixel; a lane
//     issues all its map loads before its first map store;
//   - the patch size a template parameter (radius 1..10; other radii take
//     the run-time-P instantiation), so the lane loops unroll - 8 map and 6
//     patch pixels per lane at P = 13 - and their loads overlap;
//   - row strides chosen so that a warp's loads hit 32 distinct banks
//     (sfm::bank_stride: 47 for the search window, 45 for the map at
//     P = 13);
//   - sfm::kLkTracksPerBlock tracks per block (2: 1100 blocks at T=2200
//     spread more evenly over 132 SMs than 4 or 8 per block).
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): 0.0294 ms at
// T=2200, P=13, 16 iterations, the same at every pyramid level (0.0472
// ms with five bilinear reads per patch pixel); PERF.md, Findings.

#include "lk_common.cuh"
#include "lk_iterate.cuh"

namespace {

constexpr int kTracksPerBlock = sfm::kLkTracksPerBlock;

// Shared floats per track: the search window, the template window, the
// update's map, the template.
__host__ __device__ inline int fused_floats_per_track(int P, int margin) {
    const int WIN0 = P + 3, WIN = P + 2 * margin + 3;
    return WIN * sfm::bank_stride(P + 2, WIN) + WIN0 * WIN0 +
           sfm::map_floats(P) + P * P;
}

template <int kP, class Img>
__global__ void lk_level_fused_kernel(const Img* __restrict__ img0,
                                      const Img* __restrict__ img1, int H,
                                      int W, const float* __restrict__ p0,
                                      const float* __restrict__ v_in, int T,
                                      int T_scene, int radius, int margin,
                                      int iters,
                                      float min_det,
                                      float* __restrict__ v_out) {
    extern __shared__ float smem[];
    const int P = kP > 0 ? kP : 2 * radius + 1;
    const int WIN0 = P + 3;
    const int WIN = P + 2 * margin + 3;
    const int WINS = sfm::bank_stride(P + 2, WIN);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * kTracksPerBlock + warp;
    if (t >= T) return;  // whole warp leaves together
    const size_t scene_off = (size_t)(t / T_scene) * H * W;
    img0 += scene_off;
    img1 += scene_off;

    float* B1 = smem + warp * fused_floats_per_track(P, margin);
    float* B0 = B1 + WIN * WINS;
    float* M = B0 + WIN0 * WIN0;
    float* tmpl = M + sfm::map_floats(P);

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

    sfm::load_window_async(img0, H, W, (int)s0x, (int)s0y, WIN0, B0, WIN0,
                           lane);
    sfm::load_window_async(img1, H, W, (int)s1x, (int)s1y, WIN, B1, WINS,
                           lane);
    sfm::copy_wait();

    // template: the P x P bilinear map of the fixed sub-window [0, P+3) at
    // (1, 1)
    const float f0x = __fsub_rn(__fsub_rn(o0x, s0x), 1.0f);
    const float f0y = __fsub_rn(__fsub_rn(o0y, s0y), 1.0f);
    sfm::bilinear_map<kP>(B0, WIN0, 1, 1, f0x, f0y, __fsub_rn(1.0f, f0x),
                          __fsub_rn(1.0f, f0y), tmpl, P, P, lane);
    __syncwarp();

    const float basex = __fsub_rn(o0x, s1x), basey = __fsub_rn(o0y, s1y);
    sfm::lk_iterate<kP>(B1, WIN, WINS, M, tmpl, P, basex, basey, iters,
                        min_det, lane, vx, vy);

    if (lane == 0) {
        v_out[2 * t] = vx;
        v_out[2 * t + 1] = vy;
    }
}

template <int kP, class Img>
int launch(const Img* img0, const Img* img1, int H, int W,
           const float* p0, const float* v_in, int T, int T_scene, int radius,
           int margin, int iters, float min_det, float* v_out,
           cudaStream_t stream) {
    const int P = 2 * radius + 1;
    const size_t bytes = (size_t)kTracksPerBlock *
                         fused_floats_per_track(P, margin) * sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            lk_level_fused_kernel<kP, Img>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (T + kTracksPerBlock - 1) / kTracksPerBlock;
    lk_level_fused_kernel<kP, Img><<<blocks, 32 * kTracksPerBlock, bytes,
                                   stream>>>(img0, img1, H, W, p0, v_in, T,
                                             T_scene, radius, margin, iters,
                                             min_det, v_out);
    return (int)cudaGetLastError();
}

}  // namespace

// img0/img1: S stacked H x W images, float32 (bf16 = 0) or bfloat16
// (bf16 = 1); p0/v_in/v_out: T = S * T_scene float32 tracks, scene by scene.
extern "C" int sfm_lk_level_fused(const void* img0, const void* img1, int H,
                                  int W, const void* p0, const void* v_in,
                                  int T, int T_scene, int radius, int margin,
                                  int iters, float min_det, void* v_out,
                                  int bf16, void* stream) {
    if (T <= 0) return 0;
    if (T_scene <= 0 || T % T_scene != 0) return (int)cudaErrorInvalidValue;
    return sfm::dispatch_storage(bf16, [&](auto* img_type) {
        using Img = std::remove_pointer_t<decltype(img_type)>;
        return sfm::dispatch_patch(radius, [&](auto kp) {
            return launch<decltype(kp)::value, Img>(
                (const Img*)img0, (const Img*)img1, H, W, (const float*)p0,
                (const float*)v_in, T, T_scene, radius, margin, iters,
                min_det, (float*)v_out, (cudaStream_t)stream);
        });
    });
}
