// K2 lk_gather_pair and K5 lk_gather: per-track windows of two images, or of
// one.
//
// Replaces: sfm_tpu/ops/pallas/block_gather_kernel.py
//   load_blocks_pair_pallas (K2) and load_blocks_pallas (K5, the one-image
//   mode: the template and search windows of the template-passed-in LK arm
//   and of the SFM_TPU_LK_FUSED=0 arm of sfm_tpu/ops/klt.py _lk_level).
//
// For every track t: out0[t] = img0[sy0:sy0+win0, sx0:sx0+win0] and, in the
// pair mode, out1[t] = img1[sy1:sy1+win1, sx1:sx1+win1], starts clamped
// in-kernel (sfm::clamp_start, INT_MIN/INT_MAX included).  The TPU kernels
// return blocks that are 8 or 16 rows taller, anchored at an aligned row
// below the request, because Mosaic cannot slice a VMEM tile at a
// per-track row; a CUDA thread simply computes its own address, so the
// output is exactly the requested window and the only anchor is the
// clamped start.
//
// Bound: bytes.  The image(s) read once and T * win^2 * 4 B written per
// image (6.9 MB for one image at T=2200, win 28: 2.06 us at 3.35 TB/s;
// neighbouring windows overlap, so the image's bytes come mostly from L2);
// no arithmetic.  What held the first kernel back: one block of 128
// threads per track (2200 blocks against 2112 resident at 16 a SM, so a
// tail wave), and a copy loop with a run-time division by the width and
// one 4-byte load in flight per thread per trip.  Design:
//   - one warp per track, 1 (K5) or 2 (K2) tracks a block: at T=2200,
//     2200 or 1100 blocks, all resident at once (32 blocks an SM);
//   - the width a template parameter for every width the port gathers
//     (P+3 and P+2*MARGIN+3 for radius 1..sfm::kLkMaxRadius: the even
//     widths 6..36); any other width, or an output that is not 16-byte
//     aligned, runs the run-time-width instantiation;
//   - a lane owns float4 chunks of the window's win^2 contiguous output
//     floats (an even width makes win^2 a multiple of 4) and issues the
//     loads of all its chunks before its first store; the stores are
//     16 bytes a lane, consecutive lanes on consecutive chunks.
// Storage (SFM_TPU_LK_BF16): float32 or bfloat16 images, a template
// parameter; a window is a copy, so bfloat16 windows are bfloat16 (4 values
// make an 8-byte chunk, and an even width keeps win^2 whole chunks).
// Scene axis (K5; the JAX package runs load_blocks_pallas under jax.vmap
// over scenes, sfm_tpu/parallel/multi_scan.py): the images may be S stacked
// H x W images and the tracks S stacked tables of T_scene tracks each,
// flattened to T = S * T_scene; track t reads scene t / T_scene and is
// clamped against that scene's image, as in K3's launch.
// K3 gathers its windows itself (sfm::load_window_async, lk_common.cuh)
// and does not call this kernel.
// Measured (chip_smoke.py --only kernels; NVIDIA H100 80GB HBM3, 700 W):
// K5 0.00463 ms at T=2200, win 28 (the first kernel: 0.0066 ms; one
// PyTorch call, unfold(...)[sy, sx], 0.0122 ms; a 6.9 MB fill_ 0.0035
// ms), K2 0.00529 ms at win 16 + 28 (first kernel: 0.0085 ms); PERF.md,
// Findings.

#include <stdint.h>

#include <type_traits>

#include "lk_common.cuh"
#include "lk_iterate.cuh"

namespace {

// Tracks (warps) a block: one-image windows 1, pairs 2 (on an H100 each
// beat 1, 2 and 4 by 3-28 %; PERF.md, Findings).
__host__ __device__ constexpr int tracks_per_block(bool pair) {
    return pair ? 2 : 1;
}
constexpr int kMargin = 6;  // lk_kernels.MARGIN: search width P + 2*kMargin + 3
constexpr int kMinWin = 2 * 1 + 1 + 3;
constexpr int kMaxWin = 2 * sfm::kLkMaxRadius + 1 + 2 * kMargin + 3;

// Four stored values as one store: 16 bytes of float32, 8 of bfloat16.
template <class Px>
struct Quad;
template <>
struct Quad<float> {
    using type = float4;
    static __device__ __forceinline__ type make(const float e[4]) {
        return make_float4(e[0], e[1], e[2], e[3]);
    }
};
template <>
struct Quad<__nv_bfloat16> {
    using type = uint2;
    static __device__ __forceinline__ type make(const __nv_bfloat16 e[4]) {
        return make_uint2(
            __bfloat16_as_ushort(e[0]) |
                ((unsigned)__bfloat16_as_ushort(e[1]) << 16),
            __bfloat16_as_ushort(e[2]) |
                ((unsigned)__bfloat16_as_ushort(e[3]) << 16));
    }
};

// One warp copies the win x win window of img at the start (sx, sy),
// clamped here, to the win^2 contiguous pixels at dst.  kWin > 0 (even):
// win = kWin at compile time and dst aligned for Quad stores; kWin = 0:
// win at run time.
template <int kWin, class Px>
__device__ __forceinline__ void gather_window(const Px* __restrict__ img,
                                              int H, int W, int sx, int sy,
                                              int win,
                                              Px* __restrict__ dst,
                                              int lane) {
    sx = sfm::clamp_start(sx, W, win);
    sy = sfm::clamp_start(sy, H, win);
    const Px* src = img + (size_t)sy * W + sx;
    if constexpr (kWin > 0) {
        static_assert(kWin % 2 == 0, "win^2 must be whole chunks of 4");
        constexpr int n4 = kWin * kWin / 4;
        constexpr int kSlots = (n4 + 31) / 32;
        typename Quad<Px>::type v[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int q = lane + 32 * k;
            if (q < n4) {
                // chunk q is window row r, columns c .. c+3; where the
                // width is not a multiple of 4, its last two may be
                // columns 0, 1 of row r+1
                const int r = 4 * q / kWin, c = 4 * q - r * kWin;
                const Px* a = src + (size_t)r * W + c;
                Px e[4];
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    e[u] = kWin % 4 == 0 || c + u < kWin ? a[u]
                                                         : a[u + W - kWin];
                v[k] = Quad<Px>::make(e);
            }
        }
        auto* d4 = reinterpret_cast<typename Quad<Px>::type*>(dst);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int q = lane + 32 * k;
            if (q < n4) d4[q] = v[k];
        }
    } else {
        for (int i = lane; i < win * win; i += 32)
            dst[i] = src[(size_t)(i / win) * W + i % win];
    }
}

template <bool kPair, int kWin0, int kWin1, class Px>
__global__ void __launch_bounds__(32 * tracks_per_block(kPair))
    lk_gather_kernel(const Px* __restrict__ img0,
                     const Px* __restrict__ img1, int H, int W,
                     const int* __restrict__ starts0,
                     const int* __restrict__ starts1, int T, int T_scene,
                     int win0, int win1, Px* __restrict__ out0,
                     Px* __restrict__ out1) {
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * tracks_per_block(kPair) + (threadIdx.x >> 5);
    if (t >= T) return;  // whole warp leaves together
    const size_t scene_off = (size_t)(t / T_scene) * H * W;
    gather_window<kWin0>(img0 + scene_off, H, W, starts0[2 * t],
                         starts0[2 * t + 1], win0,
                         out0 + (size_t)t * win0 * win0, lane);
    if constexpr (kPair)
        gather_window<kWin1>(img1 + scene_off, H, W, starts1[2 * t],
                             starts1[2 * t + 1], win1,
                             out1 + (size_t)t * win1 * win1, lane);
}

template <bool kPair, int kWin0, int kWin1, class Px>
int launch(const Px* img0, const Px* img1, int H, int W, const int* starts0,
           const int* starts1, int T, int T_scene, int win0, int win1,
           Px* out0, Px* out1, cudaStream_t stream) {
    constexpr int kTracks = tracks_per_block(kPair);
    lk_gather_kernel<kPair, kWin0, kWin1, Px>
        <<<(T + kTracks - 1) / kTracks, 32 * kTracks, 0, stream>>>(
            img0, img1, H, W, starts0, starts1, T, T_scene, win0, win1, out0,
            out1);
    return (int)cudaGetLastError();
}

// p aligned for the Quad<Px> stores
template <class Px>
bool aligned_quad(const void* p) {
    return ((uintptr_t)p & (4 * sizeof(Px) - 1)) == 0;
}

// Calls f(std::integral_constant<int, kW>{}) with kW = win for an even win
// in [kMinWin, kMaxWin], and with kW = 0 for any other win.
template <int kW = kMinWin, class F>
int dispatch_width(int win, F&& f) {
    if constexpr (kW > kMaxWin) {
        return f(std::integral_constant<int, 0>{});
    } else {
        if (win == kW) return f(std::integral_constant<int, kW>{});
        return dispatch_width<kW + 2>(win, f);
    }
}

}  // namespace

// img0/img1: H x W images, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// out0/out1 of the same type.
extern "C" int sfm_lk_gather_pair(const void* img0, const void* img1, int H,
                                  int W, const void* starts0,
                                  const void* starts1, int T, int win0,
                                  int win1, void* out0, void* out1, int bf16,
                                  void* stream) {
    if (T <= 0) return 0;
    return sfm::dispatch_storage(bf16, [&](auto* px_type) {
        using Px = std::remove_pointer_t<decltype(px_type)>;
        auto go = [&](auto kw0, auto kw1) {
            return launch<true, decltype(kw0)::value, decltype(kw1)::value>(
                (const Px*)img0, (const Px*)img1, H, W, (const int*)starts0,
                (const int*)starts1, T, T, win0, win1, (Px*)out0, (Px*)out1,
                (cudaStream_t)stream);
        };
        using Zero = std::integral_constant<int, 0>;
        // the LK pair: template width P+3, search width P+2*kMargin+3
        if (win1 != win0 + 2 * kMargin || !aligned_quad<Px>(out0) ||
            !aligned_quad<Px>(out1))
            return go(Zero{}, Zero{});
        return sfm::dispatch_patch((win0 - 3) / 2, [&](auto kp) {
            constexpr int P = decltype(kp)::value;
            if constexpr (P == 0) {
                return go(Zero{}, Zero{});
            } else {
                if (win0 != P + 3) return go(Zero{}, Zero{});
                return go(std::integral_constant<int, P + 3>{},
                          std::integral_constant<int, P + 2 * kMargin + 3>{});
            }
        });
    });
}

// img: S stacked H x W images, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// starts/out: T = S * T_scene tracks, scene by scene; out of img's type.
extern "C" int sfm_lk_gather(const void* img, int H, int W,
                             const void* starts, int T, int T_scene, int win,
                             void* out, int bf16, void* stream) {
    if (T <= 0) return 0;
    if (T_scene <= 0 || T % T_scene != 0) return (int)cudaErrorInvalidValue;
    return sfm::dispatch_storage(bf16, [&](auto* px_type) {
        using Px = std::remove_pointer_t<decltype(px_type)>;
        return dispatch_width(aligned_quad<Px>(out) ? win : 0, [&](auto kw) {
            return launch<false, decltype(kw)::value, 0>(
                (const Px*)img, (const Px*)nullptr, H, W, (const int*)starts,
                nullptr, T, T_scene, win, 0, (Px*)out, (Px*)nullptr,
                (cudaStream_t)stream);
        });
    });
}
