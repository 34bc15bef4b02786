// K1 shi_tomasi_score: min-eigenvalue corner response map of one image, or
// of each image of a stack.
//
// Replaces: sfm_tpu/ops/pallas/shi_tomasi_kernel.py shi_tomasi_score_pallas.
//
// out[y, x] = 0.5 * (tr - sqrt(max(tr^2 - 4 det, 0))) with tr = a + c,
// det = a c - b^2 and (a, b, c) the (2r+1)^2 box sums of gx^2, gx gy, gy^2,
// gx/gy central differences.  Border semantics are those of the plain
// PyTorch version (ops/image.gradients: zero gradient on the image's border
// pixels; box sum with zero padding), NOT the TPU kernel's wrap-around, so
// kernel and plain version agree on the whole map and not only inside.
//
// Bound: bytes.  One read of the image and one write of the map
// (2 x 1.2 MB at 640x480: 0.73 us of HBM time); the arithmetic is ~50
// flops a pixel at r = 3 (0.23 us at the float32 peak).  What held the
// first kernel back was latency and instruction issue, not either bound:
// one block per 32x16 tile (600 blocks of 512 threads, two waves at
// 640x480), four phases between three barriers with run-time tile widths
// and radius, ~45 shared-memory accesses per pixel.  Design:
//   - the radius is a template parameter (1..kMaxRadius): every loop below
//     has a compile-time trip count and unrolls;
//   - a block is four warps over a 64x20 output tile (240 blocks at
//     640x480, at most two an SM, all resident at once); lane l of every
//     warp owns output columns x0 + 2l and x0 + 2l + 1, and each warp
//     walks down kRows rows of them;
//   - the image tile with its halo (r+1 rows, r+1 columns rounded up to 4)
//     is staged in shared memory once, in 16-byte chunks where the image's
//     width and base allow (each chunk then lies wholly inside or outside
//     the image), at the dense row stride: every access below is a run of
//     consecutive words, so no stride has fewer bank conflicts;
//   - per image row the warp forms the three gradient products of the
//     row's 64 + 2r columns, branch-free (the column tests are made once),
//     into a small double-buffered row of shared memory (one __syncwarp a
//     row); each lane reads the 2r + 2 products its two columns need as
//     float2s and sums each column's 2r + 1;
//   - the last 2r+1 row sums of its columns stay in the lane's registers
//     (the row loop is unrolled, so the ring's indices are constants): the
//     column sums never pass through shared memory.
// Scene axis (the JAX package runs this kernel under jax.vmap over scenes,
// sfm_tpu/parallel/multi_scan.py): S stacked H x W images, blockIdx.z the
// image, at a stride of H * W floats in and out.  Each image's blocks do
// what they do for one image, so one launch over S images gives the bits
// of S launches.
//
// Summation order is the plain version's: products __fmul_rn, rows first,
// then columns, each centre, then -d, +d outward with __fadd_rn; the
// response with _rn operations.  Kernel and plain version agree bit for
// bit on the whole map.
// Measured (chip_smoke.py --only kernels; NVIDIA H100 80GB HBM3, 700 W):
// 0.00644 ms at 640x480, r = 3 (the first kernel: 0.0105 ms); a launch
// alone takes ~0.0021 ms there.  It issues ~2400 instructions a warp at
// r = 3 (of which 684 FADD fixed by the order above), so the SMs that hold
// two blocks issue for ~2.4 us (PERF.md, Findings).

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // warps per block, stacked down the tile
constexpr int kRows = 5;            // output rows each warp walks
constexpr int TW = 64;              // tile width: two output columns a lane
constexpr int TH = kWarps * kRows;  // tile height
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRadius = 8;       // shi_tomasi_kernel.MAX_RADIUS

// The staged tile of radius R: image rows y0-R-1 .. y0+TH+R and columns
// x0-A .. x0+TW+A-1, A = R+1 rounded up to a multiple of 4.
template <int R>
struct Tile {
    static constexpr int A = (R + 4) / 4 * 4;
    static constexpr int SW = TW + 2 * A;      // row stride (dense)
    static constexpr int SH = TH + 2 * R + 2;
    static constexpr int PW = TW + 2 * R;      // products per warp row
    static constexpr int kSlots = (PW + 31) / 32;  // product slots a lane
    static constexpr int kSteps = kRows + 2 * R;   // rows a warp sums
    static constexpr int kRing = 2 * R + 1;        // row sums a column keeps
};

// Stages image rows ys.. and columns xs.. of the tile into s (zeros
// outside the image: no product that counts reads them).  Every load is
// issued before the first store.
template <int R>
__device__ __forceinline__ void stage_tile(const float* __restrict__ img,
                                           int H, int W, int xs, int ys,
                                           float* __restrict__ s, int tid) {
    using G = Tile<R>;
    if ((W & 3) == 0 && ((uintptr_t)img & 15) == 0) {
        // W and xs multiples of 4: each 16-byte chunk is wholly inside or
        // wholly outside the image
        constexpr int C4 = G::SW / 4, N = G::SH * C4;
        constexpr int kSlots = (N + kThreads - 1) / kThreads;
        float4 v[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int i = tid + kThreads * k;
            const int r = i / C4, x = xs + 4 * (i - r * C4), y = ys + r;
            v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (i < N && y >= 0 && y < H && x >= 0 && x < W)
                v[k] = *reinterpret_cast<const float4*>(img + (size_t)y * W +
                                                        x);
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int i = tid + kThreads * k;
            if (i < N) reinterpret_cast<float4*>(s)[i] = v[k];
        }
    } else {
        constexpr int N = G::SH * G::SW;
        constexpr int kSlots = (N + kThreads - 1) / kThreads;
        float v[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int i = tid + kThreads * k;
            const int r = i / G::SW, x = xs + (i - r * G::SW), y = ys + r;
            v[k] = 0.f;
            if (i < N && y >= 0 && y < H && x >= 0 && x < W)
                v[k] = img[(size_t)y * W + x];
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
            const int i = tid + kThreads * k;
            if (i < N) s[i] = v[k];
        }
    }
}

// acc = x[R], then acc = (acc + x[R-d]) + x[R+d] for d = 1..R: the plain
// version's order of a (2R+1)-term box sum centred on x[R].
template <int R>
__device__ __forceinline__ float box_sum(const float* x) {
    float acc = x[R];
#pragma unroll
    for (int d = 1; d <= R; ++d)
        acc = __fadd_rn(__fadd_rn(acc, x[R - d]), x[R + d]);
    return acc;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    shi_tomasi_kernel(const float* __restrict__ img, int H, int W,
                      float* __restrict__ out) {
    using G = Tile<R>;
    __shared__ __align__(16) float simg[G::SH * G::SW];
    __shared__ __align__(16) float prod[kWarps][2][3][G::PW];

    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    img += (size_t)blockIdx.z * H * W;
    out += (size_t)blockIdx.z * H * W;
    stage_tile<R>(img, H, W, x0 - G::A, y0 - R - 1, simg, tid);

    // product slot k of this lane is column x0 - R + lane + 32 k: whether
    // it lies in the image, and whether it has a central difference in x
    bool in_x[G::kSlots], int_x[G::kSlots];
#pragma unroll
    for (int k = 0; k < G::kSlots; ++k) {
        const int cx = x0 - R + lane + 32 * k;
        in_x[k] = cx >= 0 && cx < W;
        int_x[k] = cx >= 1 && cx <= W - 2;
    }
    __syncthreads();

    const int yb = y0 + warp * kRows;  // the warp's first output row
    const int x = x0 + 2 * lane;       // the lane's output columns x, x+1
    float h[3][2][G::kRing];           // row sums at x, x+1; ring of steps
#pragma unroll
    for (int j = 0; j < G::kSteps; ++j) {
        const int y = yb - R + j;  // the image row this step sums
        const bool in_y = y >= 0 && y < H, int_y = y >= 1 && y <= H - 2;
        float(*P)[G::PW] = prod[warp][j & 1];
        // staged (y, x0 - R)
        const float* s = simg + (warp * kRows + j + 1) * G::SW + (G::A - R);
        // 1. gradient products of row y at columns x0 - R + m; zero
        //    outside the image, zero gradient on its border pixels
#pragma unroll
        for (int k = 0; k < G::kSlots; ++k) {
            const int m = lane + 32 * k;
            if (32 * (k + 1) <= G::PW || m < G::PW) {
                const float* c = s + m;
                const float gx =
                    in_y && int_x[k]
                        ? __fmul_rn(0.5f, __fsub_rn(c[1], c[-1])) : 0.f;
                const float gy =
                    int_y && in_x[k]
                        ? __fmul_rn(0.5f, __fsub_rn(c[G::SW], c[-G::SW]))
                        : 0.f;
                P[0][m] = __fmul_rn(gx, gx);
                P[1][m] = __fmul_rn(gx, gy);
                P[2][m] = __fmul_rn(gy, gy);
            }
        }
        // the other buffer was last read a step ago, before that step's
        // __syncwarp, so one barrier a step orders both
        __syncwarp();
        // 2. row sums of row y at columns x and x+1 (products 2 lane ..
        //    2 lane + 2R + 1, read as float2)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float2* p2 =
                reinterpret_cast<const float2*>(P[ch] + 2 * lane);
            float w[2 * R + 2];
#pragma unroll
            for (int i = 0; i <= R; ++i) {
                const float2 t = p2[i];
                w[2 * i] = t.x;
                w[2 * i + 1] = t.y;
            }
            h[ch][0][j % G::kRing] = box_sum<R>(w);
            h[ch][1][j % G::kRing] = box_sum<R>(w + 1);
        }
        // 3. once 2R+1 rows are summed: the column sums of output row
        //    y - R (its rows are steps j - 2R .. j) and the response
        if (j >= 2 * R) {
            const int yo = y - R;
            float e[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                float col[3][G::kRing];
#pragma unroll
                for (int ch = 0; ch < 3; ++ch)
#pragma unroll
                    for (int i = 0; i < G::kRing; ++i)
                        col[ch][i] = h[ch][q][(j - 2 * R + i) % G::kRing];
                const float a = box_sum<R>(col[0]), b = box_sum<R>(col[1]),
                            cc = box_sum<R>(col[2]);
                const float tr = __fadd_rn(a, cc);
                const float det =
                    __fsub_rn(__fmul_rn(a, cc), __fmul_rn(b, b));
                float disc =
                    __fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.0f, det));
                disc = __fsqrt_rn(fmaxf(disc, 0.0f));
                e[q] = __fmul_rn(0.5f, __fsub_rn(tr, disc));
            }
            if (yo < H) {
                float* o = out + (size_t)yo * W + x;
                if ((W & 1) == 0 && x + 1 < W) {  // 8-byte aligned
                    *reinterpret_cast<float2*>(o) = make_float2(e[0], e[1]);
                } else {
                    if (x < W) o[0] = e[0];
                    if (x + 1 < W) o[1] = e[1];
                }
            }
        }
    }
}

// Launches the instantiation of radius r (1..kMaxRadius).
template <int R = 1>
int launch(int r, const float* img, int S, int H, int W, float* out,
           cudaStream_t stream) {
    if constexpr (R > kMaxRadius) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (r != R) return launch<R + 1>(r, img, S, H, W, out, stream);
        dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, S);
        shi_tomasi_kernel<R><<<grid, kThreads, 0, stream>>>(img, H, W, out);
        return (int)cudaGetLastError();
    }
}

}  // namespace

// img/out: S stacked H x W images (S = 1: one image).
extern "C" int sfm_shi_tomasi(const void* img, int S, int H, int W, int r,
                              void* out, void* stream) {
    if (S <= 0 || H <= 0 || W <= 0) return 0;
    if (S > 65535) return (int)cudaErrorInvalidValue;  // grid.z
    return launch(r, (const float*)img, S, H, W, (float*)out,
                  (cudaStream_t)stream);
}
