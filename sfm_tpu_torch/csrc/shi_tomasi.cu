// K1 shi_tomasi_score: min-eigenvalue corner response map of one image.
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
// (2 x 1.2 MB at 640x480: under a microsecond of HBM time); the arithmetic
// is ~40 flops a pixel.  The plain version makes some fifteen passes over
// device memory.  Design: one block per 32x16 output tile; the tile with a
// halo of r+1 goes to shared memory once, the three products are formed on
// the r-haloed tile, box-summed separably (rows, then columns) in shared
// memory, and only the response is written.  The summation order of the box
// sums is the plain version's (centre, then -d, +d outward), so the two
// differ only where the compiler may not reorder: nowhere; products and sums
// use the _rn intrinsics to rule out fma contraction.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;
constexpr int TH = 16;

__global__ void shi_tomasi_kernel(const float* __restrict__ img, int H, int W,
                                  int r, float* __restrict__ out) {
    extern __shared__ float smem[];
    const int IW = TW + 2 * r + 2, IH = TH + 2 * r + 2;  // image tile
    const int PW = TW + 2 * r, PH = TH + 2 * r;          // product tile
    float* simg = smem;                // IH x IW
    float* pxx = simg + IH * IW;       // PH x PW
    float* pxy = pxx + PH * PW;
    float* pyy = pxy + PH * PW;
    float* hxx = pyy + PH * PW;        // PH x TW  (row sums)
    float* hxy = hxx + PH * TW;
    float* hyy = hxy + PH * TW;

    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nth = blockDim.x * blockDim.y;

    // 1. image tile with halo r+1 (zeros outside: never used by a product
    //    that counts, see step 2)
    for (int i = tid; i < IH * IW; i += nth) {
        int ly = i / IW, lx = i - ly * IW;
        int y = y0 - r - 1 + ly, x = x0 - r - 1 + lx;
        simg[i] = (y >= 0 && y < H && x >= 0 && x < W)
                      ? img[(size_t)y * W + x] : 0.0f;
    }
    __syncthreads();

    // 2. gradient products on the r-haloed tile; zero outside the image
    //    (the box filter's zero padding), zero gradient on border pixels
    for (int i = tid; i < PH * PW; i += nth) {
        int ly = i / PW, lx = i - ly * PW;
        int y = y0 - r + ly, x = x0 - r + lx;
        float gx = 0.0f, gy = 0.0f;
        if (y >= 0 && y < H && x >= 0 && x < W) {
            const float* c = simg + (ly + 1) * IW + (lx + 1);
            if (x >= 1 && x <= W - 2)
                gx = __fmul_rn(0.5f, __fsub_rn(c[1], c[-1]));
            if (y >= 1 && y <= H - 2)
                gy = __fmul_rn(0.5f, __fsub_rn(c[IW], c[-IW]));
        }
        pxx[i] = __fmul_rn(gx, gx);
        pxy[i] = __fmul_rn(gx, gy);
        pyy[i] = __fmul_rn(gy, gy);
    }
    __syncthreads();

    // 3. row sums: h[c] = x[c] + x[c-1] + x[c+1] + x[c-2] + x[c+2] + ...
    for (int i = tid; i < PH * TW; i += nth) {
        int ly = i / TW, lx = i - ly * TW;
        int c = ly * PW + lx + r;
        float sxx = pxx[c], sxy = pxy[c], syy = pyy[c];
        for (int d = 1; d <= r; ++d) {
            sxx = __fadd_rn(__fadd_rn(sxx, pxx[c - d]), pxx[c + d]);
            sxy = __fadd_rn(__fadd_rn(sxy, pxy[c - d]), pxy[c + d]);
            syy = __fadd_rn(__fadd_rn(syy, pyy[c - d]), pyy[c + d]);
        }
        hxx[i] = sxx;
        hxy[i] = sxy;
        hyy[i] = syy;
    }
    __syncthreads();

    // 4. column sums and the response
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    if (x < W && y < H) {
        int c = (threadIdx.y + r) * TW + threadIdx.x;
        float a = hxx[c], b = hxy[c], cc = hyy[c];
        for (int d = 1; d <= r; ++d) {
            a = __fadd_rn(__fadd_rn(a, hxx[c - d * TW]), hxx[c + d * TW]);
            b = __fadd_rn(__fadd_rn(b, hxy[c - d * TW]), hxy[c + d * TW]);
            cc = __fadd_rn(__fadd_rn(cc, hyy[c - d * TW]), hyy[c + d * TW]);
        }
        float tr = __fadd_rn(a, cc);
        float det = __fsub_rn(__fmul_rn(a, cc), __fmul_rn(b, b));
        float disc = __fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.0f, det));
        disc = __fsqrt_rn(fmaxf(disc, 0.0f));
        out[(size_t)y * W + x] = __fmul_rn(0.5f, __fsub_rn(tr, disc));
    }
}

}  // namespace

extern "C" int sfm_shi_tomasi(const void* img, int H, int W, int r, void* out,
                              void* stream) {
    if (H <= 0 || W <= 0) return 0;
    const int IW = TW + 2 * r + 2, IH = TH + 2 * r + 2;
    const int PW = TW + 2 * r, PH = TH + 2 * r;
    const size_t bytes =
        (size_t)(IH * IW + 3 * PH * PW + 3 * PH * TW) * sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            shi_tomasi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 block(TW, TH);
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    shi_tomasi_kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(
        (const float*)img, H, W, r, (float*)out);
    return (int)cudaGetLastError();
}
