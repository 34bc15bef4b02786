// K2 lk_gather_pair: per-track template and search windows of two images.
//
// Replaces: sfm_tpu/ops/pallas/block_gather_kernel.py
//   load_blocks_pair_pallas (and, in its one-image mode to come,
//   load_blocks_pallas).
//
// For every track t: out0[t] = img0[sy0:sy0+win0, sx0:sx0+win0] and
// out1[t] = img1[sy1:sy1+win1, sx1:sx1+win1], starts clamped in-kernel.
// The TPU kernel returns blocks that are 8 or 16 rows taller, anchored at an
// aligned row below the request, because Mosaic cannot slice a VMEM tile at
// a per-track row; a CUDA thread simply computes its own address, so the
// output is exactly the requested window and the only anchor is the clamped
// start.
//
// Bound: bytes.  T * (win0^2 + win1^2) * 4 B written, about as many read
// (windows of neighbouring tracks overlap and hit L2); no arithmetic.  At
// T=2200, win 16/28 that is 9.2 MB out: a few microseconds of HBM time, so
// the launch itself dominates.  Design: one block of 128 threads per track,
// consecutive threads on consecutive columns of a row so that each row of a
// window is one or two 128-byte transactions.
//
// The fused level kernel does not call this kernel: it gathers with the same
// device function (lk_common.cuh) straight into shared memory.  This kernel
// is the gather stage on its own, with a bit-exact check against slicing.

#include "lk_common.cuh"

namespace {

__global__ void lk_gather_pair_kernel(const float* __restrict__ img0,
                                      const float* __restrict__ img1, int H,
                                      int W, const int* __restrict__ starts0,
                                      const int* __restrict__ starts1, int T,
                                      int win0, int win1,
                                      float* __restrict__ out0,
                                      float* __restrict__ out1) {
    int t = blockIdx.x;
    if (t >= T) return;
    sfm::load_window(img0, H, W, starts0[2 * t], starts0[2 * t + 1], win0,
                     out0 + (size_t)t * win0 * win0, win0, threadIdx.x,
                     blockDim.x);
    sfm::load_window(img1, H, W, starts1[2 * t], starts1[2 * t + 1], win1,
                     out1 + (size_t)t * win1 * win1, win1, threadIdx.x,
                     blockDim.x);
}

}  // namespace

extern "C" int sfm_lk_gather_pair(const void* img0, const void* img1, int H,
                                  int W, const void* starts0,
                                  const void* starts1, int T, int win0,
                                  int win1, void* out0, void* out1,
                                  void* stream) {
    if (T <= 0) return 0;
    lk_gather_pair_kernel<<<T, 128, 0, (cudaStream_t)stream>>>(
        (const float*)img0, (const float*)img1, H, W, (const int*)starts0,
        (const int*)starts1, T, win0, win1, (float*)out0, (float*)out1);
    return (int)cudaGetLastError();
}
