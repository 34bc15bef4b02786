// Window addressing shared by the LK gather kernel (lk_gather_pair.cu) and
// the fused LK level kernel (lk_level_fused.cu).
//
// A "window" is a win x win block of one pyramid level whose top-left pixel
// is (sx, sy).  The start is clamped HERE to [0, W-win] x [0, H-win] as well
// as by the caller: dead track slots carry NaN or garbage positions, and a
// start that is out of range must never become an out-of-range read.  The
// clamp bounds are the image's, never the window's position inside some
// larger aligned block: the LK sub-window clamp (lk_level_fused.cu) is
// relative to this start, so any other anchor shifts which pixels a marginal
// track converges on.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <float.h>

namespace sfm {

__device__ __forceinline__ int clamp_start(int s, int extent, int win) {
    int hi = extent - win;
    if (hi < 0) hi = 0;
    return s < 0 ? 0 : (s > hi ? hi : s);
}

// nan -> 0, +-inf -> +-FLT_MAX: what the plain version's nan_to_num does
// before any float is cast to an integer.
__device__ __forceinline__ float nan_to_num(float x) {
    if (isnan(x)) return 0.0f;
    if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
    return x;
}

// Float start of a window around origin o (one axis), as the plain version
// computes it: floor(nan_to_num(o)) - back, clipped in float to
// [0, extent - win]; the caller casts the result to int.
__device__ __forceinline__ float window_start(float o, int back, int extent,
                                              int win) {
    float s = floorf(nan_to_num(o)) - (float)back;
    float hi = (float)(extent - win);
    s = fminf(fmaxf(s, 0.0f), hi);
    return s;
}

// Copy the win x win window at (sx, sy) of img (H x W, row-major) into dst
// (row stride dst_stride); the nthreads threads of the caller's group,
// of which this is number tid, share the work.
__device__ __forceinline__ void load_window(const float* __restrict__ img,
                                            int H, int W, int sx, int sy,
                                            int win, float* dst,
                                            int dst_stride, int tid,
                                            int nthreads) {
    sx = clamp_start(sx, W, win);
    sy = clamp_start(sy, H, win);
    const float* src = img + (size_t)sy * W + sx;
    for (int i = tid; i < win * win; i += nthreads) {
        int r = i / win;
        int c = i - r * win;
        dst[r * dst_stride + c] = src[(size_t)r * W + c];
    }
}

// load_window for one warp, with cp.async (4 bytes a lane): row by row,
// lane l on columns l, l+32, ...; every load of the window is in flight at
// once, and none passes through registers.  The caller waits with
// copy_wait().
__device__ __forceinline__ void load_window_async(
    const float* __restrict__ img, int H, int W, int sx, int sy, int win,
    float* dst, int dst_stride, int lane) {
    sx = clamp_start(sx, W, win);
    sy = clamp_start(sy, H, win);
    const float* src = img + (size_t)sy * W + sx;
    for (int r = 0; r < win; ++r)
        for (int c = lane; c < win; c += 32)
            __pipeline_memcpy_async(dst + r * dst_stride + c,
                                    src + (size_t)r * W + c, sizeof(float));
}

// Waits for this lane's load_window_async copies, then for the warp's.
__device__ __forceinline__ void copy_wait() {
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
}

}  // namespace sfm
