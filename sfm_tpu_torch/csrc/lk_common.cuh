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
//
// Storage: the LK images and windows are float32 or bfloat16
// (SFM_TPU_LK_BF16, ops/klt.lk_dtype).  Every kernel reads bfloat16 values
// into float32 (exact) before any arithmetic, so the sums accumulate in
// float32 as in the plain version.
#pragma once

#include <cuda_bf16.h>
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

// Copy the win x win window at (sx, sy) of img (H x W, row-major), its
// start clamped into the image, into dst (row stride dst_stride): one
// warp, with cp.async (4 bytes a lane), row by row, lane l on columns l,
// l+32, ...; every load of the window is in flight at once, and none
// passes through registers.  The caller waits with copy_wait().
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

// The bfloat16 twin: cp.async moves 4, 8 or 16 bytes, not one 2-byte
// pixel, and the window must land in shared memory as float32.  Each lane
// loads its pixels and stores them converted (exact); copy_wait() then
// orders the stores for the warp as for the copies.  (Loading 8 pixels a
// lane before storing them, all 32 lanes on the window's pixels as one
// run, gained 0.6 % on an H100; PERF.md, Findings.)
__device__ __forceinline__ void load_window_async(
    const __nv_bfloat16* __restrict__ img, int H, int W, int sx, int sy,
    int win, float* dst, int dst_stride, int lane) {
    sx = clamp_start(sx, W, win);
    sy = clamp_start(sy, H, win);
    const __nv_bfloat16* src = img + (size_t)sy * W + sx;
#pragma unroll 4
    for (int r = 0; r < win; ++r)
        for (int c = lane; c < win; c += 32)
            dst[r * dst_stride + c] = __bfloat162float(src[(size_t)r * W + c]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// Four consecutive stored values at p (4 * sizeof(T)-byte aligned) as
// float32, in one load.
__device__ __forceinline__ void load4(const float* p, float e[4]) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    e[0] = w.x;
    e[1] = w.y;
    e[2] = w.z;
    e[3] = w.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float e[4]) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    e[0] = a.x;
    e[1] = a.y;
    e[2] = b.x;
    e[3] = b.y;
}

// Calls f((T*)nullptr) with T = __nv_bfloat16 for bf16 != 0, else float:
// the storage type of an entry point's images or windows.
template <class F>
int dispatch_storage(int bf16, F&& f) {
    return bf16 ? f((__nv_bfloat16*)nullptr) : f((float*)nullptr);
}

// Waits for this lane's load_window_async copies, then for the warp's.
__device__ __forceinline__ void copy_wait() {
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
}

}  // namespace sfm
