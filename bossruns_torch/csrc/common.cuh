// Shared helpers for the update-step kernels (coverage.cu, scores.cu,
// rows.cu, strategy.cu). Every C entry point is `extern "C"`, takes raw
// device pointers and the caller's CUDA stream, launches on that stream
// without synchronising, allocates nothing, and returns the cudaError_t of
// its launches (0 on success); ops/kernels.py binds them with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BK_API extern "C" __attribute__((visibility("default")))

// Grid size for a grid-stride loop over n items: enough blocks to fill the
// card's 132 SMs several times over, never more than the work needs.
static inline int bk_grid(int64_t n, int per_block) {
    int64_t b = (n + per_block - 1) / per_block;
    if (b < 1) b = 1;
    if (b > 132 * 32) b = 132 * 32;
    return (int)b;
}

#define BK_CHECK(expr)                                   \
    do {                                                 \
        cudaError_t bk_err_ = (expr);                    \
        if (bk_err_ != cudaSuccess) return (int)bk_err_; \
    } while (0)

#define BK_LAUNCHED() BK_CHECK(cudaGetLastError())

__device__ __forceinline__ double bk_warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ long long bk_warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Block-wide f64 sum in a fixed order (warp tree, then warp 0 over the
// warp totals): deterministic for a given blockDim. Result valid in thread 0.
// `smem` holds at least 32 doubles.
__device__ __forceinline__ double bk_block_sum(double v, double* smem) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = bk_warp_sum(v);
    __syncthreads();
    if (lane == 0) smem[warp] = v;
    __syncthreads();
    int nw = (blockDim.x + 31) >> 5;
    v = (threadIdx.x < nw) ? smem[threadIdx.x] : 0.0;
    if (warp == 0) v = bk_warp_sum(v);
    return v;
}
