// Shared helpers for the kernels (coverage.cu, scores.cu, rows.cu,
// strategy.cu, seed.cu, aeons_strategy.cu). Every C entry point is `extern "C"`, takes raw
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

// One thread's f64 prefix sum over buf[0, m) in place, in index order
// (run = run + buf[i], as a sequential loop): inclusive (buf[i] takes the
// sum through i) or exclusive (the sum before i). buf is 16-byte aligned
// (shared memory). Groups of eight move as double2, and each group is
// loaded before the adds of the group ahead of it, so the loads hide
// behind the chain of dependent adds, which bounds it.
template <bool EXCLUSIVE>
__device__ __forceinline__ double bk_chain_sum(double* buf, int m, double run) {
    double2* b2 = reinterpret_cast<double2*>(buf);
    const int groups = m >> 3;
    double2 nx[4];
    if (groups > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) nx[k] = b2[k];
    }
    for (int g = 0; g < groups; ++g) {
        double2 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = nx[k];
        if (g + 1 < groups) {
#pragma unroll
            for (int k = 0; k < 4; ++k) nx[k] = b2[4 * g + 4 + k];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            double2 o;
            if (EXCLUSIVE) {
                o.x = run;
                run = __dadd_rn(run, v[k].x);
                o.y = run;
                run = __dadd_rn(run, v[k].y);
            } else {
                run = __dadd_rn(run, v[k].x);
                o.x = run;
                run = __dadd_rn(run, v[k].y);
                o.y = run;
            }
            b2[4 * g + k] = o;
        }
    }
    for (int i = groups * 8; i < m; ++i) {
        double x = buf[i];
        if (EXCLUSIVE) {
            buf[i] = run;
            run = __dadd_rn(run, x);
        } else {
            run = __dadd_rn(run, x);
            buf[i] = run;
        }
    }
    return run;
}

// Exactly 2^-k for k in [0, 1022] (a normal double built from its exponent).
__device__ __forceinline__ double bk_pow2_neg(int k) {
    return __longlong_as_double((long long)(1023 - k) << 52);
}

// The exponent-bin threshold scan (threshold_from_bins; aeons/benefit.py's
// _threshold_scan) by a whole block of at least NB threads; every thread
// calls it. Thread t < NB brings bin t: whether it is used and its two
// terms (tu: benefit mass, tt: time). Thread 0 adds the terms of the used
// bins in bin order, su and st, and forms num = su + u0 and den = st + t0;
// every thread divides its bin's num / den; the block picks the first
// maximum. So every value equals a sequential scan's. Returns, in thread
// 0, the threshold bin: the next used bin after the maximum, else the last
// used one (-1 when no bin is used). `sh` lives in shared memory.
template <int NB>
struct BkThresholdScratch {
    double num[NB], den[NB], bv[32];
    unsigned words[NB / 32];
    int bi[32];
};

template <int NB>
__device__ int bk_exponent_threshold(bool used, double tu, double tt, double u0, double t0,
                                     BkThresholdScratch<NB>& sh) {
    static_assert(NB % 32 == 0, "whole warps of bins");
    double* s_num = sh.num;
    double* s_den = sh.den;
    unsigned* s_words = sh.words;
    double* s_bv = sh.bv;
    int* s_bi = sh.bi;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    used = used && t < NB;
    const unsigned bits = __ballot_sync(0xffffffffu, used);
    if (t < NB) {
        if (lane == 0) s_words[warp] = bits;
        s_num[t] = tu;
        s_den[t] = tt;
    }
    __syncthreads();
    if (t == 0) {
        double su = 0.0, st = 0.0;
        for (int w = 0; w < NB / 32; ++w)
            for (unsigned m = s_words[w]; m; m &= m - 1) {
                const int k = 32 * w + __ffs(m) - 1;
                su = __dadd_rn(su, s_num[k]);
                st = __dadd_rn(st, s_den[k]);
                s_num[k] = __dadd_rn(su, u0);
                s_den[k] = __dadd_rn(st, t0);
            }
    }
    __syncthreads();
    // first maximum of the peaks: the larger value, on a tie the lower bin
    double v = used ? __ddiv_rn(s_num[t], s_den[t]) : -INFINITY;
    int i = used ? t : NB;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const double v2 = __shfl_down_sync(0xffffffffu, v, o);
        const int i2 = __shfl_down_sync(0xffffffffu, i, o);
        if (v2 > v || (v2 == v && i2 < i)) {
            v = v2;
            i = i2;
        }
    }
    if (lane == 0) {
        s_bv[warp] = v;
        s_bi[warp] = i;
    }
    __syncthreads();
    if (t != 0) return -1;
    int kmax = NB;
    for (int w = 0; w < NB / 32; ++w)
        if (s_bi[w] < NB && (kmax == NB || s_bv[w] > v)) {
            v = s_bv[w];
            kmax = s_bi[w];
        }
    if (kmax == NB) return -1;
    int last = -1;
    for (int w = 0; w < NB / 32; ++w)
        if (s_words[w]) last = 32 * w + 31 - __clz(s_words[w]);
    for (int w = (kmax + 1) / 32; w < NB / 32; ++w) {
        unsigned m = s_words[w];
        if (32 * w < kmax + 1) m &= ~0u << (kmax + 1 - 32 * w);
        if (m) return 32 * w + __ffs(m) - 1;
    }
    return last;
}
