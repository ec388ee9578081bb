// H7 aeons_strategy — contig scores, expected benefit, exponent-binned
// threshold and strategy mask of BOSS-AEONS.
//
// Replaces: bossruns_tpu/aeons/benefit.py:53-159 (_strategy_jit, K10, the
// device backend of contig_strategies) with the sums of its production
// host backend _strategy_host (:169-244): per-contig f64 prefix sums, where
// _strategy_jit takes an f32 cumsum over the whole flat pool (_csum,
// ops/genome_ops.py:44-48), whose rounding moves 0.2% of the mask bits of
// a 40 Mb pool near lowcov (ROADMAP Queue 3, F7).
//
// Inputs: one uint8 per 100-site chunk (min(floor(chunk sum / 100), 100)),
// the contig table (chunk-count prefix ends and four flag bits: NOI left,
// NOI right, uncapped left, uncapped right) and the 101-entry f32 sigmoid
// table built on the host by _strategy_host's own NumPy expression, so the
// scores are bit-identical to the host path without depending on expf.
// Outputs: the [N, 2] benefit (f64), the [N, 2] mask as bytes and the f64
// threshold; an all-zero benefit gives an all-ones mask and threshold 0.
//
// Bound on the H100: the per-contig prefix sum, a dependent chain of f64
// adds as long as the longest contig (np.cumsum's order, so that every
// window sum, benefit and mask bit equals the host path's): a 5 Mb contig
// is 50,000 adds in one thread, whatever the rest of the card does. The
// bytes are a few per chunk (1 B in, 16 B of benefit written and read
// twice, 2 B of mask): 40 Mb is 400,000 chunks, ~10 MB, microseconds at
// 3.35 TB/s; with pools of short contigs the four launches come next.
//
// Design (four launches, no memset; H4's scheme with per-contig sums):
//   1. aeons_scan: one block per contig; its chunks are loaded coalesced,
//      mapped through the table in shared memory (NOI ends set to 1) and
//      staged as f64 in shared memory, 2048 at a time; thread 0 runs the
//      chain over the stage in chunk order (bk_chain_sum: each group of
//      eight loaded ahead of the adds), and the block writes the prefixes
//      back coalesced into that contig's own prefix array (cs_c[0] = 0),
//      so magnitudes stay per contig. Block 0 also zeroes the scalars, bins
//      and tickets that the later launches add into;
//   2. aeons_windows: one thread per chunk finds its contig by binary
//      search, reads the 11 clamped window pairs from its contig's prefix
//      array, adds the virtual unit mass past uncapped ends, runs the
//      weighted chain in the host's order (weights 1.0 ... 0.1), writes
//      benefit = max(eb - smu, 0), and contributes to the global max
//      (integer atomicMax on the bits of non-negative doubles: exact),
//      any-nonzero, and Σsmu as one fixed-order block sum per block; the
//      last block (a ticket after a fence) adds the block sums in a fixed
//      order (each thread a run of them, then the block's tree), so Σsmu
//      depends on the shape only, never on scheduling;
//   3. aeons_bins: |frexp exponent| of benefit / max read from the f64
//      exponent bits (exact), int counts kept per thread and strand while
//      the bin stays the same, a warp whose lanes hold one bin adding one
//      warp sum, and the block's bins added once: integers, exact in any
//      order (F4). The last block runs the 192-bin scan in the host's
//      order (bk_exponent_threshold);
//   4. aeons_mask: benefit >= threshold, or all ones.
// f64 arithmetic on the decision path uses the _rn intrinsics so nvcc
// cannot contract it into FMAs the host path does not do.
#include <math.h>

#include "common.cuh"

struct AeonsArgs {
    int64_t n;            // chunks
    int64_t C;            // contigs
    int32_t win[11];      // mu window, then the 10 CCL windows (chunks, >= 1)
    int32_t pad0;
    double weight[10];    // CCL window weights, 1.0 ... 0.1
    double tc;            // max((lam - mu - 300) // 100, 1)
    double tbar0;         // alpha + rho + mu in chunks
    const uint8_t* cov;   // [n]
    const int64_t* ends;  // [C] chunk-count prefix sums
    const uint8_t* flags; // [C] bit 0 NOI left, 1 NOI right, 2 uncapped left, 3 uncapped right
    const float* table;   // [101] sigmoid scores
    double* cs;           // [n + C] scratch: contig c's prefix sums at ends[c-1] + c
    double* benefit;      // [n, 2] out
    double* smu_part;     // [SMU_PARTS] scratch: per-block Σsmu
    unsigned long long* norm_bits;
    int32_t* any_nz;
    int32_t* counts;      // [NBINS]
    double* threshold;    // [1] out
    uint8_t* mask;        // [n, 2] out
    unsigned int* tickets;  // [2] scratch: the windows' and the bins' last-block tickets
    double* smu_sum;      // [1] scratch: Σsmu
};

namespace {

constexpr int NBINS = 192;
constexpr int THREADS = 256;
constexpr int SMU_PARTS = 132 * 32;  // bk_grid's block cap
constexpr int STAGE = 2048;          // chunks staged in shared memory per pass
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) aeons_scan(AeonsArgs a) {
    __shared__ float s_tab[101];
    __shared__ __align__(16) double s_buf[STAGE];
    const int t = threadIdx.x;
    if (blockIdx.x == 0) {
        for (int k = t; k < NBINS; k += THREADS) a.counts[k] = 0;
        if (t == 0) {
            *a.norm_bits = 0ull;
            *a.any_nz = 0;
            a.tickets[0] = a.tickets[1] = 0u;
        }
    }
    for (int k = t; k < 101; k += THREADS) s_tab[k] = a.table[k];
    const int64_t c = blockIdx.x;
    const int64_t s0 = c ? a.ends[c - 1] : 0, nc = a.ends[c] - s0;
    const uint8_t* cov = a.cov + s0;
    double* cs = a.cs + s0 + c;
    const uint8_t f = a.flags[c];
    if (t == 0) cs[0] = 0.0;
    double run = 0.0;  // thread 0's
    for (int64_t base = 0; base < nc; base += STAGE) {
        const int m = (int)(nc - base < STAGE ? nc - base : STAGE);
        __syncthreads();  // the table is in; the last stage is written back
        for (int i = t; i < m; i += THREADS) {
            int64_t g = base + i;
            int v = cov[g];
            float sc = s_tab[v < 100 ? v : 100];
            if ((g == 0 && (f & 1)) || (g == nc - 1 && (f & 2))) sc = 1.0f;
            s_buf[i] = (double)sc;
        }
        __syncthreads();
        if (t == 0) run = bk_chain_sum<false>(s_buf, m, run);
        __syncthreads();
        for (int i = t; i < m; i += THREADS) cs[1 + base + i] = s_buf[i];
    }
}

__global__ void __launch_bounds__(THREADS) aeons_windows(AeonsArgs a) {
    __shared__ double s_red[32];
    __shared__ int s_last;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    double smu = 0.0, vmax = 0.0;
    bool nz = false;
    for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += stride) {
        int64_t lo = 0, hi = a.C;  // first contig whose end lies past r
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (a.ends[mid] <= r) lo = mid + 1; else hi = mid;
        }
        int64_t c = lo;
        int64_t s0 = c ? a.ends[c - 1] : 0, nc = a.ends[c] - s0, i = r - s0;
        const double* cs = a.cs + s0 + c;
        uint8_t f = a.flags[c];
        bool el = f & 4, er = f & 8;
        auto fwd = [&](int64_t w) {
            int64_t h = i + w < nc ? i + w : nc;
            double v = __dsub_rn(cs[h], cs[i]);
            if (er) {
                int64_t over = i + w - nc;
                v = __dadd_rn(v, (double)(over < 0 ? 0 : (over > w ? w : over)));
            }
            return v;
        };
        auto rev = [&](int64_t w) {
            int64_t l = i + 1 - w > 0 ? i + 1 - w : 0;
            double v = __dsub_rn(cs[i + 1], cs[l]);
            if (el) {
                int64_t over = w - 1 - i;
                v = __dadd_rn(v, (double)(over < 0 ? 0 : (over > w ? w : over)));
            }
            return v;
        };
        double sf = fwd(a.win[0]), sr = rev(a.win[0]);
        double ef = __dmul_rn(a.weight[0], fwd(a.win[1]));
        double er_ = __dmul_rn(a.weight[0], rev(a.win[1]));
#pragma unroll
        for (int k = 1; k < 10; ++k) {
            ef = __dadd_rn(ef, __dmul_rn(a.weight[k], fwd(a.win[k + 1])));
            er_ = __dadd_rn(er_, __dmul_rn(a.weight[k], rev(a.win[k + 1])));
        }
        double bf = __dsub_rn(ef, sf), br = __dsub_rn(er_, sr);
        bf = bf > 0.0 ? bf : 0.0;
        br = br > 0.0 ? br : 0.0;
        reinterpret_cast<double2*>(a.benefit)[r] = make_double2(bf, br);
        nz |= bf > 0.0 || br > 0.0;
        vmax = fmax(vmax, fmax(bf, br));
        smu = __dadd_rn(__dadd_rn(smu, sf), sr);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = fmax(vmax, __shfl_down_sync(FULL, vmax, o));
    if ((threadIdx.x & 31) == 0 && vmax > 0.0)
        atomicMax(a.norm_bits, (unsigned long long)__double_as_longlong(vmax));
    if (__syncthreads_or(nz) && threadIdx.x == 0) atomicExch(a.any_nz, 1);
    smu = bk_block_sum(smu, s_red);
    if (threadIdx.x == 0) {
        a.smu_part[blockIdx.x] = smu;
        __threadfence();
        s_last = atomicAdd(a.tickets, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // Σsmu in a fixed order: thread t adds the block sums [t q, t q + q) in
    // block order, then the block's fixed tree
    const int np = gridDim.x, q = (np + THREADS - 1) / THREADS;
    double v = 0.0;
    for (int i = threadIdx.x * q; i < min(np, (int)threadIdx.x * q + q); ++i)
        v = __dadd_rn(v, __ldcg(a.smu_part + i));
    v = bk_block_sum(v, s_red);
    if (threadIdx.x == 0) *a.smu_sum = v;
}

// The 192-bin scan of _strategy_host by the whole block (at least NBINS
// threads): each bin's terms in its own thread (an empty bin adds +0.0 to
// the host's sums and is skipped), the scan in bk_exponent_threshold;
// thread 0 writes the threshold.
__device__ void aeons_threshold(const AeonsArgs& a, const int* counts,
                                BkThresholdScratch<NBINS>& sh) {
    const int t = threadIdx.x;
    if (__ldcg(a.any_nz) == 0) {
        if (t == 0) *a.threshold = 0.0;
        return;
    }
    const double norm = __longlong_as_double(__ldcg(reinterpret_cast<const long long*>(a.norm_bits)));
    const bool used = t < NBINS && counts[t] > 0;
    double tu = 0.0, tt = 0.0;
    if (used) {
        const double cnt = (double)counts[t];
        tu = __dmul_rn(__dmul_rn(bk_pow2_neg(t), norm), cnt);
        tt = __dmul_rn(a.tc, cnt);
    }
    int k = bk_exponent_threshold<NBINS>(used, tu, tt, __ldcg(a.smu_sum), a.tbar0, sh);
    if (t == 0) *a.threshold = __dmul_rn(bk_pow2_neg(k), norm);
}

// |numpy.frexp exponent| of v / norm for v > 0, clamped to the top bin
__device__ __forceinline__ int exponent_bin(double v, double norm_safe) {
    double x = __ddiv_rn(v, norm_safe);
    int biased = (int)((__double_as_longlong(x) >> 52) & 0x7FF);
    return biased == 0 ? NBINS - 1 : min(abs(biased - 1022), NBINS - 1);
}

// One thread's run of equal bins, flushed into the block's bins when the
// bin changes; flush_warp merges the warp's open runs (every lane calls
// it): one warp sum where all lanes hold one bin, else per bin
// (__match_any_sync)
struct BinRun {
    int bin = -1, cnt = 0;
    __device__ __forceinline__ void add(int k, int* s_cnt) {
        if (k != bin) {
            if (cnt) atomicAdd(s_cnt + bin, cnt);
            bin = k;
            cnt = 0;
        }
        ++cnt;
    }
    __device__ __forceinline__ void flush_warp(int* s_cnt) {
        const int key = cnt ? bin : -1;
        const int k0 = __shfl_sync(FULL, key, 0);
        if (__all_sync(FULL, key == k0)) {
            const int c = __reduce_add_sync(FULL, cnt);
            if (k0 >= 0 && (threadIdx.x & 31) == 0) atomicAdd(s_cnt + k0, c);
        } else {  // lanes with the same bin add into the lowest one's
            const unsigned peers = __match_any_sync(FULL, key);
            int c = 0;
            for (int j = 0; j < 32; ++j) {
                const int cj = __shfl_sync(FULL, cnt, j);
                if ((peers >> j) & 1u) c += cj;
            }
            if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(s_cnt + key, c);
        }
    }
};

__global__ void __launch_bounds__(THREADS) aeons_bins(AeonsArgs a) {
    __shared__ int s_cnt[NBINS];
    __shared__ int s_last;
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) s_cnt[k] = 0;
    __syncthreads();
    double norm = __longlong_as_double((long long)*a.norm_bits);
    double norm_safe = norm > 0.0 ? norm : 1.0;
    const double2* ben = reinterpret_cast<const double2*>(a.benefit);
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    BinRun fw, rv;  // one run per strand
    for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += stride) {
        double2 v = ben[r];
        if (v.x > 0.0) fw.add(exponent_bin(v.x, norm_safe), s_cnt);
        if (v.y > 0.0) rv.add(exponent_bin(v.y, norm_safe), s_cnt);
    }
    fw.flush_warp(s_cnt);
    rv.flush_warp(s_cnt);
    __syncthreads();
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x)
        if (s_cnt[k]) atomicAdd(a.counts + k, s_cnt[k]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(a.tickets + 1, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    __shared__ BkThresholdScratch<NBINS> sh;
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) s_cnt[k] = __ldcg(a.counts + k);
    __syncthreads();
    aeons_threshold(a, s_cnt, sh);
}

__global__ void __launch_bounds__(THREADS) aeons_mask(AeonsArgs a) {
    const bool all = *a.any_nz == 0;
    const double thr = *a.threshold;
    const double2* ben = reinterpret_cast<const double2*>(a.benefit);
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += stride) {
        double2 v = ben[r];
        reinterpret_cast<uchar2*>(a.mask)[r] =
            make_uchar2((all || v.x >= thr) ? 1 : 0, (all || v.y >= thr) ? 1 : 0);
    }
}

}  // namespace

BK_API int bk_aeons_strategy(const AeonsArgs* args, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    AeonsArgs a = *args;
    if (a.n <= 0 || a.C <= 0 || a.C > 0x7fffffff) return -1;
    for (int k = 0; k < 11; ++k)
        if (a.win[k] < 1) return -1;
    aeons_scan<<<(unsigned)a.C, THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    int wgrid = bk_grid(a.n, THREADS);
    if (wgrid > SMU_PARTS) return -1;
    aeons_windows<<<wgrid, THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    aeons_bins<<<bk_grid(a.n, THREADS), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    aeons_mask<<<bk_grid(a.n, THREADS), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}
