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
// Bound on the H100: the per-contig scan. It runs one thread per contig in
// the sequential order of np.cumsum (so every window sum, benefit and mask
// bit equals the host path's), which leaves most of the card idle at tens
// to hundreds of contigs: a 200 kb contig is a 2,000-step dependent chain
// of f64 adds. The rest is a few bytes per chunk (1 B in, 16 B of benefit
// written and read twice, 2 B of mask): 40 Mb is 400,000 chunks, ~10 MB of
// traffic, microseconds at 3.35 TB/s, so the five launches' latency and
// the single-thread 192-bin scan come next.
//
// Design (five launches, H4's scheme with per-contig sums):
//   1. aeons_scan: one thread per contig; scores from the table (NOI ends
//      set to 1) summed in f64 in chunk order into that contig's own
//      prefix array (cs_c[0] = 0), so magnitudes stay per contig;
//   2. aeons_windows: one thread per chunk finds its contig by binary
//      search, reads the 11 clamped window pairs from its contig's prefix
//      array, adds the virtual unit mass past uncapped ends, runs the
//      weighted chain in the host's order (weights 1.0 ... 0.1), writes
//      benefit = max(eb - smu, 0), and contributes to the global max
//      (integer atomicMax on the bits of non-negative doubles: exact),
//      any-nonzero, and Σsmu as one fixed-order block sum per block
//      (no atomics: the sum does not depend on scheduling);
//   3. aeons_bins: |frexp exponent| of benefit / max read from the f64
//      exponent bits (exact), int counts by shared-memory atomics, which
//      are exact in any order (F4);
//   4. aeons_threshold: one thread sums the block partials in block order
//      and runs the 192-bin scan in the host's order;
//   5. aeons_mask: benefit >= threshold, or all ones.
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
};

namespace {

constexpr int NBINS = 192;
constexpr int THREADS = 256;
constexpr int SMU_PARTS = 132 * 32;  // bk_grid's block cap

__global__ void aeons_scan(AeonsArgs a) {
    int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= a.C) return;
    int64_t s0 = c ? a.ends[c - 1] : 0, nc = a.ends[c] - s0;
    double* cs = a.cs + s0 + c;
    cs[0] = 0.0;
    uint8_t f = a.flags[c];
    double run = 0.0;
    for (int64_t i = 0; i < nc; ++i) {
        int v = a.cov[s0 + i];
        float sc = a.table[v < 100 ? v : 100];
        if ((i == 0 && (f & 1)) || (i == nc - 1 && (f & 2))) sc = 1.0f;
        run = __dadd_rn(run, (double)sc);
        cs[1 + i] = run;
    }
}

__global__ void aeons_windows(AeonsArgs a) {
    __shared__ double s_red[32];
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
        a.benefit[2 * r] = bf;
        a.benefit[2 * r + 1] = br;
        nz |= bf > 0.0 || br > 0.0;
        vmax = fmax(vmax, fmax(bf, br));
        smu = __dadd_rn(__dadd_rn(smu, sf), sr);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = fmax(vmax, __shfl_down_sync(0xffffffffu, vmax, o));
    if ((threadIdx.x & 31) == 0 && vmax > 0.0)
        atomicMax(a.norm_bits, (unsigned long long)__double_as_longlong(vmax));
    if (__syncthreads_or(nz) && threadIdx.x == 0) atomicExch(a.any_nz, 1);
    smu = bk_block_sum(smu, s_red);
    if (threadIdx.x == 0) a.smu_part[blockIdx.x] = smu;
}

__global__ void aeons_bins(AeonsArgs a) {
    __shared__ int s_cnt[NBINS];
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) s_cnt[k] = 0;
    __syncthreads();
    double norm = __longlong_as_double((long long)*a.norm_bits);
    double norm_safe = norm > 0.0 ? norm : 1.0;
    int64_t n = a.n * 2;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        double v = a.benefit[i];
        if (!(v > 0.0)) continue;
        double x = __ddiv_rn(v, norm_safe);
        int biased = (int)((__double_as_longlong(x) >> 52) & 0x7FF);
        int e = biased - 1022;  // numpy.frexp exponent of a normal x
        int idx = biased == 0 ? NBINS - 1 : min(abs(e), NBINS - 1);
        atomicAdd(s_cnt + idx, 1);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x)
        if (s_cnt[k]) atomicAdd(a.counts + k, s_cnt[k]);
}

// the 192-bin scan of _strategy_host, sequentially in one thread
__global__ void aeons_threshold(AeonsArgs a, int nparts) {
    if (threadIdx.x != 0) return;
    if (*a.any_nz == 0) {
        *a.threshold = 0.0;
        return;
    }
    double smu_sum = 0.0;
    for (int b = 0; b < nparts; ++b) smu_sum = __dadd_rn(smu_sum, a.smu_part[b]);
    double norm = __longlong_as_double((long long)*a.norm_bits);
    double su = 0.0, st = 0.0, best = -INFINITY;
    int kmax = -1, last_used = -1;
    for (int k = 0; k < NBINS; ++k) {
        double cnt = (double)a.counts[k];
        double bb = __dmul_rn(ldexp(1.0, -k), norm);
        su = __dadd_rn(su, __dmul_rn(bb, cnt));
        st = __dadd_rn(st, __dmul_rn(a.tc, cnt));
        if (a.counts[k] <= 0) continue;
        double peak = __ddiv_rn(__dadd_rn(su, smu_sum), __dadd_rn(st, a.tbar0));
        if (kmax < 0 || peak > best) {
            best = peak;
            kmax = k;
        }
        last_used = k;
    }
    int thr_idx = last_used;
    for (int k = kmax + 1; k < NBINS; ++k)
        if (a.counts[k] > 0) {
            thr_idx = k;
            break;
        }
    *a.threshold = __dmul_rn(ldexp(1.0, -thr_idx), norm);
}

__global__ void aeons_mask(AeonsArgs a) {
    bool all = *a.any_nz == 0;
    double thr = *a.threshold;
    int64_t n = a.n * 2;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
        a.mask[i] = (all || a.benefit[i] >= thr) ? 1 : 0;
}

}  // namespace

BK_API int bk_aeons_strategy(const AeonsArgs* args, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    AeonsArgs a = *args;
    if (a.n <= 0 || a.C <= 0) return -1;
    for (int k = 0; k < 11; ++k)
        if (a.win[k] < 1) return -1;
    BK_CHECK(cudaMemsetAsync(a.norm_bits, 0, sizeof(unsigned long long), st));
    BK_CHECK(cudaMemsetAsync(a.any_nz, 0, sizeof(int32_t), st));
    BK_CHECK(cudaMemsetAsync(a.counts, 0, sizeof(int32_t) * NBINS, st));
    aeons_scan<<<(unsigned)((a.C + THREADS - 1) / THREADS), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    int wgrid = bk_grid(a.n, THREADS);
    if (wgrid > SMU_PARTS) return -1;
    aeons_windows<<<wgrid, THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    aeons_bins<<<bk_grid(a.n * 2, THREADS), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    aeons_threshold<<<1, 32, 0, st>>>(a, wgrid);
    BK_LAUNCHED();
    aeons_mask<<<bk_grid(a.n * 2, THREADS), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}
