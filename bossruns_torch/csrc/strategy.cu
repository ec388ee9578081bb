// H4 benefit_strategy — expected benefit, exponent-binned threshold, strategy.
//
// Replaces: bossruns_tpu/ops/genome_ops.py:44-129 (_csum, windowed_sums_fwd,
// windowed_sums_rev, expected_benefit), :164-291 (_pow2_i32,
// frexp_abs_exponent, bin_benefit, ubar0_partial, threshold_from_bins,
// find_strategy) and their call sites with the bucket gate in
// models/runs.py:666-687.
//
// Bound on the H100: launch latency. Every array is genome/100-sized f64
// (81,920 rows x 2 strands at the 8.05 Mb slice), a few MB in all, so the
// seven launches and the single-block threshold scan dominate.
//
// Design:
//   1. f64 exclusive cumsum of scores_ds, by hand: a per-tile scan (1024
//      threads x 4 items), a sequential pass over the tile totals, and an
//      add of each tile's prefix;
//   2. one thread per row reads the 22 clamped windows from the cumsum and
//      runs the weighted chain unrolled in the reference order
//      (genome_ops.py:121-128), writes smu and benefit, and contributes to
//      the global max (integer atomicMax on the bits of non-negative
//      doubles: exact), any-nonzero, and ubar0 (sum of f32-rounded
//      products: exact in any order by the F4 contract);
//   3. exponent bins: |frexp exponent| read from the f64 exponent bits
//      (exact; Hopper has native f64), int32 counts and the fsum of the
//      f32-rounded fhat weights, in shared-memory histograms flushed once
//      per block;
//   4. the 192-bin scan sequentially in one thread, in the reference
//      order, so the threshold is bit-identical to a sequential f64 scan;
//   5. the gated strategy write.
// f64 arithmetic on the decision path uses the _rn intrinsics so nvcc
// cannot contract it into FMAs the reference does not do.
#include <math.h>

#include "common.cuh"

struct StratArgs {
    int64_t nb, Gd, nbk;
    int32_t mu_ds, quirks;
    int32_t win[10];
    double weight[10];
    double tc;  // (time_cost // 100) in f64
    // inputs
    const double* scores_ds;
    const int32_t* seg_start;
    const int32_t* seg_end;
    const double* fhat_exp;
    const uint8_t* bucket_on;
    const int32_t* bucket_idx;
    const uint8_t* strat_valid;
    // state, updated in place; aux[0] (any_on) in, aux[1], aux[2] out
    uint8_t* strat;
    float* aux;
    // outputs
    double* smu;
    double* benefit;
    double* threshold;
    // scratch
    double* cs;
    double* tile_sums;
    unsigned long long* norm_bits;
    int32_t* any_nz;
    int32_t* counts;
    double* fsum;
    double* ubar0;
};

namespace {

constexpr int NBINS = 192;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;

// 1a. tile-local inclusive prefix sums into cs[b, 1 + i], tile totals out
__global__ void scan_tiles(StratArgs a, int64_t n_tiles) {
    __shared__ double s_warp[32];
    int64_t b = blockIdx.y, t = blockIdx.x;
    const double* x = a.scores_ds + b * a.Gd;
    double* cs = a.cs + b * (a.Gd + 1);
    int64_t base = t * TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
    double p[SCAN_ITEMS];
    double run = 0.0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        double v = base + k < a.Gd ? x[base + k] : 0.0;
        run = k == 0 ? v : run + v;
        p[k] = run;
    }
    // block exclusive scan of the per-thread totals (exclusive prefixes are
    // taken from the neighbour's inclusive one, never by subtraction)
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        double y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    double excl_lane = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl_lane = 0.0;
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        double wi = s_warp[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            double y = __shfl_up_sync(0xffffffffu, wi, o);
            if (lane >= o) wi += y;
        }
        double we = __shfl_up_sync(0xffffffffu, wi, 1);
        __syncwarp();
        s_warp[lane] = lane == 0 ? 0.0 : we;  // exclusive prefix of warp totals
    }
    __syncthreads();
    double excl = s_warp[warp] + excl_lane;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
        if (base + k < a.Gd) cs[1 + base + k] = excl + p[k];
    if (threadIdx.x == SCAN_THREADS - 1) a.tile_sums[b * n_tiles + t] = excl + run;
}

// 1b. exclusive prefix over the tile totals (few tiles: one thread each b)
__global__ void scan_tile_prefix(StratArgs a, int64_t n_tiles) {
    int64_t b = blockIdx.x;
    double run = 0.0;
    for (int64_t t = 0; t < n_tiles; ++t) {
        double s = a.tile_sums[b * n_tiles + t];
        a.tile_sums[b * n_tiles + t] = run;
        run += s;
    }
    a.cs[b * (a.Gd + 1)] = 0.0;
}

// 1c. add each tile's prefix
__global__ void scan_add(StratArgs a, int64_t n_tiles) {
    int64_t n = a.nb * a.Gd;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        int64_t b = i / a.Gd, r = i - b * a.Gd;
        int64_t t = r / TILE;
        if (t > 0) a.cs[b * (a.Gd + 1) + 1 + r] += a.tile_sums[b * n_tiles + t];
    }
}

// 2. windows, weighted chain, benefit; max, any-nonzero and ubar0
__global__ void benefit_windows(StratArgs a) {
    __shared__ double s_red[32];
    int64_t n = a.nb * a.Gd;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    double u0 = 0.0, vmax = 0.0;
    bool nz = false;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        int64_t b = i / a.Gd, r = i - b * a.Gd;
        const double* c = a.cs + b * (a.Gd + 1);
        int64_t se = a.seg_end[r], ss = a.seg_start[r];
        double cr = c[r], cr1 = c[r + 1];
        auto fwd = [&](int64_t w) {
            int64_t hi = r + w < se ? r + w : se;
            return __dsub_rn(c[hi], cr);
        };
        auto rev = [&](int64_t w) {
            int64_t lo = r + 1 - w > ss ? r + 1 - w : ss;
            return __dsub_rn(cr1, c[lo]);
        };
        double sf = fwd(a.mu_ds), sr = rev(a.mu_ds);
        double ef = __dmul_rn(a.weight[0], fwd(a.win[0]));
        double er = __dmul_rn(a.weight[0], rev(a.win[0]));
#pragma unroll
        for (int k = 1; k < 10; ++k) {
            ef = __dadd_rn(ef, __dmul_rn(a.weight[k], fwd(a.win[k])));
            er = __dadd_rn(er, __dmul_rn(a.weight[k], rev(a.win[k])));
        }
        double bf = __dsub_rn(ef, sf), br = __dsub_rn(er, sr);
        bf = bf > 0.0 ? bf : 0.0;
        br = br > 0.0 ? br : 0.0;
        a.smu[2 * i] = sf;
        a.smu[2 * i + 1] = sr;
        a.benefit[2 * i] = bf;
        a.benefit[2 * i + 1] = br;
        nz |= bf > 0.0 || br > 0.0;
        vmax = fmax(vmax, fmax(bf, br));
        double f0 = a.fhat_exp[2 * r], f1 = a.fhat_exp[2 * r + 1];
        double q0 = a.quirks ? bf : sf, q1 = a.quirks ? br : sr;
        u0 += (double)__double2float_rn(__dmul_rn(f0, q0));
        u0 += (double)__double2float_rn(__dmul_rn(f1, q1));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = fmax(vmax, __shfl_down_sync(0xffffffffu, vmax, o));
    if ((threadIdx.x & 31) == 0 && vmax > 0.0)
        atomicMax(a.norm_bits, (unsigned long long)__double_as_longlong(vmax));
    if (__syncthreads_or(nz) && threadIdx.x == 0) atomicExch(a.any_nz, 1);
    u0 = bk_block_sum(u0, s_red);
    if (threadIdx.x == 0 && u0 != 0.0) atomicAdd(a.ubar0, u0);
}

// 3. exponent-bin histogram of benefit / norm
__global__ void bin_benefit(StratArgs a) {
    __shared__ int s_cnt[NBINS];
    __shared__ double s_fs[NBINS];
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) {
        s_cnt[k] = 0;
        s_fs[k] = 0.0;
    }
    __syncthreads();
    double norm = __longlong_as_double((long long)*a.norm_bits);
    double norm_safe = norm > 0.0 ? norm : 1.0;
    int64_t n = a.nb * a.Gd * 2;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        double v = a.benefit[i];
        if (!(v > 0.0)) continue;
        double x = __ddiv_rn(v, norm_safe);
        int biased = (int)((__double_as_longlong(x) >> 52) & 0x7FF);
        int e = biased - 1022;  // numpy.frexp exponent of a normal x
        int idx = biased == 0 ? NBINS - 1 : min(abs(e), NBINS - 1);
        atomicAdd(s_cnt + idx, 1);
        atomicAdd(s_fs + idx, a.fhat_exp[i % (a.Gd * 2)]);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) {
        if (s_cnt[k]) {
            atomicAdd(a.counts + k, s_cnt[k]);
            atomicAdd(a.fsum + k, s_fs[k]);
        }
    }
}

// 4. the threshold scan, sequential in one thread (threshold_from_bins)
__global__ void threshold_scan(StratArgs a) {
    if (threadIdx.x != 0) return;
    double norm = __longlong_as_double((long long)*a.norm_bits);
    double norm_safe = norm > 0.0 ? norm : 1.0;
    double ubar0 = *a.ubar0;
    const double tbar0 = 10.0;  // alpha + rho + mu in 100-site rows: 3 + 3 + 4
    double su = 0.0, st = 0.0, best = -INFINITY;
    int kmax = 0, last_used = -1;
    bool have = false;
    for (int k = 0; k < NBINS; ++k) {
        int ck = a.counts[k];
        if (ck <= 0) continue;
        double cnt = (double)ck;
        double f_mean = __ddiv_rn(a.fsum[k], cnt);
        double bb = __dmul_rn(ldexp(1.0, -k), norm_safe);
        su = __dadd_rn(su, __dmul_rn(__dmul_rn(bb, f_mean), cnt));
        st = __dadd_rn(st, __dmul_rn(__dmul_rn(a.tc, cnt), f_mean));
        double peak = __ddiv_rn(__dadd_rn(su, ubar0), __dadd_rn(st, tbar0));
        if (!have || peak > best) {
            best = peak;
            kmax = k;
            have = true;
        }
        last_used = k;
    }
    int nxt = NBINS;
    for (int k = kmax + 1; k < NBINS; ++k)
        if (a.counts[k] > 0) {
            nxt = k;
            break;
        }
    int thr_idx = nxt < NBINS ? nxt : last_used;
    if (thr_idx < 0) thr_idx = 0;
    double thr = __dmul_rn(ldexp(1.0, -thr_idx), norm_safe);
    bool update = a.aux[0] != 0.f && *a.any_nz != 0;
    *a.threshold = thr;
    a.aux[1] = update ? 1.f : 0.f;
    a.aux[2] = __double2float_rn(thr);
}

// 5. gated strategy write
__global__ void strat_write(StratArgs a) {
    if (a.aux[1] == 0.f) return;
    double thr = *a.threshold;
    int64_t n = a.nb * a.Gd;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        int64_t b = i / a.Gd, r = i - b * a.Gd;
        int32_t bi = a.bucket_idx[r];
        if (!a.strat_valid[r] || bi < 0 || !a.bucket_on[b * a.nbk + bi]) continue;
        a.strat[2 * i] = a.benefit[2 * i] >= thr ? 1 : 0;
        a.strat[2 * i + 1] = a.benefit[2 * i + 1] >= thr ? 1 : 0;
    }
}

}  // namespace

BK_API int bk_benefit_strategy(const StratArgs* args, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    StratArgs a = *args;
    int64_t n_tiles = (a.Gd + TILE - 1) / TILE;
    BK_CHECK(cudaMemsetAsync(a.norm_bits, 0, sizeof(unsigned long long), st));
    BK_CHECK(cudaMemsetAsync(a.any_nz, 0, sizeof(int32_t), st));
    BK_CHECK(cudaMemsetAsync(a.counts, 0, sizeof(int32_t) * NBINS, st));
    BK_CHECK(cudaMemsetAsync(a.fsum, 0, sizeof(double) * NBINS, st));
    BK_CHECK(cudaMemsetAsync(a.ubar0, 0, sizeof(double), st));
    scan_tiles<<<dim3((unsigned)n_tiles, (unsigned)a.nb), SCAN_THREADS, 0, st>>>(a, n_tiles);
    BK_LAUNCHED();
    scan_tile_prefix<<<(unsigned)a.nb, 1, 0, st>>>(a, n_tiles);
    BK_LAUNCHED();
    scan_add<<<bk_grid(a.nb * a.Gd, 256), 256, 0, st>>>(a, n_tiles);
    BK_LAUNCHED();
    benefit_windows<<<bk_grid(a.nb * a.Gd, 256), 256, 0, st>>>(a);
    BK_LAUNCHED();
    bin_benefit<<<bk_grid(a.nb * a.Gd * 2, 256), 256, 0, st>>>(a);
    BK_LAUNCHED();
    threshold_scan<<<1, 32, 0, st>>>(a);
    BK_LAUNCHED();
    strat_write<<<bk_grid(a.nb * a.Gd, 256), 256, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}
