// H4 benefit_strategy — expected benefit, exponent-binned threshold, strategy.
//
// Replaces: bossruns_tpu/ops/genome_ops.py:44-129 (_csum, windowed_sums_fwd,
// windowed_sums_rev, expected_benefit), :164-291 (_pow2_i32,
// frexp_abs_exponent, bin_benefit, ubar0_partial, threshold_from_bins,
// find_strategy) and their call sites with the bucket gate in
// models/runs.py:666-687.
//
// Bound on the H100: bytes, and at small genomes the launches. Every array
// is genome/100-sized f64 (the scores, the fhat weights, smu and benefit:
// 48 B a row and strand), so the work is a few passes over tens of MB at a
// chromosome and a few MB at a bacterial genome, where one memset and five
// launches are most of the time. Two dependent chains cannot be split: the
// exclusive prefix over the 4096-row tile totals (sequential, so that
// tile-aligned shards equal the single engine bit for bit) and the running
// sums of the 192-bin threshold scan; both run in one thread from shared
// memory, everything around them in parallel.
//
// Design (single path: one memset of two tickets, five launches):
//   1. scan_tiles: the f64 cumsum of scores_ds tile by tile (1024 threads x
//      4 items, warp shuffles, one block per tile and barcode), the tile
//      totals out; block (0, 0) zeroes the reduction scalars and bins the
//      later launches add into. The last block to finish (a ticket after a
//      fence) turns the totals into their exclusive prefix, sequentially in
//      tile order from shared memory;
//   2. scan_add: each tile's prefix added to its rows (2-D grid, barcodes
//      on y: no division per element);
//   3. benefit_windows: the ten CCL windows from the device's approx_ccl
//      (clip(approx_ccl // 100, 1, win_clamp), models/runs.py:674 of the
//      JAX package), then a block stages the cumsum under 1024 rows and the
//      widest window on either side in shared memory (coalesced), then one
//      thread per row reads the 22 clamped windows from there, runs the
//      weighted chain unrolled in the reference order
//      (genome_ops.py:121-128), writes smu and benefit, and contributes to
//      the global max (integer atomicMax on the bits of non-negative
//      doubles: exact), any-nonzero and ubar0 (sum of f32-rounded products:
//      exact in any order by the F4 contract);
//   4. bin_benefit: |frexp exponent| of benefit / max read from the f64
//      exponent bits of __ddiv_rn's quotient (exact), int32 counts and the
//      fsum of the f32-rounded fhat weights. A benefit that is the same over
//      most of the genome (an uncovered chromosome) puts nearly every
//      element into one bin, where the shared-memory f64 add is a
//      compare-and-swap loop; so each thread keeps a run per strand in
//      registers while the bin stays the same, a warp whose lanes hold one
//      bin adds one warp sum, and the block adds its non-empty bins once.
//      Counts are integers and fsum sums f32-rounded weights: exact however
//      grouped (F4). The last block runs the threshold scan: the per-bin
//      divisions in parallel, the running sums and the first-maximum pick
//      in bin order (bk_exponent_threshold);
//   5. strat_write: the gated strategy write.
// The step's parameters (approx_ccl, time_cost) are read through pointers
// from the device, as the JAX engine traces its StepParams, so one captured
// graph serves every batch; only win_cap, the shared memory's bound on the
// windows, is a launch argument. The threshold scan's tc = time_cost // 100
// is Python's float floor division, in f64 on the device.
// f64 arithmetic on the decision path uses the _rn intrinsics so nvcc
// cannot contract it into FMAs the reference does not do.
//
// RunsConfig.benefit_dtype: every kernel is a template on the decision
// type T (scores_ds, fhat_exp, the cumsum and its tile totals, smu,
// benefit, the bins' terms, the threshold scan and the threshold: double
// by default, float for the f32 decision path; bk_benefit_strategy_d32 and
// bk_shard_benefit_d32). The f32 path reads its exponent bins from the f32
// bits of benefit / max (subnormal -> the top bin, as the JAX package's
// frexp_abs_exponent). Its ubar0 and the bins' fhat sums still accumulate
// in f64 (f32 summands, exact in any order) and are rounded to f32 once at
// the scan; the norm is kept as f64 bits (a widened f32, exact). aux is in
// the score type, which aux_kind names (0 float, 1 double, 2 half: the
// threshold rounds to half once, from double with __double2half, as the
// JAX engine's astype and the plain version's round_to).
//
// H8, part 3: bk_shard_benefit runs the same kernels for one shard of the
// sharded step (bossruns_tpu/parallel/mesh.py:338-407, K11), one phase per
// call, with the collectives in between:
//   phase 0: scan_tiles over the shard's rows, zeroing the scalars (the
//            tile totals are then all-gathered over the genome axis, in
//            global tile order);
//   phase 1: the sequential prefix over the gathered totals (replicated)
//            and scan_add of the shard's own tile prefixes: when the shard
//            bounds fall on 4096-row tiles, the cumsum is bit-identical to
//            the single-device scan (then [nb, halo] halos are exchanged
//            with the neighbours and concatenated around it);
//   phase 2: benefit_windows, reading the halo-extended cumsum at global
//            rows (the max, any-nonzero and ubar0 are then reduced over
//            both axes);
//   phase 3: bin_benefit with the global norm, without the threshold
//            (counts, fsum and ubar0 are summed over both axes);
//   phase 4: threshold_scan (replicated, one block) and the shard's
//            strat_write.
#include <cuda_fp16.h>
#include <math.h>

#include "common.cuh"

struct StratArgs {
    int64_t nb, Gd, nbk;
    int32_t mu_ds, quirks;
    // the CCL windows are clamp(approx_ccl // 100, 1, win_clamp) rows, read
    // on the device; benefit_windows' shared memory holds windows of up to
    // win_cap rows (>= mu_ds and every window: the host's bound)
    int32_t win_clamp, win_cap;
    double weight[10];
    int32_t aux_kind, pad0;  // aux's score type: 0 float, 1 double, 2 half
    // the step's parameters on the device (StepParams)
    const int32_t* approx_ccl;  // [10] full-resolution CCL pieces
    const float* time_cost;     // lambda - mu - rho
    // inputs (T: the decision type)
    const void* scores_ds;  // T
    const int32_t* seg_start;
    const int32_t* seg_end;
    const void* fhat_exp;  // T
    const uint8_t* bucket_on;
    const int32_t* bucket_idx;
    const uint8_t* strat_valid;
    // state, updated in place; aux[0] (any_on) in, aux[1], aux[2] out
    uint8_t* strat;
    void* aux;
    // outputs
    void* smu;        // T
    void* benefit;    // T
    void* threshold;  // T
    // scratch
    void* cs;         // T
    void* tile_sums;  // T
    unsigned long long* norm_bits;
    int32_t* any_nz;
    int32_t* counts;
    double* fsum;
    double* ubar0;
    // the cumsum that benefit_windows reads: ext + b*cs_stride + halo is
    // the value at global row row0 (unsharded: ext = cs, no halo, row0 0)
    int64_t row0, halo, cs_stride;
    // tile totals whose exclusive prefix scan_add adds: n_tiles_g per
    // barcode row, this array's tiles starting at tile0 (unsharded:
    // tile_sums itself)
    int64_t n_tiles_g, tile0;
    const void* ext;  // T
    void* tiles_g;    // T
    // [2] zeroed before the single path's launches: the scan's and the
    // binning's last-block tickets (unused by the shard phases)
    unsigned int* tickets;
};

namespace {

constexpr int NBINS = 192;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int TILE_SHIFT = 12;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;
static_assert(TILE == 1 << TILE_SHIFT, "tile rows");
constexpr int THREADS = 256;
constexpr int CHAIN = 2048;  // tile totals staged in shared memory per pass
constexpr int WIN_ROWS = 1024;  // rows of a benefit_windows block per pass
constexpr int BIN_ROWS = 4;     // rows of a bin_benefit thread per pass
constexpr int MAX_WINDOW = 12000;  // windows (rows) whose staged cumsum fits in shared memory
constexpr unsigned FULL = 0xffffffffu;

// Blocks of a 2-D launch over Gd rows (x) and nb barcodes (y): enough to
// fill the card a few times, never more than the rows need.
static inline dim3 grid_rows(int64_t Gd, int64_t nb, int64_t max_blocks) {
    int64_t x = (Gd + THREADS - 1) / THREADS;
    int64_t cap = max_blocks / nb > 1 ? max_blocks / nb : 1;
    return dim3((unsigned)(x < 1 ? 1 : (x < cap ? x : cap)), (unsigned)nb);
}

// Python's floor division of an integer by 100 (the ds rows of a CCL piece)
__device__ __forceinline__ int64_t floordiv_ds(int64_t c) {
    int64_t q = c / 100;
    return (c % 100 != 0 && c < 0) ? q - 1 : q;
}

// CCL window k in ds rows: clamp(approx_ccl[k] // 100, 1, win_clamp)
__device__ __forceinline__ int ccl_window(const StratArgs& a, int k) {
    int64_t w = floordiv_ds(a.approx_ccl[k]);
    w = w < 1 ? 1 : w;
    return (int)(w > a.win_clamp ? a.win_clamp : w);
}

// Python's float floor division v // w (CPython's float_floor_div, as
// torch's div_floor_floating): tc = time_cost // 100 in f64
__device__ __forceinline__ double py_floordiv(double v, double w) {
    double mod = fmod(v, w);
    double div = __ddiv_rn(__dsub_rn(v, mod), w);
    if (mod != 0.0 && ((w < 0.0) != (mod < 0.0))) div = __dsub_rn(div, 1.0);
    if (div == 0.0) return copysign(0.0, __ddiv_rn(v, w));
    double fl = floor(div);
    return __dsub_rn(div, fl) > 0.5 ? __dadd_rn(fl, 1.0) : fl;
}

// aux[i] != 0, in aux's score type
__device__ __forceinline__ bool aux_nonzero(const StratArgs& a, int i) {
    if (a.aux_kind == 2) return __half2float(static_cast<const __half*>(a.aux)[i]) != 0.f;
    return a.aux_kind ? static_cast<const double*>(a.aux)[i] != 0.0
                      : static_cast<const float*>(a.aux)[i] != 0.f;
}

__device__ __forceinline__ bool aux_on(const StratArgs& a) { return aux_nonzero(a, 0); }

__device__ __forceinline__ __half to_half(double v) { return __double2half(v); }
__device__ __forceinline__ __half to_half(float v) { return __float2half_rn(v); }

template <class T>
__device__ __forceinline__ void aux_set(const StratArgs& a, int i, T v) {
    if (a.aux_kind == 2)
        static_cast<__half*>(a.aux)[i] = to_half(v);
    else if (a.aux_kind)
        static_cast<double*>(a.aux)[i] = (double)v;
    else
        static_cast<float*>(a.aux)[i] = (float)v;
}

// Exclusive prefix of tiles[0, n) in place, sequentially in tile order
// (run += s, as a one-thread loop would), staged through shared memory by
// the whole block; thread 0 runs the chain.
template <class T>
__device__ void tile_prefix(T* tiles, int64_t n, T* s_buf) {
    T run = 0;
    for (int64_t c0 = 0; c0 < n; c0 += CHAIN) {
        int m = (int)(n - c0 < CHAIN ? n - c0 : CHAIN);
        for (int i = threadIdx.x; i < m; i += blockDim.x) s_buf[i] = __ldcg(tiles + c0 + i);
        __syncthreads();
        if (threadIdx.x == 0) run = bk_chain_sum<true>(s_buf, m, run);
        __syncthreads();
        for (int i = threadIdx.x; i < m; i += blockDim.x) tiles[c0 + i] = s_buf[i];
        __syncthreads();
    }
}

// 1. tile-local inclusive prefix sums into cs[b, 1 + i], tile totals out;
// block (0, 0) zeroes the scalars; with `chain`, the last block turns the
// totals into their exclusive prefix and sets cs[b, 0]
template <class T>
__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles(StratArgs a, int64_t n_tiles, int chain) {
    __shared__ T s_warp[32];
    __shared__ __align__(16) T s_buf[CHAIN];
    __shared__ int s_last;
    const int64_t b = blockIdx.y, t = blockIdx.x;
    T* tile_sums = static_cast<T*>(a.tile_sums);
    if (b == 0 && t == 0) {
        for (int k = threadIdx.x; k < NBINS; k += SCAN_THREADS) {
            a.counts[k] = 0;
            a.fsum[k] = 0.0;
        }
        if (threadIdx.x == 0) {
            *a.norm_bits = 0ull;
            *a.any_nz = 0;
            *a.ubar0 = 0.0;
        }
    }
    const T* x = static_cast<const T*>(a.scores_ds) + b * a.Gd;
    T* cs = static_cast<T*>(a.cs) + b * (a.Gd + 1);
    int64_t base = t * TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
    T p[SCAN_ITEMS];
    T run = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        T v = base + k < a.Gd ? x[base + k] : (T)0;
        run = k == 0 ? v : run + v;
        p[k] = run;
    }
    // block exclusive scan of the per-thread totals (exclusive prefixes are
    // taken from the neighbour's inclusive one, never by subtraction)
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        T y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    T excl_lane = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl_lane = 0;
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        T wi = s_warp[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            T y = __shfl_up_sync(FULL, wi, o);
            if (lane >= o) wi += y;
        }
        T we = __shfl_up_sync(FULL, wi, 1);
        __syncwarp();
        s_warp[lane] = lane == 0 ? (T)0 : we;  // exclusive prefix of warp totals
    }
    __syncthreads();
    T excl = s_warp[warp] + excl_lane;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k)
        if (base + k < a.Gd) cs[1 + base + k] = excl + p[k];
    if (!chain) {
        if (threadIdx.x == SCAN_THREADS - 1) tile_sums[b * n_tiles + t] = excl + run;
        return;
    }
    if (threadIdx.x == SCAN_THREADS - 1) {
        tile_sums[b * n_tiles + t] = excl + run;
        __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(a.tickets, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int64_t bb = 0; bb < a.nb; ++bb) {
        tile_prefix(tile_sums + bb * n_tiles, n_tiles, s_buf);
        if (threadIdx.x == 0) static_cast<T*>(a.cs)[bb * (a.Gd + 1)] = tile_sums[bb * n_tiles];
    }
}

// 1b. (shard phase 1) exclusive prefix over the gathered tile totals, one
// block per barcode; cs[b, 0] takes the prefix of this shard's first tile
template <class T>
__global__ void __launch_bounds__(THREADS) scan_tile_prefix(StratArgs a, T* tiles, int64_t n_tiles,
                                                            int64_t tile0) {
    __shared__ __align__(16) T s_buf[CHAIN];
    int64_t b = blockIdx.x;
    tile_prefix(tiles + b * n_tiles, n_tiles, s_buf);
    if (threadIdx.x == 0) static_cast<T*>(a.cs)[b * (a.Gd + 1)] = tiles[b * n_tiles + tile0];
}

// 2. add each tile's prefix to its rows (the first global tile's is zero
// and is not added)
template <class T>
__global__ void __launch_bounds__(THREADS) scan_add(StratArgs a, const T* tiles, int64_t n_tiles,
                                                    int64_t tile0) {
    const int64_t b = blockIdx.y;
    T* cs = static_cast<T*>(a.cs) + b * (a.Gd + 1) + 1;
    const T* pre = tiles + b * n_tiles + tile0;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t r = (tile0 == 0 ? TILE : 0) + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         r < a.Gd; r += stride)
        cs[r] += pre[r >> TILE_SHIFT];
}

// 3. windows, weighted chain, benefit; max, any-nonzero and ubar0. A block
// takes WIN_ROWS rows at a time and stages the cumsum they read, rows
// [rg0 - W, rg0 + WIN_ROWS + W] for windows of at most W rows, in shared
// memory with coalesced loads: every window read is then a shared-memory
// read (the 22 reads of a row land within W rows of it, and a segment
// bound clamps them inward).
template <class T>
__global__ void __launch_bounds__(THREADS) benefit_windows(StratArgs a) {
    using T2 = typename BkVec2<T>::type;
    extern __shared__ __align__(16) unsigned char s_raw[];
    T* s_c = reinterpret_cast<T*>(s_raw);
    __shared__ double s_red[32];
    __shared__ int s_win[10];
    // the host's win_cap holds every window; the min only keeps a wrong
    // bound inside the staged rows
    if (threadIdx.x < 10) s_win[threadIdx.x] = min(ccl_window(a, threadIdx.x), a.win_cap);
    __syncthreads();
    // each thread keeps the windows in registers (the row loop below reads
    // them 20 times a row); W, the widest, sets the rows staged either side
    int win[10], W = a.mu_ds;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
        win[k] = s_win[k];
        W = win[k] > W ? win[k] : W;
    }
    const int64_t b = blockIdx.y;
    // c[k]: the cumsum at global row k, defined for k in [row0 - halo, row0 + Gd + halo]
    const T* c = static_cast<const T*>(a.ext) + b * a.cs_stride + a.halo - a.row0;
    const int64_t k_lo = a.row0 - a.halo, k_hi = a.row0 + a.Gd + a.halo;
    const int n_stage = WIN_ROWS + 2 * W + 1;
    double u0 = 0.0;
    T vmax = 0;
    bool nz = false;
    for (int64_t r0 = (int64_t)blockIdx.x * WIN_ROWS; r0 < a.Gd; r0 += (int64_t)gridDim.x * WIN_ROWS) {
        const int64_t g0 = a.row0 + r0 - W;  // the global row of s_c[0]
        __syncthreads();
        for (int i = threadIdx.x; i < n_stage; i += THREADS) {
            int64_t k = g0 + i;
            s_c[i] = k >= k_lo && k <= k_hi ? c[k] : (T)0;
        }
        __syncthreads();
        const T* sc = s_c - g0;
        for (int j = threadIdx.x; j < WIN_ROWS && r0 + j < a.Gd; j += THREADS) {
            const int64_t r = r0 + j, i = b * a.Gd + r, rg = a.row0 + r;
            const int64_t se = a.seg_end[r], ss = a.seg_start[r];
            const T cr = sc[rg], cr1 = sc[rg + 1];
            auto fwd = [&](int64_t w) {
                int64_t hi = rg + w < se ? rg + w : se;
                return bk_sub(sc[hi], cr);
            };
            auto rev = [&](int64_t w) {
                int64_t lo = rg + 1 - w > ss ? rg + 1 - w : ss;
                return bk_sub(cr1, sc[lo]);
            };
            T sf = fwd(a.mu_ds), sr = rev(a.mu_ds);
            T ef = bk_mul((T)a.weight[0], fwd(win[0]));
            T er = bk_mul((T)a.weight[0], rev(win[0]));
#pragma unroll
            for (int k = 1; k < 10; ++k) {
                ef = bk_add(ef, bk_mul((T)a.weight[k], fwd(win[k])));
                er = bk_add(er, bk_mul((T)a.weight[k], rev(win[k])));
            }
            T bf = bk_sub(ef, sf), br = bk_sub(er, sr);
            bf = bf > (T)0 ? bf : (T)0;
            br = br > (T)0 ? br : (T)0;
            static_cast<T2*>(a.smu)[i] = T2{sf, sr};
            static_cast<T2*>(a.benefit)[i] = T2{bf, br};
            nz |= bf > (T)0 || br > (T)0;
            vmax = bk_max(vmax, bk_max(bf, br));
            T2 f = static_cast<const T2*>(a.fhat_exp)[r];
            T q0 = a.quirks ? bf : sf, q1 = a.quirks ? br : sr;
            u0 += (double)(float)bk_mul(f.x, q0);
            u0 += (double)(float)bk_mul(f.y, q1);
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = bk_max(vmax, __shfl_down_sync(FULL, vmax, o));
    if ((threadIdx.x & 31) == 0 && vmax > (T)0)
        atomicMax(a.norm_bits, (unsigned long long)__double_as_longlong((double)vmax));
    if (__syncthreads_or(nz) && threadIdx.x == 0) atomicExch(a.any_nz, 1);
    u0 = bk_block_sum(u0, s_red);
    if (threadIdx.x == 0 && u0 != 0.0) atomicAdd(a.ubar0, u0);
}

// The threshold scan (threshold_from_bins) over the summed bins cnt/fs by
// the whole block (at least NBINS threads), in T: each bin's mean weight
// and terms in its own thread (fs, ubar0 and the norm rounded to T), the
// scan in bk_exponent_threshold; thread 0 writes the threshold and aux.
template <class T>
__device__ void threshold_from_bins(const StratArgs& a, const int* cnt, const double* fs,
                                    BkThresholdScratch<NBINS, T>& sh) {
    const int t = threadIdx.x;
    const T norm = (T)__longlong_as_double(__ldcg(reinterpret_cast<const long long*>(a.norm_bits)));
    const T norm_safe = norm > (T)0 ? norm : (T)1;
    const bool used = t < NBINS && cnt[t] > 0;
    T tu = 0, tt = 0;
    if (used) {
        const T c = (T)cnt[t], f_mean = bk_div((T)fs[t], c);
        tu = bk_mul(bk_mul(bk_mul((T)bk_pow2_neg(t), norm_safe), f_mean), c);
        const double tc = py_floordiv((double)*a.time_cost, 100.0);
        tt = bk_mul(bk_mul((T)tc, c), f_mean);
    }
    // tbar0: alpha + rho + mu in 100-site rows, 3 + 3 + 4
    int k = bk_exponent_threshold<NBINS, T>(used, tu, tt, (T)__ldcg(a.ubar0), (T)10, sh);
    if (t != 0) return;
    T thr = bk_mul((T)bk_pow2_neg(k < 0 ? 0 : k), norm_safe);
    bool update = aux_on(a) && __ldcg(a.any_nz) != 0;
    *static_cast<T*>(a.threshold) = thr;
    aux_set(a, 1, update ? 1.f : 0.f);
    aux_set(a, 2, thr);
}

// |numpy.frexp exponent| of v / norm for v > 0, clamped to the top bin,
// from the exponent bits of the quotient in T (biased 0: zero or
// subnormal, the top bin)
__device__ __forceinline__ int exponent_bin(double v, double norm_safe) {
    double x = __ddiv_rn(v, norm_safe);
    int biased = (int)((__double_as_longlong(x) >> 52) & 0x7FF);
    return biased == 0 ? NBINS - 1 : min(abs(biased - 1022), NBINS - 1);
}

__device__ __forceinline__ int exponent_bin(float v, float norm_safe) {
    float x = __fdiv_rn(v, norm_safe);
    int biased = (__float_as_int(x) >> 23) & 0xFF;
    return biased == 0 ? NBINS - 1 : min(abs(biased - 126), NBINS - 1);
}

// One thread's run of equal bins: extended while the bin stays, flushed
// into the block's shared bins when it changes
struct BinRun {
    int bin = -1, cnt = 0;
    double fs = 0.0;
    __device__ __forceinline__ void add(int k, double f, int* s_cnt, double* s_fs) {
        if (k != bin) {
            if (cnt) {
                atomicAdd(s_cnt + bin, cnt);
                atomicAdd(s_fs + bin, fs);
            }
            bin = k;
            cnt = 0;
            fs = 0.0;
        }
        ++cnt;
        fs += f;
    }
    // the warp's open runs (every lane of the warp calls this): where all
    // lanes hold the same bin, one warp sum and one lane's add; else the
    // lanes of each bin merge theirs (__match_any_sync) first
    __device__ __forceinline__ void flush_warp(int* s_cnt, double* s_fs) {
        const int key = cnt ? bin : -1;
        const int k0 = __shfl_sync(FULL, key, 0);
        if (__all_sync(FULL, key == k0)) {
            if (k0 < 0) return;
            int c = cnt;
            double f = fs;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                c += __shfl_down_sync(FULL, c, o);
                f += __shfl_down_sync(FULL, f, o);
            }
            if ((threadIdx.x & 31) == 0) {
                atomicAdd(s_cnt + k0, c);
                atomicAdd(s_fs + k0, f);
            }
        } else {  // lanes with the same bin add into the lowest one's
            const unsigned peers = __match_any_sync(FULL, key);
            int c = 0;
            double f = 0.0;
            for (int j = 0; j < 32; ++j) {
                const int cj = __shfl_sync(FULL, cnt, j);
                const double fj = __shfl_sync(FULL, fs, j);
                if ((peers >> j) & 1u) {
                    c += cj;
                    f += fj;
                }
            }
            if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
                atomicAdd(s_cnt + key, c);
                atomicAdd(s_fs + key, f);
            }
        }
    }
};

// 4. exponent-bin histogram of benefit / norm; with `fuse`, the last block
// runs the threshold scan
template <class T>
__global__ void __launch_bounds__(THREADS) bin_benefit(StratArgs a, int fuse) {
    using T2 = typename BkVec2<T>::type;
    __shared__ int s_cnt[NBINS];
    __shared__ double s_fs[NBINS];
    __shared__ int s_last;
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) {
        s_cnt[k] = 0;
        s_fs[k] = 0.0;
    }
    __syncthreads();
    const T norm = (T)__longlong_as_double((long long)*a.norm_bits);
    const T norm_safe = norm > (T)0 ? norm : (T)1;
    const int64_t b = blockIdx.y;
    const T2* ben = static_cast<const T2*>(a.benefit) + b * a.Gd;
    const T2* fh = static_cast<const T2*>(a.fhat_exp);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    BinRun fw, rv;  // one run per strand
    // BIN_ROWS rows a thread per pass, their loads issued together
    for (int64_t r0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r0 < a.Gd; r0 += stride * BIN_ROWS) {
        T2 v[BIN_ROWS], f[BIN_ROWS];
#pragma unroll
        for (int j = 0; j < BIN_ROWS; ++j) {
            const int64_t r = r0 + j * stride;
            v[j] = r < a.Gd ? ben[r] : T2{0, 0};
            f[j] = r < a.Gd ? fh[r] : T2{0, 0};
        }
#pragma unroll
        for (int j = 0; j < BIN_ROWS; ++j) {
            if (v[j].x > (T)0) fw.add(exponent_bin(v[j].x, norm_safe), (double)f[j].x, s_cnt, s_fs);
            if (v[j].y > (T)0) rv.add(exponent_bin(v[j].y, norm_safe), (double)f[j].y, s_cnt, s_fs);
        }
    }
    fw.flush_warp(s_cnt, s_fs);
    rv.flush_warp(s_cnt, s_fs);
    __syncthreads();
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) {
        if (s_cnt[k]) {
            atomicAdd(a.counts + k, s_cnt[k]);
            atomicAdd(a.fsum + k, s_fs[k]);
        }
    }
    if (!fuse) return;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(a.tickets + 1, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    __shared__ BkThresholdScratch<NBINS, T> sh;
    for (int k = threadIdx.x; k < NBINS; k += blockDim.x) {
        s_cnt[k] = __ldcg(a.counts + k);
        s_fs[k] = __ldcg(a.fsum + k);
    }
    __syncthreads();
    threshold_from_bins<T>(a, s_cnt, s_fs, sh);
}

// 4b. (shard phase 4) the threshold scan over the reduced bins, staged in
// shared memory by NBINS threads
template <class T>
__global__ void __launch_bounds__(NBINS) threshold_scan(StratArgs a) {
    __shared__ int s_cnt[NBINS];
    __shared__ double s_fs[NBINS];
    __shared__ BkThresholdScratch<NBINS, T> sh;
    s_cnt[threadIdx.x] = a.counts[threadIdx.x];
    s_fs[threadIdx.x] = a.fsum[threadIdx.x];
    __syncthreads();
    threshold_from_bins<T>(a, s_cnt, s_fs, sh);
}

// 5. gated strategy write
template <class T>
__global__ void __launch_bounds__(THREADS) strat_write(StratArgs a) {
    using T2 = typename BkVec2<T>::type;
    if (!aux_nonzero(a, 1)) return;
    const T thr = *static_cast<const T*>(a.threshold);
    const int64_t b = blockIdx.y;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < a.Gd; r += stride) {
        int32_t bi = a.bucket_idx[r];
        if (!a.strat_valid[r] || bi < 0 || !a.bucket_on[b * a.nbk + bi]) continue;
        const int64_t i = b * a.Gd + r;
        T2 v = static_cast<const T2*>(a.benefit)[i];
        reinterpret_cast<uchar2*>(a.strat)[i] = make_uchar2(v.x >= thr ? 1 : 0, v.y >= thr ? 1 : 0);
    }
}

// benefit_windows over the rows: the grid, and shared memory for the
// staged cumsum of windows up to win_cap rows (a bound the host knows, so
// the launch does not depend on the device's window values). The opt-in
// above 48 KB is made once per device for the largest window, outside any
// graph capture: the first launch of a step runs eagerly.
template <class T>
int opt_in_windows_smem() {
    static bool done[64] = {};
    int dev = 0;
    BK_CHECK(cudaGetDevice(&dev));
    if (dev < 0 || dev >= 64) return -1;
    if (!done[dev]) {
        BK_CHECK(cudaFuncSetAttribute(benefit_windows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)(sizeof(T) * (WIN_ROWS + 2 * (size_t)MAX_WINDOW + 1))));
        done[dev] = true;
    }
    return 0;
}

template <class T>
int launch_windows(const StratArgs& a, cudaStream_t st) {
    if (a.win_cap < 1 || a.win_cap > MAX_WINDOW || a.mu_ds > a.win_cap || a.win_clamp < 1)
        return -1;
    if (int err = opt_in_windows_smem<T>()) return err;
    size_t smem = sizeof(T) * (WIN_ROWS + 2 * (size_t)a.win_cap + 1);
    int64_t x = (a.Gd + WIN_ROWS - 1) / WIN_ROWS, cap = 132 * 8 / a.nb > 1 ? 132 * 8 / a.nb : 1;
    benefit_windows<T><<<dim3((unsigned)(x < cap ? x : cap), (unsigned)a.nb), THREADS, smem, st>>>(a);
    BK_LAUNCHED();
    return 0;
}

template <class T>
int benefit_strategy(const StratArgs* args, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    StratArgs a = *args;
    int64_t n_tiles = (a.Gd + TILE - 1) / TILE;
    if (a.nb < 1 || a.nb > 65535 || a.Gd < 1) return -1;
    dim3 grid = grid_rows(a.Gd, a.nb, 132 * 32);
    BK_CHECK(cudaMemsetAsync(a.tickets, 0, 2 * sizeof(unsigned int), st));
    scan_tiles<T><<<dim3((unsigned)n_tiles, (unsigned)a.nb), SCAN_THREADS, 0, st>>>(a, n_tiles, 1);
    BK_LAUNCHED();
    if (n_tiles > 1) {
        scan_add<T><<<grid, THREADS, 0, st>>>(a, static_cast<const T*>(a.tile_sums), n_tiles, 0);
        BK_LAUNCHED();
    }
    if (int err = launch_windows<T>(a, st)) return err;
    bin_benefit<T><<<grid_rows(a.Gd, a.nb, 132 * 8), THREADS, 0, st>>>(a, 1);
    BK_LAUNCHED();
    strat_write<T><<<grid, THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}

template <class T>
int shard_benefit(const StratArgs* args, int phase, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    StratArgs a = *args;
    int64_t n_tiles = (a.Gd + TILE - 1) / TILE;
    if (a.nb < 1 || a.nb > 65535 || a.Gd < 1) return -1;
    dim3 grid = grid_rows(a.Gd, a.nb, 132 * 32);
    T* tiles = static_cast<T*>(a.tiles_g);
    switch (phase) {
        case 0:
            scan_tiles<T><<<dim3((unsigned)n_tiles, (unsigned)a.nb), SCAN_THREADS, 0, st>>>(a, n_tiles, 0);
            break;
        case 1:
            if (a.tile0 < 0 || a.tile0 + n_tiles > a.n_tiles_g) return -1;
            scan_tile_prefix<T><<<(unsigned)a.nb, THREADS, 0, st>>>(a, tiles, a.n_tiles_g, a.tile0);
            BK_LAUNCHED();
            scan_add<T><<<grid, THREADS, 0, st>>>(a, tiles, a.n_tiles_g, a.tile0);
            break;
        case 2:
            return launch_windows<T>(a, st);
        case 3:
            bin_benefit<T><<<grid_rows(a.Gd, a.nb, 132 * 8), THREADS, 0, st>>>(a, 0);
            break;
        case 4:
            threshold_scan<T><<<1, NBINS, 0, st>>>(a);
            BK_LAUNCHED();
            strat_write<T><<<grid, THREADS, 0, st>>>(a);
            break;
        default:
            return -1;
    }
    BK_LAUNCHED();
    return 0;
}

}  // namespace

// the f64 decision path (the default) and the f32 one (_d32)
BK_API int bk_benefit_strategy(const StratArgs* a, void* st) { return benefit_strategy<double>(a, st); }
BK_API int bk_benefit_strategy_d32(const StratArgs* a, void* st) { return benefit_strategy<float>(a, st); }

BK_API int bk_shard_benefit(const StratArgs* a, int phase, void* st) {
    return shard_benefit<double>(a, phase, st);
}
BK_API int bk_shard_benefit_d32(const StratArgs* a, int phase, void* st) {
    return shard_benefit<float>(a, phase, st);
}
