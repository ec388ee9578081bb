// H3 row_stage — dropout, buckets and the read-start posterior, per ds row.
//
// Replaces: bossruns_tpu/models/runs.py:592-636 (RunsEngine._step stages 2-3:
// the 100-site covsum sums, per-contig mean, dropout threshold, any-barcode
// low test, sticky zeroing, the 200-row bucket windows and the sticky
// bucket switches) and runs.py:638-663 with ops/genome_ops.py:38-39
// (scatter_add_2d) and :134-159 (fhat_pointmass): the read-start scatter,
// the point-mass posterior, its window normaliser and the f32-rounded
// per-row weights.
//
// Bound on the H100: device-memory bytes of the [nb, G] arrays it streams
// (covsum 4 B read twice, scores 4 B read and masked in place, zeroed 1 B,
// plus 2 B of per-site constants); the Wf- and NBk-sized tables are small.
// Design: every launch is a stream of independent 16-byte loads:
//   sums     row_sums: a warp sums a ds row with one int4 load per lane
//            (25 lanes), eight rows per warp in flight, 64 rows per block;
//            the block's contig and window ids are staged in shared memory
//            and thread 0 flushes per-contig, per-window and total sums with
//            integer atomics, one per run of equal ids (ids are sorted);
//   tables   three grid-wide launches: row_tables (per-contig dropout
//            table, bucket switches with a warp-aggregated any flag, the
//            read-start scatter; integer-valued f32 weights, so atomics are
//            exact), row_csum (the sum of the read-start counts: integers,
//            exact in any order) and row_posterior (the point-mass
//            posterior, each block summing a fixed 256-entry chunk of the
//            normaliser into its slot, the last block to finish adding the
//            slots in block order: the order depends only on Wf and the block
//            size, so every shard and the single engine get the same scale
//            bit for bit; the normaliser sums non-integers and must not use
//            atomics);
//   apply    row_apply: a block takes 32 ds rows (3200 sites) as 800
//            aligned quads of four sites, reads each row's dropout
//            threshold once into shared memory, masks the scores in place
//            (written back only where a quad zeroes a site), and sums each
//            row's masked scores from shared memory in f64 in the order of
//            the original warp-per-row kernel (lane partials over 32-site
//            strides, then the warp tree), so scores_ds is unchanged bit for
//            bit; it also writes the f32-rounded fhat weights of its rows.
// f64 arithmetic on the decision path uses the _rn intrinsics so nvcc
// cannot contract it into FMAs the reference does not do. The wrappers
// check the 16-byte alignment the quads need (G % 4 == 0, aligned bases).
//
// The engine options (RunsConfig.dtype, .benefit_dtype, .fhat_alpha): every
// kernel is a template on the score type S (scores, read_starts, aux, the
// dropout table: float or double) and the decision type D (contig_denom,
// fhat_rows, the bucket and contig means before their rounding to S, the
// fhat weights, the normaliser, scores_ds, fhat_exp: double or float), one
// entry point per pair (bk_row_stage is <float, double>, the default;
// _s64 takes double scores, _d32 float decisions). Coverage sums stay
// exact integers and are rounded to D once; the read-start total is an
// exact f64 sum rounded to D; the normaliser adds D products in f64 in the
// fixed block order and is rounded to D once. A general fhat_alpha
// (alpha_one == 0) takes the point mass's beta function as
// exp(lgamma(a) + (lgamma(b) - lgamma(a + b))) in f64, with b from the
// device-side read-start total (no host sync), over the host's f64
// B(alpha, (2n - 1) alpha) in beta_denom, as ops/genome_ops.fhat_pointmass.
//
// H8, part 2: bk_shard_rows runs the same kernels for one shard of the
// sharded step (bossruns_tpu/parallel/mesh.py:275-336, K11), one phase per
// call, so the caller can reduce across shards in between:
//   phase 0: row_sums over the shard's rows (per_contig and total are then
//            summed over both mesh axes, winsums over the genome axis);
//   phase 1: the table launches, replicated: the read-start scatter and the
//            fhat normaliser see identical inputs on every shard and give
//            identical results (aux[0], any bucket on, is then OR-ed over
//            the barcode axis);
//   phase 2: row_low, only with several barcode shards: the any-barcode
//            low test of row_apply as its own launch (quads of four sites),
//            a per-site mask that is OR-ed over the barcode axis
//            (mesh.py:296-297);
//   phase 3: row_apply, reading that mask when it is given.
//
// RunsConfig(dtype="float16") (bk_row_stage_h16, _h16_d32 and the
// bk_shard_rows_h16 pair): S is __half. The JAX engine sums the per-site
// coverage sums after rounding them to f16 (covsum.astype(dtype),
// runs.py:578), so row_sums adds each site's sum rounded to half, and a
// site above 65,519 (inf in half) sets INF_FLAG in the per-contig,
// per-window and total sums with an atomicOr beside the integer atomicAdd
// of the finite part, which stays below 2^49 and never carries into it;
// the tables read a flagged sum as inf, as XLA carries it (the contig
// mean inf or NaN, the bucket on). Means and the aux entries round to
// half once with __double2half (__float2half_rn from float), the dropout
// threshold divides and floors in half, a bucket mean is compared with the
// f32 threshold exactly, and the low test compares each site's sum rounded
// to half. The read-start adds are atomicAdd on __half: each add rounds,
// and the order of the adds does not matter only because every weight is
// 1.0 (or 0.0 in the gated flow), so each add is the same +1 and a count
// above 2048 stays where f16 rounding holds it, as in the JAX engine's
// scatter (F4 keeps every other sum that is not exact out of atomics).
// The float and double instantiations take the code they took before.
#include <cuda_fp16.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

struct RowArgs {
    int64_t nb, G, n_c1, nw_pad, nbk, n_bits, n_rs, wf;
    int32_t freeze_cov, gated;
    int32_t alpha_one, pad0;  // alpha_one: fhat_alpha == 1 (B(1, z) = 1/z)
    // in f64; each is rounded to S or D where the reference compares or divides
    double dropout_mod, dropout_min_mean;
    double c_denom0, c_bn0, beta_denom, p0_bit, alpha, on_target, n_real_sites;
    // inputs
    const int32_t* covsum;
    const uint8_t* changed;
    const uint8_t* site_valid;
    const int32_t* contig_id_ds;
    const void* contig_denom;  // D
    const int32_t* win_id_ds;
    const int32_t* bucket_src;
    const uint8_t* bucket_valid;
    const int32_t* rs_row;
    const int32_t* rs_strand;
    const float* rs_w;
    const int32_t* rs_read;
    const uint8_t* bits;
    const uint8_t* fhat_valid;
    const void* fhat_rows;  // D
    const int32_t* fhat_idx;
    const float* bucket_threshold;  // the step's parameter on the device (StepParams)
    // state, updated in place
    void* scores;  // S
    uint8_t* zeroed;
    uint8_t* bucket_on;
    void* read_starts;  // S
    // outputs
    void* scores_ds;  // D
    void* fhat_exp;   // D
    void* aux;        // S
    // scratch
    unsigned long long* per_contig;
    unsigned long long* winsums;
    unsigned long long* total;
    void* thr_c;  // S
    uint8_t* active_c;
    void* fhat_w;  // D
    void* scale;   // D
    // per-site any-barcode low mask [G]: written by row_low, read by
    // row_apply in place of its own test when not null
    uint8_t* low;
    // the table launches' scratch: tab[0] the read-start total (f64 bits),
    // tab[1] any bucket on, tab[2] finished posterior blocks (zeroed
    // before the tables); slots[n_slots] the posterior blocks' partial sums
    unsigned long long* tab;
    double* slots;
    int64_t n_slots;
};

namespace {

constexpr int DS = 100;
constexpr int QD = DS / 4;           // quads of four sites per ds row
constexpr int SR = 64;               // ds rows per block of row_sums (8 per warp)
constexpr int TR = 32;               // ds rows per block of row_apply
constexpr int THREADS = 256;
constexpr int TAB_CHUNK = 256;       // normaliser entries per row_posterior block (one per thread)
// set in a coverage sum (per contig, per window, total) that a site's
// half-rounded sum of inf reached (ops/genome_ops.INF_FLAG)
constexpr unsigned long long INF_FLAG = 1ull << 56;

template <class S>
constexpr bool kHalf = std::is_same<S, __half>::value;

// The half score type's conversions and comparisons (S = __half only)
__device__ __forceinline__ __half h_of(double x) { return __double2half(x); }
__device__ __forceinline__ __half h_of(float x) { return __float2half_rn(x); }
__device__ __forceinline__ float f_of(__half x) { return __half2float(x); }
// a site's coverage sum as the JAX f16 engine holds it (inf above 65,519)
__device__ __forceinline__ float h_count(int c) { return __half2float(__int2half_rn(c)); }

// a summed coverage count in D: INF_FLAG reads as inf (half scores only)
template <class S, class D>
__device__ __forceinline__ D count_d(unsigned long long x) {
    if constexpr (kHalf<S>)
        return x >= INF_FLAG ? (D)INFINITY : (D)x;
    else
        return (D)x;
}

// an S value widened to D, exactly
template <class D, class S>
__device__ __forceinline__ D wide(S x) {
    if constexpr (kHalf<S>)
        return (D)__half2float(x);
    else
        return (D)x;
}

// a site's coverage sum at or below the dropout threshold, in S
template <class S>
__device__ __forceinline__ bool low_site(int c, S thr) {
    if constexpr (kHalf<S>)
        return h_count(c) <= f_of(thr);
    else
        return (S)c <= thr;
}

template <class S>
__global__ void __launch_bounds__(THREADS) row_sums(RowArgs a) {
    __shared__ long long s_row[SR];
    __shared__ int32_t s_c[SR], s_w[SR];
    __shared__ bool s_inf[SR];  // a site of the row is inf in half (half scores only)
    const int64_t Gd = a.G / DS, b = blockIdx.y, r0 = (int64_t)blockIdx.x * SR;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t < SR && r0 + t < Gd) {
        s_c[t] = a.contig_id_ds[r0 + t];
        s_w[t] = a.win_id_ds[r0 + t];
    }
    const int4* base = reinterpret_cast<const int4*>(a.covsum + b * a.G + r0 * DS);
    long long v[SR / 8];
    bool inf[SR / 8];
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) {
        int row = warp * (SR / 8) + i;
        v[i] = 0;
        inf[i] = false;
        if (lane < QD && r0 + row < Gd) {
            int4 x = base[row * QD + lane];
            if constexpr (kHalf<S>) {
                const float h[4] = {h_count(x.x), h_count(x.y), h_count(x.z), h_count(x.w)};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    inf[i] |= isinf(h[j]);
                    v[i] += isinf(h[j]) ? 0ll : (long long)h[j];
                }
            } else {
                v[i] = (long long)x.x + x.y + x.z + x.w;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) {
        long long s = bk_warp_sum(v[i]);
        if (lane == 0) s_row[warp * (SR / 8) + i] = s;
        if constexpr (kHalf<S>) {
            bool f = __any_sync(0xffffffffu, inf[i]);
            if (lane == 0) s_inf[warp * (SR / 8) + i] = f;
        }
    }
    __syncthreads();
    if (t != 0) return;
    long long tot = 0, acc_c = 0, acc_w = 0;
    bool inf_t = false, inf_c = false, inf_w = false;
    int32_t cur_c = -1, cur_w = -1;
    // the finite part with an integer add; an inf site's flag with an or
    auto flush = [](unsigned long long* p, long long acc, bool f) {
        if (acc) atomicAdd(p, (unsigned long long)acc);
        if (kHalf<S> && f) atomicOr(p, INF_FLAG);
    };
    for (int i = 0; i < SR && r0 + i < Gd; ++i) {
        long long rv = s_row[i];
        const bool ri = kHalf<S> && s_inf[i];
        tot += rv;
        inf_t |= ri;
        int32_t c = s_c[i];
        if (c != cur_c) {
            if (cur_c >= 0 && cur_c < a.n_c1) flush(a.per_contig + cur_c, acc_c, inf_c);
            cur_c = c;
            acc_c = 0;
            inf_c = false;
        }
        acc_c += rv;
        inf_c |= ri;
        int32_t w = s_w[i];
        if (w != cur_w) {
            if (cur_w >= 0 && cur_w < a.nw_pad) flush(a.winsums + b * a.nw_pad + cur_w, acc_w, inf_w);
            cur_w = w;
            acc_w = 0;
            inf_w = false;
        }
        acc_w += rv;
        inf_w |= ri;
    }
    if (cur_c >= 0 && cur_c < a.n_c1) flush(a.per_contig + cur_c, acc_c, inf_c);
    if (cur_w >= 0 && cur_w < a.nw_pad) flush(a.winsums + b * a.nw_pad + cur_w, acc_w, inf_w);
    flush(a.total, tot, inf_t);
}

// per-contig dropout table, sticky bucket switches, read-start scatter
template <class S, class D>
__global__ void row_tables(RowArgs a) {
    const int64_t n_bk = a.nb * a.nbk, n = a.n_c1 + n_bk + a.n_rs;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    int any = 0;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        if (i < a.n_c1) {  // in S, as the reference's contig_mean
            const D den = static_cast<const D*>(a.contig_denom)[i];
            if constexpr (kHalf<S>) {
                const float mean = f_of(h_of(bk_div(count_d<S, D>(a.per_contig[i]), den)));
                static_cast<S*>(a.thr_c)[i] =
                    h_of(floorf(f_of(h_of(__fdiv_rn(mean, f_of(h_of(a.dropout_mod)))))));
                a.active_c[i] = mean > f_of(h_of(a.dropout_min_mean)) ? 1 : 0;
            } else {
                S mean = (S)bk_div((D)a.per_contig[i], den);
                static_cast<S*>(a.thr_c)[i] = bk_floor(bk_div(mean, (S)a.dropout_mod));
                a.active_c[i] = mean > (S)a.dropout_min_mean ? 1 : 0;
            }
        } else if (i < a.n_c1 + n_bk) {
            int64_t k = i - a.n_c1, b = k / a.nbk, j = k - b * a.nbk;
            int32_t src = a.bucket_src[j];
            bool hit;
            if constexpr (kHalf<S>) {  // the half mean against the f32 threshold, exactly
                float mean = 0.f;
                if (src >= 0)
                    mean = f_of(h_of(bk_div(count_d<S, D>(a.winsums[b * a.nw_pad + src]), (D)20000)));
                hit = mean >= *a.bucket_threshold;
            } else {
                S mean = 0;
                if (src >= 0) mean = (S)bk_div((D)a.winsums[b * a.nw_pad + src], (D)20000);
                hit = mean >= (S)*a.bucket_threshold;
            }
            bool on = a.bucket_on[k] || (hit && a.bucket_valid[j]);
            a.bucket_on[k] = on ? 1 : 0;
            any |= on;
        } else {
            int64_t r = i - a.n_c1 - n_bk;
            float w;
            if (a.gated) {
                int32_t rd = a.rs_read[r];
                w = (rd >= 0 && rd < a.n_bits && a.bits[rd]) ? 1.f : 0.f;
            } else {
                w = a.rs_w[r];
            }
            int32_t row = a.rs_row[r], s = a.rs_strand[r];
            if (w != 0.f && row >= 0 && row < a.wf && s >= 0 && s < 2) {
                if constexpr (kHalf<S>)  // each add rounds; every w is 1.0 (see the header)
                    atomicAdd(static_cast<__half*>(a.read_starts) + (int64_t)row * 2 + s, h_of(w));
                else
                    atomicAdd(static_cast<S*>(a.read_starts) + (int64_t)row * 2 + s, (S)w);
            }
        }
    }
    if (__any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0) atomicOr(a.tab + 1, 1ull);
}

// the read-start total: integer-valued counts, exact in any order
template <class S>
__global__ void row_csum(RowArgs a) {
    __shared__ double s_red[32];
    const S* rs = static_cast<const S*>(a.read_starts);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    double v = 0.0;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.wf * 2; i += stride)
        v += wide<double>(rs[i]);
    v = bk_block_sum(v, s_red);
    if (threadIdx.x == 0 && v != 0.0) atomicAdd(reinterpret_cast<double*>(a.tab), v);
}

// point-mass posterior (genome_ops.py:141-159) in D, and its normaliser:
// block partials (D products added in f64) in slots, added in block order
// by the last block, which also writes scale, aux[0] and aux[3]
template <class S, class D>
__global__ void __launch_bounds__(THREADS) row_posterior(RowArgs a) {
    __shared__ double s_red[32];
    __shared__ int s_last;
    const int t = threadIdx.x;
    const S* rs_s = static_cast<const S*>(a.read_starts);
    const D* rows = static_cast<const D*>(a.fhat_rows);
    D* fhat_w = static_cast<D*>(a.fhat_w);
    const D csum = (D)*reinterpret_cast<const double*>(a.tab);
    const D alpha = (D)a.alpha;
    const D denom = bk_add((D)a.c_denom0, csum);
    D beta_num;
    if (a.alpha_one) {
        beta_num = bk_div((D)1, bk_add((D)a.c_bn0, csum));
    } else {  // exp(betaln(alpha, (2n - 1) alpha + csum)) in f64
        const double x = (double)alpha, y = (double)bk_add((D)a.c_bn0, csum);
        beta_num = (D)exp(__dadd_rn(lgamma(x), __dsub_rn(lgamma(y), lgamma(__dadd_rn(x, y)))));
    }
    const D ep = bk_mul(bk_sub((D)1, bk_mul((D)a.p0_bit, bk_div(beta_num, (D)a.beta_denom))),
                        bk_div(alpha, denom));
    const int64_t i0 = (int64_t)blockIdx.x * TAB_CHUNK;
    const int64_t i1 = min(i0 + TAB_CHUNK, a.wf * 2);
    double tv = 0.0;
    for (int64_t i = i0 + t; i < i1; i += THREADS) {
        int64_t row = i >> 1;
        D rs = wide<D>(rs_s[i]);
        D f = rs > (D)0 ? bk_div(bk_add(alpha, rs), denom) : ep;
        if (!a.fhat_valid[row]) f = 0;
        fhat_w[i] = f;
        tv = __dadd_rn(tv, (double)bk_mul(f, rows[row]));
    }
    tv = bk_block_sum(tv, s_red);
    if (t == 0) {
        a.slots[blockIdx.x] = tv;
        __threadfence();
        s_last = atomicAdd(a.tab + 2, 1ull) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    double s = 0.0;
    for (int i = t; i < (int)gridDim.x; i += THREADS) s = __dadd_rn(s, __ldcg(a.slots + i));
    const D tot = (D)bk_block_sum(s, s_red);
    if (t == 0) {
        static_cast<D*>(a.scale)[0] = tot > (D)0 ? bk_div((D)a.on_target, tot) : (D)0;
        S* aux = static_cast<S*>(a.aux);
        if constexpr (kHalf<S>) {
            aux[0] = h_of(__ldcg(a.tab + 1) ? 1.f : 0.f);
            aux[3] = h_of(bk_div(count_d<S, D>(a.total[0]), (D)a.n_real_sites));
        } else {
            aux[0] = __ldcg(a.tab + 1) ? (S)1 : (S)0;
            aux[3] = (S)bk_div((D)a.total[0], (D)a.n_real_sites);
        }
    }
}

__device__ __forceinline__ bool byte_of(uint32_t v, int j) { return (v >> (8 * j)) & 0xffu; }

__device__ __forceinline__ int lane_of(const int4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// four consecutive scores moved as one 16-byte access (float) or two (double)
template <class S>
struct Quad;

template <>
struct Quad<float> {
    float v[4];
    __device__ __forceinline__ void load(const float* p) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
    }
    __device__ __forceinline__ void store(float* p) const {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};

template <>
struct Quad<__half> {
    __half v[4];
    __device__ __forceinline__ void load(const __half* p) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        v[0] = __ushort_as_half((unsigned short)(x.x & 0xFFFFu));
        v[1] = __ushort_as_half((unsigned short)(x.x >> 16));
        v[2] = __ushort_as_half((unsigned short)(x.y & 0xFFFFu));
        v[3] = __ushort_as_half((unsigned short)(x.y >> 16));
    }
    __device__ __forceinline__ void store(__half* p) const {
        uint2 x;
        x.x = (uint32_t)__half_as_ushort(v[0]) | ((uint32_t)__half_as_ushort(v[1]) << 16);
        x.y = (uint32_t)__half_as_ushort(v[2]) | ((uint32_t)__half_as_ushort(v[3]) << 16);
        *reinterpret_cast<uint2*>(p) = x;
    }
};

template <>
struct Quad<double> {
    double v[4];
    __device__ __forceinline__ void load(const double* p) {
        const double2 x = reinterpret_cast<const double2*>(p)[0];
        const double2 y = reinterpret_cast<const double2*>(p)[1];
        v[0] = x.x;
        v[1] = x.y;
        v[2] = y.x;
        v[3] = y.y;
    }
    __device__ __forceinline__ void store(double* p) const {
        reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
        reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
    }
};

template <class S, class D>
__global__ void __launch_bounds__(THREADS) row_apply(RowArgs a) {
    __shared__ S s_thr[TR];
    __shared__ uint8_t s_act[TR];
    __shared__ __align__(16) S s_sc[TR * DS];
    S* scores = static_cast<S*>(a.scores);
    const int64_t Gd = a.G / DS, r0 = (int64_t)blockIdx.x * TR;
    const int nrow = (int)min((int64_t)TR, Gd - r0);
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t < nrow) {
        int32_t c = a.contig_id_ds[r0 + t];
        s_thr[t] = static_cast<const S*>(a.thr_c)[c];
        s_act[t] = a.active_c[c];
    }
    if (t < 2 * nrow) {  // the row's f32-rounded fhat weight, strand t & 1
        int64_t row = r0 + (t >> 1);
        int32_t fi = a.fhat_idx[row];
        D v = fi >= 0 ? static_cast<const D*>(a.fhat_w)[(int64_t)fi * 2 + (t & 1)] : (D)0;
        static_cast<D*>(a.fhat_exp)[row * 2 + (t & 1)] =
            (D)(float)bk_mul(v, static_cast<const D*>(a.scale)[0]);
    }
    __syncthreads();
    const int nq = nrow * QD;
    const int64_t g0 = r0 * DS;
    for (int64_t b = 0; b < a.nb; ++b) {
        for (int q = t; q < nq; q += THREADS) {
            const int64_t g = g0 + 4 * q;
            const int64_t idx = b * a.G + g;
            const int4 cv = *reinterpret_cast<const int4*>(a.covsum + idx);
            Quad<S> sv;
            sv.load(scores + idx);
            const uint32_t zr = *reinterpret_cast<const uint32_t*>(a.zeroed + idx);
            const uint32_t ch = *reinterpret_cast<const uint32_t*>(a.changed + g);
            const uint32_t va = *reinterpret_cast<const uint32_t*>(a.site_valid + g);
            const int row = q / QD;
            const S thr = s_thr[row];
            const bool act = s_act[row] != 0;
            bool low[4];
            if (a.low != nullptr) {
                const uint32_t lw = *reinterpret_cast<const uint32_t*>(a.low + g);
#pragma unroll
                for (int j = 0; j < 4; ++j) low[j] = byte_of(lw, j);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) low[j] = low_site<S>(lane_of(cv, j), thr);
                for (int64_t bb = 0; bb < a.nb; ++bb) {
                    if (bb == b) continue;
                    const int4 co = *reinterpret_cast<const int4*>(a.covsum + bb * a.G + g);
#pragma unroll
                    for (int j = 0; j < 4; ++j) low[j] |= low_site<S>(lane_of(co, j), thr);
                }
            }
            uint32_t zn = 0;
            Quad<S> out;
            bool any_zero = false;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                bool drop = low[j] && act && byte_of(va, j);
                bool maxed = lane_of(cv, j) >= a.freeze_cov;
                bool hold = byte_of(zr, j) && !(byte_of(ch, j) && !maxed);
                bool zero = hold || drop;
                out.v[j] = zero ? S{} : sv.v[j];
                zn |= (uint32_t)zero << (8 * j);
                any_zero |= zero;
            }
            if (any_zero) out.store(scores + idx);
            if (zn != zr) *reinterpret_cast<uint32_t*>(a.zeroed + idx) = zn;
            out.store(s_sc + 4 * q);
        }
        __syncthreads();
        // scores_ds in the warp-per-row order: lane partials, then the tree
        // (ops/genome_ops.row_sum_warp)
        for (int row = warp; row < nrow; row += THREADS / 32) {
            D acc = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                int j = lane + 32 * k;
                if (j < DS) acc += wide<D>(s_sc[row * DS + j]);
            }
            acc = bk_warp_sum(acc);
            if (lane == 0) static_cast<D*>(a.scores_ds)[b * Gd + r0 + row] = acc;
        }
        __syncthreads();
    }
}

// any barcode of this shard at or below its contig's dropout threshold,
// four sites (one int4 of covsum per barcode, one uint32 of the mask) a thread
template <class S>
__global__ void row_low(RowArgs a) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < a.G / 4; q += stride) {
        const int64_t g = 4 * q;
        const S thr = static_cast<const S*>(a.thr_c)[a.contig_id_ds[g / DS]];
        uint32_t lw = 0;
        for (int64_t b = 0; b < a.nb; ++b) {
            const int4 c = *reinterpret_cast<const int4*>(a.covsum + b * a.G + g);
#pragma unroll
            for (int j = 0; j < 4; ++j) lw |= (uint32_t)low_site<S>(lane_of(c, j), thr) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(a.low + g) = lw;
    }
}

template <class S>
int launch_sums(const RowArgs& a, cudaStream_t st) {
    const int64_t Gd = a.G / DS;
    BK_CHECK(cudaMemsetAsync(a.per_contig, 0, sizeof(unsigned long long) * a.n_c1, st));
    BK_CHECK(cudaMemsetAsync(a.winsums, 0, sizeof(unsigned long long) * a.nb * a.nw_pad, st));
    BK_CHECK(cudaMemsetAsync(a.total, 0, sizeof(unsigned long long), st));
    dim3 grid((unsigned)((Gd + SR - 1) / SR), (unsigned)a.nb);
    row_sums<S><<<grid, THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}

template <class S, class D>
int launch_tables(const RowArgs& a, cudaStream_t st) {
    const int64_t ns = (a.wf * 2 + TAB_CHUNK - 1) / TAB_CHUNK;
    if (a.tab == nullptr || a.slots == nullptr || a.n_slots < (ns > 0 ? ns : 1)) return -1;
    BK_CHECK(cudaMemsetAsync(a.tab, 0, 3 * sizeof(unsigned long long), st));
    row_tables<S, D><<<bk_grid(a.n_c1 + a.nb * a.nbk + a.n_rs, THREADS), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    row_csum<S><<<bk_grid(a.wf * 2, THREADS * 8), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    row_posterior<S, D><<<(unsigned)(ns > 0 ? ns : 1), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}

template <class S, class D>
int launch_apply(const RowArgs& a, cudaStream_t st) {
    const int64_t Gd = a.G / DS;
    if (Gd > 0) {
        row_apply<S, D><<<(unsigned)((Gd + TR - 1) / TR), THREADS, 0, st>>>(a);
        BK_LAUNCHED();
    }
    return 0;
}

// the quads need G % 4 == 0
bool supported(const RowArgs& a) { return a.G % 4 == 0; }

template <class S, class D>
int row_stage(const RowArgs* args, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const RowArgs a = *args;
    if (!supported(a)) return -1;
    int err = launch_sums<S>(a, st);
    if (!err) err = launch_tables<S, D>(a, st);
    if (!err) err = launch_apply<S, D>(a, st);
    return err;
}

template <class S, class D>
int shard_rows(const RowArgs* args, int phase, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const RowArgs a = *args;
    if (!supported(a)) return -1;
    switch (phase) {
        case 0:
            return launch_sums<S>(a, st);
        case 1:
            return launch_tables<S, D>(a, st);
        case 2:
            if (a.low == nullptr) return -1;
            row_low<S><<<bk_grid(a.G / 4, THREADS), THREADS, 0, st>>>(a);
            BK_LAUNCHED();
            return 0;
        case 3:
            return launch_apply<S, D>(a, st);
        default:
            return -1;
    }
}

}  // namespace

// one entry point per (score, decision) type pair: the default, f64
// scores (_s64), f32 decisions (_d32), and both
BK_API int bk_row_stage(const RowArgs* a, void* st) { return row_stage<float, double>(a, st); }
BK_API int bk_row_stage_s64(const RowArgs* a, void* st) { return row_stage<double, double>(a, st); }
BK_API int bk_row_stage_d32(const RowArgs* a, void* st) { return row_stage<float, float>(a, st); }
BK_API int bk_row_stage_s64_d32(const RowArgs* a, void* st) { return row_stage<double, float>(a, st); }

BK_API int bk_shard_rows(const RowArgs* a, int phase, void* st) {
    return shard_rows<float, double>(a, phase, st);
}
BK_API int bk_shard_rows_s64(const RowArgs* a, int phase, void* st) {
    return shard_rows<double, double>(a, phase, st);
}
BK_API int bk_shard_rows_d32(const RowArgs* a, int phase, void* st) {
    return shard_rows<float, float>(a, phase, st);
}
BK_API int bk_shard_rows_s64_d32(const RowArgs* a, int phase, void* st) {
    return shard_rows<double, float>(a, phase, st);
}

// dtype="float16": half scores with f64 (_h16) or f32 (_h16_d32) decisions
BK_API int bk_row_stage_h16(const RowArgs* a, void* st) { return row_stage<__half, double>(a, st); }
BK_API int bk_row_stage_h16_d32(const RowArgs* a, void* st) { return row_stage<__half, float>(a, st); }
BK_API int bk_shard_rows_h16(const RowArgs* a, int phase, void* st) {
    return shard_rows<__half, double>(a, phase, st);
}
BK_API int bk_shard_rows_h16_d32(const RowArgs* a, int phase, void* st) {
    return shard_rows<__half, float>(a, phase, st);
}
