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
#include <math.h>

#include "common.cuh"

struct RowArgs {
    int64_t nb, G, n_c1, nw_pad, nbk, n_bits, n_rs, wf;
    int32_t freeze_cov, gated;
    float dropout_mod, dropout_min_mean, bucket_threshold, pad0;
    double c_denom0, c_bn0, beta_denom, p0_bit, alpha, on_target, n_real_sites;
    // inputs
    const int32_t* covsum;
    const uint8_t* changed;
    const uint8_t* site_valid;
    const int32_t* contig_id_ds;
    const double* contig_denom;
    const int32_t* win_id_ds;
    const int32_t* bucket_src;
    const uint8_t* bucket_valid;
    const int32_t* rs_row;
    const int32_t* rs_strand;
    const float* rs_w;
    const int32_t* rs_read;
    const uint8_t* bits;
    const uint8_t* fhat_valid;
    const double* fhat_rows;
    const int32_t* fhat_idx;
    // state, updated in place
    float* scores;
    uint8_t* zeroed;
    uint8_t* bucket_on;
    float* read_starts;
    // outputs
    double* scores_ds;
    double* fhat_exp;
    float* aux;
    // scratch
    unsigned long long* per_contig;
    unsigned long long* winsums;
    unsigned long long* total;
    float* thr_c;
    uint8_t* active_c;
    double* fhat_w;
    double* scale;
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

__global__ void __launch_bounds__(THREADS) row_sums(RowArgs a) {
    __shared__ long long s_row[SR];
    __shared__ int32_t s_c[SR], s_w[SR];
    const int64_t Gd = a.G / DS, b = blockIdx.y, r0 = (int64_t)blockIdx.x * SR;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t < SR && r0 + t < Gd) {
        s_c[t] = a.contig_id_ds[r0 + t];
        s_w[t] = a.win_id_ds[r0 + t];
    }
    const int4* base = reinterpret_cast<const int4*>(a.covsum + b * a.G + r0 * DS);
    long long v[SR / 8];
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) {
        int row = warp * (SR / 8) + i;
        v[i] = 0;
        if (lane < QD && r0 + row < Gd) {
            int4 x = base[row * QD + lane];
            v[i] = (long long)x.x + x.y + x.z + x.w;
        }
    }
#pragma unroll
    for (int i = 0; i < SR / 8; ++i) {
        long long s = bk_warp_sum(v[i]);
        if (lane == 0) s_row[warp * (SR / 8) + i] = s;
    }
    __syncthreads();
    if (t != 0) return;
    long long tot = 0, acc_c = 0, acc_w = 0;
    int32_t cur_c = -1, cur_w = -1;
    for (int i = 0; i < SR && r0 + i < Gd; ++i) {
        long long rv = s_row[i];
        tot += rv;
        int32_t c = s_c[i];
        if (c != cur_c) {
            if (cur_c >= 0 && cur_c < a.n_c1 && acc_c)
                atomicAdd(a.per_contig + cur_c, (unsigned long long)acc_c);
            cur_c = c;
            acc_c = 0;
        }
        acc_c += rv;
        int32_t w = s_w[i];
        if (w != cur_w) {
            if (cur_w >= 0 && cur_w < a.nw_pad && acc_w)
                atomicAdd(a.winsums + b * a.nw_pad + cur_w, (unsigned long long)acc_w);
            cur_w = w;
            acc_w = 0;
        }
        acc_w += rv;
    }
    if (cur_c >= 0 && cur_c < a.n_c1 && acc_c) atomicAdd(a.per_contig + cur_c, (unsigned long long)acc_c);
    if (cur_w >= 0 && cur_w < a.nw_pad && acc_w)
        atomicAdd(a.winsums + b * a.nw_pad + cur_w, (unsigned long long)acc_w);
    if (tot) atomicAdd(a.total, (unsigned long long)tot);
}

// per-contig dropout table, sticky bucket switches, read-start scatter
__global__ void row_tables(RowArgs a) {
    const int64_t n_bk = a.nb * a.nbk, n = a.n_c1 + n_bk + a.n_rs;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    int any = 0;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        if (i < a.n_c1) {  // f32, as the reference's contig_mean
            float mean = __double2float_rn(__ddiv_rn((double)a.per_contig[i], a.contig_denom[i]));
            a.thr_c[i] = floorf(__fdiv_rn(mean, a.dropout_mod));
            a.active_c[i] = mean > a.dropout_min_mean ? 1 : 0;
        } else if (i < a.n_c1 + n_bk) {
            int64_t k = i - a.n_c1, b = k / a.nbk, j = k - b * a.nbk;
            int32_t src = a.bucket_src[j];
            float mean = 0.f;
            if (src >= 0)
                mean = __double2float_rn(__ddiv_rn((double)a.winsums[b * a.nw_pad + src], 20000.0));
            bool on = a.bucket_on[k] || (mean >= a.bucket_threshold && a.bucket_valid[j]);
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
            if (w != 0.f && row >= 0 && row < a.wf && s >= 0 && s < 2)
                atomicAdd(a.read_starts + (int64_t)row * 2 + s, w);
        }
    }
    if (__any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0) atomicOr(a.tab + 1, 1ull);
}

// the read-start total: integer-valued counts, exact in any order
__global__ void row_csum(RowArgs a) {
    __shared__ double s_red[32];
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    double v = 0.0;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.wf * 2; i += stride)
        v += (double)a.read_starts[i];
    v = bk_block_sum(v, s_red);
    if (threadIdx.x == 0 && v != 0.0) atomicAdd(reinterpret_cast<double*>(a.tab), v);
}

// point-mass posterior (alpha == 1: B(1, z) = 1/z), genome_ops.py:141-159,
// and its normaliser: block partials in slots, added in block order by the
// last block, which also writes scale, aux[0] and aux[3]
__global__ void __launch_bounds__(THREADS) row_posterior(RowArgs a) {
    __shared__ double s_red[32];
    __shared__ int s_last;
    const int t = threadIdx.x;
    const double csum = *reinterpret_cast<const double*>(a.tab);
    const double denom = __dadd_rn(a.c_denom0, csum);
    const double beta_num = __ddiv_rn(1.0, __dadd_rn(a.c_bn0, csum));
    const double ep = __dmul_rn(__dsub_rn(1.0, __dmul_rn(a.p0_bit, __ddiv_rn(beta_num, a.beta_denom))),
                                __ddiv_rn(a.alpha, denom));
    const int64_t i0 = (int64_t)blockIdx.x * TAB_CHUNK;
    const int64_t i1 = min(i0 + TAB_CHUNK, a.wf * 2);
    double tv = 0.0;
    for (int64_t i = i0 + t; i < i1; i += THREADS) {
        int64_t row = i >> 1;
        double rs = (double)a.read_starts[i];
        double f = rs > 0.0 ? __ddiv_rn(__dadd_rn(a.alpha, rs), denom) : ep;
        if (!a.fhat_valid[row]) f = 0.0;
        a.fhat_w[i] = f;
        tv = __dadd_rn(tv, __dmul_rn(f, a.fhat_rows[row]));
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
    const double tot = bk_block_sum(s, s_red);
    if (t == 0) {
        a.scale[0] = tot > 0.0 ? __ddiv_rn(a.on_target, tot) : 0.0;
        a.aux[0] = __ldcg(a.tab + 1) ? 1.f : 0.f;
        a.aux[3] = __double2float_rn(__ddiv_rn((double)a.total[0], a.n_real_sites));
    }
}

__device__ __forceinline__ bool byte_of(uint32_t v, int j) { return (v >> (8 * j)) & 0xffu; }

__device__ __forceinline__ float lane_of(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ int lane_of(const int4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(THREADS) row_apply(RowArgs a) {
    __shared__ float s_thr[TR];
    __shared__ uint8_t s_act[TR];
    __shared__ __align__(16) float s_sc[TR * DS];
    const int64_t Gd = a.G / DS, r0 = (int64_t)blockIdx.x * TR;
    const int nrow = (int)min((int64_t)TR, Gd - r0);
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t < nrow) {
        int32_t c = a.contig_id_ds[r0 + t];
        s_thr[t] = a.thr_c[c];
        s_act[t] = a.active_c[c];
    }
    if (t < 2 * nrow) {  // the row's f32-rounded fhat weight, strand t & 1
        int64_t row = r0 + (t >> 1);
        int32_t fi = a.fhat_idx[row];
        double v = fi >= 0 ? a.fhat_w[(int64_t)fi * 2 + (t & 1)] : 0.0;
        a.fhat_exp[row * 2 + (t & 1)] = (double)__double2float_rn(__dmul_rn(v, a.scale[0]));
    }
    __syncthreads();
    const int nq = nrow * QD;
    const int64_t g0 = r0 * DS;
    for (int64_t b = 0; b < a.nb; ++b) {
        for (int q = t; q < nq; q += THREADS) {
            const int64_t g = g0 + 4 * q;
            const int64_t idx = b * a.G + g;
            const int4 cv = *reinterpret_cast<const int4*>(a.covsum + idx);
            float4 sv = *reinterpret_cast<const float4*>(a.scores + idx);
            const uint32_t zr = *reinterpret_cast<const uint32_t*>(a.zeroed + idx);
            const uint32_t ch = *reinterpret_cast<const uint32_t*>(a.changed + g);
            const uint32_t va = *reinterpret_cast<const uint32_t*>(a.site_valid + g);
            const int row = q / QD;
            const float thr = s_thr[row];
            const bool act = s_act[row] != 0;
            bool low[4];
            if (a.low != nullptr) {
                const uint32_t lw = *reinterpret_cast<const uint32_t*>(a.low + g);
#pragma unroll
                for (int j = 0; j < 4; ++j) low[j] = byte_of(lw, j);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) low[j] = (float)lane_of(cv, j) <= thr;
                for (int64_t bb = 0; bb < a.nb; ++bb) {
                    if (bb == b) continue;
                    const int4 co = *reinterpret_cast<const int4*>(a.covsum + bb * a.G + g);
#pragma unroll
                    for (int j = 0; j < 4; ++j) low[j] |= (float)lane_of(co, j) <= thr;
                }
            }
            uint32_t zn = 0;
            float out[4];
            bool any_zero = false;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                bool drop = low[j] && act && byte_of(va, j);
                bool maxed = lane_of(cv, j) >= a.freeze_cov;
                bool hold = byte_of(zr, j) && !(byte_of(ch, j) && !maxed);
                bool zero = hold || drop;
                out[j] = zero ? 0.f : lane_of(sv, j);
                zn |= (uint32_t)zero << (8 * j);
                any_zero |= zero;
            }
            if (any_zero)
                *reinterpret_cast<float4*>(a.scores + idx) = make_float4(out[0], out[1], out[2], out[3]);
            if (zn != zr) *reinterpret_cast<uint32_t*>(a.zeroed + idx) = zn;
            *reinterpret_cast<float4*>(s_sc + 4 * q) = make_float4(out[0], out[1], out[2], out[3]);
        }
        __syncthreads();
        // scores_ds in the warp-per-row order: lane partials, then the tree
        for (int row = warp; row < nrow; row += THREADS / 32) {
            double acc = 0.0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                int j = lane + 32 * k;
                if (j < DS) acc += (double)s_sc[row * DS + j];
            }
            acc = bk_warp_sum(acc);
            if (lane == 0) a.scores_ds[b * Gd + r0 + row] = acc;
        }
        __syncthreads();
    }
}

// any barcode of this shard at or below its contig's dropout threshold,
// four sites (one int4 of covsum per barcode, one uint32 of the mask) a thread
__global__ void row_low(RowArgs a) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < a.G / 4; q += stride) {
        const int64_t g = 4 * q;
        const float thr = a.thr_c[a.contig_id_ds[g / DS]];
        uint32_t lw = 0;
        for (int64_t b = 0; b < a.nb; ++b) {
            const int4 c = *reinterpret_cast<const int4*>(a.covsum + b * a.G + g);
#pragma unroll
            for (int j = 0; j < 4; ++j) lw |= (uint32_t)((float)lane_of(c, j) <= thr) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(a.low + g) = lw;
    }
}

int launch_sums(const RowArgs& a, cudaStream_t st) {
    const int64_t Gd = a.G / DS;
    BK_CHECK(cudaMemsetAsync(a.per_contig, 0, sizeof(unsigned long long) * a.n_c1, st));
    BK_CHECK(cudaMemsetAsync(a.winsums, 0, sizeof(unsigned long long) * a.nb * a.nw_pad, st));
    BK_CHECK(cudaMemsetAsync(a.total, 0, sizeof(unsigned long long), st));
    dim3 grid((unsigned)((Gd + SR - 1) / SR), (unsigned)a.nb);
    row_sums<<<grid, THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}

int launch_tables(const RowArgs& a, cudaStream_t st) {
    const int64_t ns = (a.wf * 2 + TAB_CHUNK - 1) / TAB_CHUNK;
    if (a.tab == nullptr || a.slots == nullptr || a.n_slots < (ns > 0 ? ns : 1)) return -1;
    BK_CHECK(cudaMemsetAsync(a.tab, 0, 3 * sizeof(unsigned long long), st));
    row_tables<<<bk_grid(a.n_c1 + a.nb * a.nbk + a.n_rs, THREADS), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    row_csum<<<bk_grid(a.wf * 2, THREADS * 8), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    row_posterior<<<(unsigned)(ns > 0 ? ns : 1), THREADS, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}

int launch_apply(const RowArgs& a, cudaStream_t st) {
    const int64_t Gd = a.G / DS;
    if (Gd > 0) {
        row_apply<<<(unsigned)((Gd + TR - 1) / TR), THREADS, 0, st>>>(a);
        BK_LAUNCHED();
    }
    return 0;
}

// the quads need G % 4 == 0
bool supported(const RowArgs& a) { return a.G % 4 == 0; }

}  // namespace

BK_API int bk_row_stage(const RowArgs* args, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const RowArgs a = *args;
    if (!supported(a)) return -1;
    int err = launch_sums(a, st);
    if (!err) err = launch_tables(a, st);
    if (!err) err = launch_apply(a, st);
    return err;
}

BK_API int bk_shard_rows(const RowArgs* args, int phase, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const RowArgs a = *args;
    if (!supported(a)) return -1;
    switch (phase) {
        case 0:
            return launch_sums(a, st);
        case 1:
            return launch_tables(a, st);
        case 2:
            if (a.low == nullptr) return -1;
            row_low<<<bk_grid(a.G / 4, THREADS), THREADS, 0, st>>>(a);
            BK_LAUNCHED();
            return 0;
        case 3:
            return launch_apply(a, st);
        default:
            return -1;
    }
}
