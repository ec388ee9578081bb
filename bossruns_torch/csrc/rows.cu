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
// (covsum 4 B, scores 4 B read and masked in place, zeroed 1 B, plus 2 B
// of per-site constants); the Wf- and NBk-sized tables are small.
//
// Design: three launches on the caller's stream.
//   A. one warp per ds row sums its 100 covsum values (int64, exact) and a
//      block flushes per-contig, per-window and total sums with integer
//      atomics, one per run of equal ids (ids are sorted along the axis);
//   C. one block builds the per-contig dropout table, the bucket switches,
//      scatters the read starts (integer-valued f32 weights, so atomics are
//      exact), computes the point-mass posterior and its normaliser with a
//      fixed-order block reduction (the normaliser sums non-integers, so it
//      must not use atomics);
//   B. one warp per ds row applies the low test and sticky zeroing to the
//      scores in place, sums them to scores_ds in f64, and writes the
//      f32-rounded fhat weights of the row.
// f64 arithmetic on the decision path uses the _rn intrinsics so nvcc
// cannot contract it into FMAs the reference does not do.
//
// H8, part 2: bk_shard_rows runs the same kernels for one shard of the
// sharded step (bossruns_tpu/parallel/mesh.py:275-336, K11), one phase per
// call, so the caller can reduce across shards in between:
//   phase 0: row_sums over the shard's rows (per_contig and total are then
//            summed over both mesh axes, winsums over the genome axis);
//   phase 1: row_tables, replicated: the read-start scatter and the fhat
//            normaliser see identical inputs on every shard and give
//            identical results (aux[0], any bucket on, is then OR-ed over
//            the barcode axis);
//   phase 2: row_low, only with several barcode shards: the any-barcode
//            low test of row_apply as its own launch, a per-site mask that
//            is OR-ed over the barcode axis (mesh.py:296-297);
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
};

namespace {

constexpr int DS = 100;
constexpr int ROWS_A = 32;  // ds rows per block in pass A (8 warps x 4)

__global__ void row_sums(RowArgs a) {
    __shared__ long long s_row[ROWS_A];
    int64_t Gd = a.G / DS;
    int64_t b = blockIdx.y;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int64_t r0 = (int64_t)blockIdx.x * ROWS_A;
    for (int t = 0; t < ROWS_A / 8; ++t) {
        int i = warp * (ROWS_A / 8) + t;
        int64_t row = r0 + i;
        long long v = 0;
        if (row < Gd) {
            const int32_t* c = a.covsum + b * a.G + row * DS;
            for (int j = lane; j < DS; j += 32) v += c[j];
        }
        v = bk_warp_sum(v);
        if (lane == 0) s_row[i] = v;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    long long tot = 0, acc_c = 0, acc_w = 0;
    int32_t cur_c = -1, cur_w = -1;
    for (int i = 0; i < ROWS_A && r0 + i < Gd; ++i) {
        int64_t row = r0 + i;
        long long v = s_row[i];
        tot += v;
        int32_t c = a.contig_id_ds[row];
        if (c != cur_c) {
            if (cur_c >= 0 && cur_c < a.n_c1 && acc_c)
                atomicAdd(a.per_contig + cur_c, (unsigned long long)acc_c);
            cur_c = c;
            acc_c = 0;
        }
        acc_c += v;
        int32_t w = a.win_id_ds[row];
        if (w != cur_w) {
            if (cur_w >= 0 && cur_w < a.nw_pad && acc_w)
                atomicAdd(a.winsums + b * a.nw_pad + cur_w, (unsigned long long)acc_w);
            cur_w = w;
            acc_w = 0;
        }
        acc_w += v;
    }
    if (cur_c >= 0 && cur_c < a.n_c1 && acc_c) atomicAdd(a.per_contig + cur_c, (unsigned long long)acc_c);
    if (cur_w >= 0 && cur_w < a.nw_pad && acc_w)
        atomicAdd(a.winsums + b * a.nw_pad + cur_w, (unsigned long long)acc_w);
    if (tot) atomicAdd(a.total, (unsigned long long)tot);
}

__global__ void row_tables(RowArgs a) {
    __shared__ double s_red[32];
    __shared__ double s_csum;
    int tid = threadIdx.x, bd = blockDim.x;
    // per-contig dropout threshold (f32, as the reference's contig_mean)
    for (int64_t c = tid; c < a.n_c1; c += bd) {
        float mean = __double2float_rn(__ddiv_rn((double)a.per_contig[c], a.contig_denom[c]));
        a.thr_c[c] = floorf(__fdiv_rn(mean, a.dropout_mod));
        a.active_c[c] = mean > a.dropout_min_mean ? 1 : 0;
    }
    // sticky bucket switches
    int any = 0;
    for (int64_t k = tid; k < a.nb * a.nbk; k += bd) {
        int64_t b = k / a.nbk, j = k - b * a.nbk;
        int32_t src = a.bucket_src[j];
        float mean = 0.f;
        if (src >= 0)
            mean = __double2float_rn(__ddiv_rn((double)a.winsums[b * a.nw_pad + src], 20000.0));
        bool on = a.bucket_on[k] || (mean >= a.bucket_threshold && a.bucket_valid[j]);
        a.bucket_on[k] = on ? 1 : 0;
        any |= on;
    }
    any = __syncthreads_or(any);
    // read-start scatter (integer-valued weights: atomics are exact)
    for (int64_t i = tid; i < a.n_rs; i += bd) {
        float w;
        if (a.gated) {
            int32_t r = a.rs_read[i];
            w = (r >= 0 && r < a.n_bits && a.bits[r]) ? 1.f : 0.f;
        } else {
            w = a.rs_w[i];
        }
        int32_t row = a.rs_row[i], s = a.rs_strand[i];
        if (w != 0.f && row >= 0 && row < a.wf && s >= 0 && s < 2)
            atomicAdd(a.read_starts + (int64_t)row * 2 + s, w);
    }
    __syncthreads();
    // csum of integer-valued counts: exact in any order
    double v = 0.0;
    for (int64_t i = tid; i < a.wf * 2; i += bd) v += (double)a.read_starts[i];
    v = bk_block_sum(v, s_red);
    if (tid == 0) s_csum = v;
    __syncthreads();
    double csum = s_csum;
    // point-mass posterior (alpha == 1: B(1, z) = 1/z), genome_ops.py:141-159
    double denom = __dadd_rn(a.c_denom0, csum);
    double beta_num = __ddiv_rn(1.0, __dadd_rn(a.c_bn0, csum));
    double ep = __dmul_rn(__dsub_rn(1.0, __dmul_rn(a.p0_bit, __ddiv_rn(beta_num, a.beta_denom))),
                          __ddiv_rn(a.alpha, denom));
    double tv = 0.0;
    for (int64_t i = tid; i < a.wf * 2; i += bd) {
        int64_t row = i >> 1;
        double rs = (double)a.read_starts[i];
        double f = rs > 0.0 ? __ddiv_rn(__dadd_rn(a.alpha, rs), denom) : ep;
        if (!a.fhat_valid[row]) f = 0.0;
        a.fhat_w[i] = f;
        tv = __dadd_rn(tv, __dmul_rn(f, a.fhat_rows[row]));
    }
    // the normaliser sums non-integers: fixed-order reduction, no atomics
    double tot = bk_block_sum(tv, s_red);
    if (tid == 0) {
        a.scale[0] = tot > 0.0 ? __ddiv_rn(a.on_target, tot) : 0.0;
        a.aux[0] = any ? 1.f : 0.f;
        a.aux[3] = __double2float_rn(__ddiv_rn((double)a.total[0], a.n_real_sites));
    }
}

__global__ void row_apply(RowArgs a) {
    int64_t Gd = a.G / DS;
    int lane = threadIdx.x & 31;
    int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
    double scale = a.scale[0];
    for (int64_t row = warp; row < Gd; row += n_warps) {
        int32_t c = a.contig_id_ds[row];
        float thr = a.thr_c[c];
        bool act = a.active_c[c] != 0;
        bool drop[4], ch[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            int j = lane + 32 * t;
            drop[t] = ch[t] = false;
            if (j < DS) {
                int64_t g = row * DS + j;
                bool low = false;
                if (a.low != nullptr)
                    low = a.low[g] != 0;
                else
                    for (int64_t b = 0; b < a.nb; ++b) low |= (float)a.covsum[b * a.G + g] <= thr;
                drop[t] = low && act && a.site_valid[g];
                ch[t] = a.changed[g] != 0;
            }
        }
        for (int64_t b = 0; b < a.nb; ++b) {
            double acc = 0.0;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                int j = lane + 32 * t;
                if (j < DS) {
                    int64_t idx = b * a.G + row * DS + j;
                    bool maxed = a.covsum[idx] >= a.freeze_cov;
                    bool hold = a.zeroed[idx] && !(ch[t] && !maxed);
                    float s = a.scores[idx];
                    if (hold || drop[t]) {
                        s = 0.f;
                        a.scores[idx] = 0.f;
                    }
                    a.zeroed[idx] = (hold || drop[t]) ? 1 : 0;
                    acc += (double)s;
                }
            }
            acc = bk_warp_sum(acc);
            if (lane == 0) a.scores_ds[b * Gd + row] = acc;
        }
        if (lane < 2) {
            int32_t fi = a.fhat_idx[row];
            double v = fi >= 0 ? a.fhat_w[(int64_t)fi * 2 + lane] : 0.0;
            a.fhat_exp[row * 2 + lane] = (double)__double2float_rn(__dmul_rn(v, scale));
        }
    }
}

// any barcode of this shard at or below its contig's dropout threshold
__global__ void row_low(RowArgs a) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < a.G; g += stride) {
        float thr = a.thr_c[a.contig_id_ds[g / DS]];
        bool low = false;
        for (int64_t b = 0; b < a.nb; ++b) low |= (float)a.covsum[b * a.G + g] <= thr;
        a.low[g] = low ? 1 : 0;
    }
}

}  // namespace

BK_API int bk_row_stage(const RowArgs* args, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    RowArgs a = *args;
    int64_t Gd = a.G / DS;
    BK_CHECK(cudaMemsetAsync(a.per_contig, 0, sizeof(unsigned long long) * a.n_c1, st));
    BK_CHECK(cudaMemsetAsync(a.winsums, 0, sizeof(unsigned long long) * a.nb * a.nw_pad, st));
    BK_CHECK(cudaMemsetAsync(a.total, 0, sizeof(unsigned long long), st));
    dim3 grid_a((unsigned)((Gd + ROWS_A - 1) / ROWS_A), (unsigned)a.nb);
    row_sums<<<grid_a, 256, 0, st>>>(a);
    BK_LAUNCHED();
    row_tables<<<1, 1024, 0, st>>>(a);
    BK_LAUNCHED();
    row_apply<<<bk_grid(Gd, 8), 256, 0, st>>>(a);
    BK_LAUNCHED();
    return 0;
}

BK_API int bk_shard_rows(const RowArgs* args, int phase, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    RowArgs a = *args;
    int64_t Gd = a.G / DS;
    switch (phase) {
        case 0: {
            BK_CHECK(cudaMemsetAsync(a.per_contig, 0, sizeof(unsigned long long) * a.n_c1, st));
            BK_CHECK(cudaMemsetAsync(a.winsums, 0, sizeof(unsigned long long) * a.nb * a.nw_pad, st));
            BK_CHECK(cudaMemsetAsync(a.total, 0, sizeof(unsigned long long), st));
            dim3 grid_a((unsigned)((Gd + ROWS_A - 1) / ROWS_A), (unsigned)a.nb);
            row_sums<<<grid_a, 256, 0, st>>>(a);
            break;
        }
        case 1:
            row_tables<<<1, 1024, 0, st>>>(a);
            break;
        case 2:
            if (a.low == nullptr) return -1;
            row_low<<<bk_grid(a.G, 256), 256, 0, st>>>(a);
            break;
        case 3:
            row_apply<<<bk_grid(Gd, 8), 256, 0, st>>>(a);
            break;
        default:
            return -1;
    }
    BK_LAUNCHED();
    return 0;
}
