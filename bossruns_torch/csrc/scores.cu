// H2 site_scores — the per-site expected-information score.
//
// Replaces: bossruns_tpu/ops/scores.py:102-150 (site_scores_t), its block
// loop :153-182 (site_scores_t_scan, which only capped [genotypes, G]
// temporaries in device memory) and the masking at models/runs.py:577-590
// (max(.,0), site_valid, and the freeze to `tiny` at covsum >= freeze_cov).
//
// Bound on the H100: device-memory bytes where most sites need no
// contraction, arithmetic where coverage is dense. At one barcode a site
// reads 5 x 2 B of coverage + 1 B of reference + 1 B of validity and writes
// 4 B of score + 4 B of covsum (20 B). A site that needs the contraction
// (a nonzero count among the model's LB symbols, unfrozen, valid) costs
// 2 LB LG + LG + LB FMAs and 2 LG + LB + 1 special-function operations: at
// LG = 15 (ploidy 2) the 36 special functions take longer than the site's
// 20 B at the card's byte rate.
//
// Design: a 2-D launch, barcodes on blockIdx.y and four consecutive sites
// per thread on x, with 32-bit offsets inside a barcode row (no 64-bit
// divide): 8-byte loads of each coverage plane, 4-byte loads of seq and
// site_valid, 16-byte stores of scores and covsum, so each thread has a
// dozen independent loads in flight. A G that is not a multiple of 4 or a
// base that is not aligned takes the scalar instantiation of the same
// kernel. Sites that need no contraction get their score from the masks:
// `tiny` when frozen, 0 when invalid, else one of four per-reference
// constants (no counts), which each block computes once through the same
// device function as the full path, so they carry the same bits. At each of
// its four site slots a warp votes and skips the contraction when no lane
// needs it. The posterior is exp(lp - lse), a second pass of LG
// exponentials: reusing the log-sum-exp's exp(lp - m) terms as e / se would
// halve them, but it drops the rounding of lse that the plain version's
// exp(lp - lse) carries, and moved scores by up to 3.3e-6 from the plain
// version at the 8.05 Mb shape on an H100 (PERF.md), beyond H2's atol of
// 1e-6.
// Counts are clipped at 990; the contraction runs as f32
// FMAs in registers, never on tensor cores, so TF32 can never enter (ROADMAP
// F5). Genotype and symbol counts are template parameters, so every
// per-site array is unrolled into registers; the model tables (<= 1 KB) sit
// in shared memory and every lane reads the same entry (a broadcast).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int COUNT_CLIP = 990;
constexpr int THREADS = 256;
constexpr int SPT = 4;  // sites per thread

// The unmasked score of one site from its clipped counts and reference
// symbol: sum_g post[g] k[g] - sum_b q[b] log q[b], floored at 0.
// tab layout: log_phi[LB*LG] | phi[LB*LG] | log_prior[4*LG] | k[LG]
template <int LB, int LG>
__device__ __forceinline__ float contract(const float (&cnt)[LB], int ref, const float* tab) {
    const float* lphi = tab;
    const float* phi = tab + LB * LG;
    const float* lprior = tab + 2 * LB * LG + ref * LG;
    const float* kk = tab + 2 * LB * LG + 4 * LG;
    float lp[LG];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < LG; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < LB; ++s) acc = fmaf(lphi[s * LG + j], cnt[s], acc);
        lp[j] = acc + lprior[j];
        m = fmaxf(m, lp[j]);
    }
    // logsumexp over genotypes, shifted by a finite max; lp becomes the
    // posterior exp(lp - lse), rounded as the plain version rounds it
    float msafe = isfinite(m) ? m : 0.f;
    float se = 0.f;
#pragma unroll
    for (int j = 0; j < LG; ++j) se += expf(lp[j] - msafe);
    float lse = logf(se) + msafe;
    float sk = 0.f;
#pragma unroll
    for (int j = 0; j < LG; ++j) {
        lp[j] = expf(lp[j] - lse);
        sk = fmaf(lp[j], kk[j], sk);
    }
    float sq = 0.f;
#pragma unroll
    for (int s = 0; s < LB; ++s) {
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < LG; ++j) q = fmaf(phi[s * LG + j], lp[j], q);
        if (q > 0.f) sq = fmaf(q, logf(q), sq);
    }
    return fmaxf(sk - sq, 0.f);
}

template <int LB, int LG, bool kVec>
__global__ void __launch_bounds__(THREADS)
site_scores_kernel(const uint16_t* __restrict__ cov, const int8_t* __restrict__ seq,
                   const uint8_t* __restrict__ site_valid, const float* __restrict__ tab, int G,
                   int freeze_cov, float tiny, float* __restrict__ scores,
                   int32_t* __restrict__ covsum) {
    constexpr int NT = 2 * LB * LG + 5 * LG;
    __shared__ __align__(16) float s_tab[NT];  // 16-byte aligned: vector loads of the tables
    __shared__ float s_empty[4];  // the score of a valid site without counts, per reference
    for (int i = threadIdx.x; i < NT; i += blockDim.x) s_tab[i] = tab[i];
    __syncthreads();
    if (threadIdx.x < 4) {
        float zero[LB];
#pragma unroll
        for (int s = 0; s < LB; ++s) zero[s] = 0.f;
        s_empty[threadIdx.x] = contract<LB, LG>(zero, threadIdx.x, s_tab);
    }
    __syncthreads();

    // 32-bit site offsets inside one barcode row (the wrapper checks G < 2^31 - 2^10)
    const uint32_t g0 = (blockIdx.x * THREADS + threadIdx.x) * SPT;
    const int64_t b = blockIdx.y;
    const uint16_t* c = cov + b * 5 * G;
    uint32_t v[5][SPT];
    int ref[SPT];
    bool valid[SPT];
    if (kVec) {
        // G % 4 == 0: a thread's four sites are all inside the row or all past it
        bool in = g0 < (uint32_t)G;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
            uint2 w = in ? *reinterpret_cast<const uint2*>(c + (uint32_t)s * G + g0) : make_uint2(0, 0);
            v[s][0] = w.x & 0xFFFFu;
            v[s][1] = w.x >> 16;
            v[s][2] = w.y & 0xFFFFu;
            v[s][3] = w.y >> 16;
        }
        uint32_t r4 = in ? *reinterpret_cast<const uint32_t*>(seq + g0) : 0u;
        uint32_t ok4 = in ? *reinterpret_cast<const uint32_t*>(site_valid + g0) : 0u;
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            ref[k] = (r4 >> (8 * k)) & 3;
            valid[k] = ((ok4 >> (8 * k)) & 0xFFu) != 0;
        }
    } else {
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            uint32_t g = g0 + k;
            bool in = g < (uint32_t)G;
#pragma unroll
            for (int s = 0; s < 5; ++s) v[s][k] = in ? c[(uint32_t)s * G + g] : 0u;
            ref[k] = in ? seq[g] & 3 : 0;
            valid[k] = in && site_valid[g] != 0;
        }
    }

    float res[SPT];
    int cs[SPT];
    bool need[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
        uint32_t sum = 0, any = 0;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
            sum += v[s][k];
            if (s < LB) any |= v[s][k];
        }
        cs[k] = (int)sum;
        bool frozen = cs[k] >= freeze_cov;
        need[k] = any != 0 && !frozen && valid[k];
        res[k] = frozen ? tiny : (valid[k] ? s_empty[ref[k]] : 0.f);
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
        // warp-uniform: the whole warp skips a slot in which no lane needs it
        if (__any_sync(0xffffffffu, need[k])) {
            float cnt[LB];
#pragma unroll
            for (int s = 0; s < LB; ++s)
                cnt[s] = (float)(v[s][k] < COUNT_CLIP ? v[s][k] : COUNT_CLIP);
            float score = contract<LB, LG>(cnt, ref[k], s_tab);
            if (need[k]) res[k] = score;
        }
    }

    float* out_s = scores + b * G;
    int32_t* out_c = covsum + b * G;
    if (kVec) {
        if (g0 < (uint32_t)G) {
            *reinterpret_cast<float4*>(out_s + g0) = make_float4(res[0], res[1], res[2], res[3]);
            *reinterpret_cast<int4*>(out_c + g0) = make_int4(cs[0], cs[1], cs[2], cs[3]);
        }
    } else {
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            if (g0 + k < (uint32_t)G) {
                out_s[g0 + k] = res[k];
                out_c[g0 + k] = cs[k];
            }
        }
    }
}

template <int LB, int LG>
int launch(const void* cov, const void* seq, const void* site_valid, const void* tab, int64_t nb,
           int64_t G, int freeze_cov, float tiny, void* scores, void* covsum, cudaStream_t st) {
    if (G <= 0 || nb <= 0) return 0;
    if (G >= (int64_t{1} << 31) - THREADS * SPT || nb > 65535) return -1;
    auto al = [](const void* p, uintptr_t a) { return (uintptr_t)p % a == 0; };
    bool vec = G % SPT == 0 && al(cov, 8) && al(seq, 4) && al(site_valid, 4) && al(scores, 16) &&
               al(covsum, 16);
    dim3 grid((unsigned)((G + THREADS * SPT - 1) / (THREADS * SPT)), (unsigned)nb);
    auto kern = vec ? site_scores_kernel<LB, LG, true> : site_scores_kernel<LB, LG, false>;
    kern<<<grid, THREADS, 0, st>>>((const uint16_t*)cov, (const int8_t*)seq,
                                   (const uint8_t*)site_valid, (const float*)tab, (int)G,
                                   freeze_cov, tiny, (float*)scores, (int32_t*)covsum);
    BK_LAUNCHED();
    return 0;
}

}  // namespace

// coverage uint16[nb,5,G], seq int8[G], site_valid bool[G], tab f32 (see
// above) -> scores f32[nb,G], covsum int32[nb,G]. Returns -1 for a model
// shape without an instantiation or a G or nb beyond the launch's range.
BK_API int bk_site_scores(const void* coverage, const void* seq, const void* site_valid,
                          const void* tab, int len_b, int len_g, int64_t nb, int64_t G,
                          int freeze_cov, float tiny, void* scores, void* covsum, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (len_b == 5 && len_g == 5)
        return launch<5, 5>(coverage, seq, site_valid, tab, nb, G, freeze_cov, tiny, scores, covsum, st);
    if (len_b == 4 && len_g == 4)
        return launch<4, 4>(coverage, seq, site_valid, tab, nb, G, freeze_cov, tiny, scores, covsum, st);
    if (len_b == 5 && len_g == 15)
        return launch<5, 15>(coverage, seq, site_valid, tab, nb, G, freeze_cov, tiny, scores, covsum, st);
    if (len_b == 4 && len_g == 10)
        return launch<4, 10>(coverage, seq, site_valid, tab, nb, G, freeze_cov, tiny, scores, covsum, st);
    return -1;
}
