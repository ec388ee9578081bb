// H2 site_scores — the per-site expected-information score.
//
// Replaces: bossruns_tpu/ops/scores.py:102-150 (site_scores_t), its block
// loop :153-182 (site_scores_t_scan, which only capped [genotypes, G]
// temporaries in device memory) and the masking at models/runs.py:577-590
// (max(.,0), site_valid, and the freeze to `tiny` at covsum >= freeze_cov).
//
// Bound on the H100: device-memory bytes. At one barcode a site reads
// 5 x 2 B of coverage + 1 B of reference + 1 B of validity and writes
// 4 B of score + 4 B of covsum; the arithmetic (<= 5x15 FMAs twice, 15-30
// exp/log) stays far below the card's f32 rate.
//
// Design: one thread per (barcode, site). Counts are clipped at 990 and the
// len_b x len_g contraction runs as f32 FMAs in registers: no tensor cores,
// so TF32 can never enter (ROADMAP F5). The genotype and symbol counts are
// template parameters, so every per-site array is unrolled into registers
// and nothing of size [genotypes, G] ever exists. The model tables (<= 1 KB)
// are staged in shared memory per block.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int COUNT_CLIP = 990;

// tab layout: log_phi[LB*LG] | phi[LB*LG] | log_prior[4*LG] | k[LG]
template <int LB, int LG>
__global__ void site_scores_kernel(const uint16_t* __restrict__ cov, const int8_t* __restrict__ seq,
                                   const uint8_t* __restrict__ site_valid,
                                   const float* __restrict__ tab, int64_t nb, int64_t G,
                                   int freeze_cov, float tiny, float* __restrict__ scores,
                                   int32_t* __restrict__ covsum) {
    constexpr int NT = 2 * LB * LG + 5 * LG;
    __shared__ float s_tab[NT];
    for (int i = threadIdx.x; i < NT; i += blockDim.x) s_tab[i] = tab[i];
    __syncthreads();
    const float* lphi = s_tab;
    const float* phi = s_tab + LB * LG;
    const float* lprior = s_tab + 2 * LB * LG;
    const float* kk = s_tab + 2 * LB * LG + 4 * LG;

    int64_t n = nb * G;
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += stride) {
        int64_t b = idx / G, g = idx - b * G;
        const uint16_t* c = cov + b * 5 * G + g;
        int cs = 0;
        float cnt[LB];
#pragma unroll
        for (int s = 0; s < 5; ++s) {
            int v = c[s * G];
            cs += v;
            if (s < LB) cnt[s] = (float)(v < COUNT_CLIP ? v : COUNT_CLIP);
        }
        int ref = seq[g];
        float lp[LG];
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < LG; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int s = 0; s < LB; ++s) acc = fmaf(lphi[s * LG + j], cnt[s], acc);
            lp[j] = acc + lprior[ref * LG + j];
            m = fmaxf(m, lp[j]);
        }
        // logsumexp over genotypes, shifted by a finite max
        float msafe = isfinite(m) ? m : 0.f;
        float se = 0.f;
#pragma unroll
        for (int j = 0; j < LG; ++j) se += expf(lp[j] - msafe);
        float lse = logf(se) + msafe;
        float post[LG];
        float sk = 0.f;
#pragma unroll
        for (int j = 0; j < LG; ++j) {
            post[j] = expf(lp[j] - lse);
            sk = fmaf(post[j], kk[j], sk);
        }
        float sq = 0.f;
#pragma unroll
        for (int s = 0; s < LB; ++s) {
            float q = 0.f;
#pragma unroll
            for (int j = 0; j < LG; ++j) q = fmaf(phi[s * LG + j], post[j], q);
            if (q > 0.f) sq = fmaf(q, logf(q), sq);
        }
        float score = fmaxf(sk - sq, 0.f);
        if (!site_valid[g]) score = 0.f;
        if (cs >= freeze_cov) score = tiny;
        scores[idx] = score;
        covsum[idx] = cs;
    }
}

template <int LB, int LG>
int launch(const void* cov, const void* seq, const void* site_valid, const void* tab, int64_t nb,
           int64_t G, int freeze_cov, float tiny, void* scores, void* covsum, cudaStream_t st) {
    site_scores_kernel<LB, LG><<<bk_grid(nb * G, 256), 256, 0, st>>>(
        (const uint16_t*)cov, (const int8_t*)seq, (const uint8_t*)site_valid, (const float*)tab,
        nb, G, freeze_cov, tiny, (float*)scores, (int32_t*)covsum);
    BK_LAUNCHED();
    return 0;
}

}  // namespace

// coverage uint16[nb,5,G], seq int8[G], site_valid bool[G], tab f32 (see
// above) -> scores f32[nb,G], covsum int32[nb,G]. Returns -1 for a model
// shape without an instantiation.
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
