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
// Design, per site: four consecutive sites per thread, with 32-bit offsets
// inside a barcode row (no 64-bit divide; its five coverage planes hold
// 5 G <= 2^32 entries, so G is at most 858,993,459 sites, and chr1, the
// longest contig a caller gives, has 248,956,422): 8-byte loads of each coverage
// plane, 4-byte loads of seq and site_valid, 16-byte stores of scores and
// covsum, so each thread has a dozen independent loads in flight. A G that
// is not a multiple of 4 or a base that is not aligned takes the scalar
// instantiation of the same code.
// Sites that need no contraction get their score from the masks: `tiny`
// when frozen, 0 when invalid, else one of four per-reference constants
// (no counts), which each block computes once through the same device
// function as the full path, so they carry the same bits. At each of its
// four site slots a warp votes and skips the contraction when no lane
// needs it. The posterior is exp(lp - lse), a second pass of LG
// exponentials: reusing the log-sum-exp's exp(lp - m) terms as e / se would
// halve them, but it drops the rounding of lse that the plain version's
// exp(lp - lse) carries, and moved scores by up to 3.3e-6 from the plain
// version at the 8.05 Mb shape on an H100 (PERF.md), beyond H2's atol of
// 1e-6.
//
// One launch, over scores and covsum buffers the caller gives: pick_tiles
// lists the tiles of TILE = 4096 sites flagged in `tiles` (H1's flags of
// a step; one warp-aggregated atomic a warp), then a grid of the blocks
// the card holds at once walks the listed tiles' chunks of 1024 sites
// (score_chunk), each block taking its next (chunk, barcode) item from an
// atomic counter, so neither the ~57k untouched tiles of a chr1 step nor
// a block per tile is launched; the other sites keep what the buffers
// held. A device flag (`full`) makes the same launch walk every tile:
// pick_tiles then returns at once and `tiles` is never read. The single
// engine sets it before a step (outside any captured graph) when its kept
// values are not the state's; a caller without flags (the sharded step,
// the tests) gets it set by the wrapper, into fresh buffers. A chr1 batch
// touches ~5% of the tiles.
// The engine's rule for `full` (models/runs.py): it records, after each
// step, the state's coverage and zeroed tensors (object, address and
// `_version`, which every in-place torch write bumps and the kernels do
// not) and rescores by tile only when the next step's state matches: an
// engine's first step, another state, or a state written outside the
// engine's steps (a restore's copy_, state_from_numpy) rescores all.
// Why the kept values are exact (the argument of row_apply, rows.cu): a
// site H1 did not touch has unchanged coverage in every barcode, so its
// covsum is the kept one and `changed` is 0 there; its kept score is its
// unmasked score, or 0 where an earlier step zeroed it. Zeroed and
// unchanged, `hold` keeps it zeroed, and row_apply outputs 0 as a
// rescore of every site would; not zeroed, row_apply masks the same
// unmasked score that rescore would have written. row_sums, row_apply and
// H4 run dense on the kept buffers. H1 takes the kept covsum as its match scratch: it
// writes only inside the tiles it flags, which this launch then rewrites.
// Counts are clipped at 990; the contraction runs as f32
// FMAs in registers, never on tensor cores, so TF32 can never enter (ROADMAP
// F5). Genotype and symbol counts are template parameters, so every
// per-site array is unrolled into registers; the model tables (<= 1 KB in f32) sit
// in shared memory and every lane reads the same entry (a broadcast).
//
// RunsConfig.dtype: the kernel is a template on the score type T. The
// float instantiation (bk_site_scores) is the one described above; the
// double one (bk_site_scores_s64, the JAX engine's dtype="float64")
// takes f64 tables and writes f64 scores, with exp/log/fma in double (no
// fast-math) in the same order, and is bound by f64 arithmetic wherever
// sites need the contraction.
//
// The half instantiation (bk_site_scores_h16, the JAX engine's
// dtype="float16") reads f16 tables, widens them to f32 in shared memory
// (exactly) and writes f16 scores: 18 B a site (10 B coverage, 1 B seq,
// 1 B valid, 2 B score, 4 B covsum). It computes the JAX f16 program as
// XLA's CPU backend runs it (ops/scores._scores_h16, which pins it): f32
// arithmetic rounded to half with __float2half_rn after every op the JAX
// program rounds (one f32 +, -, * or expf/logf rounded to half is the
// correctly rounded half op), each dot an f32 sum of exact products in
// XLA's lane order (lanes_dot), each reduction over genotypes or symbols
// an f32 sum in index order rounded once. Every product it forms is of
// two half values, exact in f32, so an FMA that nvcc contracts rounds as
// the separate multiply and add. The float and double instantiations do
// not change.
#include <cuda_fp16.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int COUNT_CLIP = 990;
constexpr int THREADS = 256;
constexpr int SPT = 4;  // sites per thread
constexpr int CHUNK = THREADS * SPT;  // sites of one block's pass
constexpr int TILE = 4096;  // sites per tile flag (TILE in coverage.cu)
constexpr int CHUNKS_PER_TILE = TILE / CHUNK;

__device__ __forceinline__ float sc_exp(float x) { return expf(x); }
__device__ __forceinline__ double sc_exp(double x) { return exp(x); }
__device__ __forceinline__ float sc_log(float x) { return logf(x); }
__device__ __forceinline__ double sc_log(double x) { return log(x); }
__device__ __forceinline__ float sc_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double sc_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sc_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double sc_max(double a, double b) { return fmax(a, b); }

// four scores as one 16-byte store (float) or two (double)
__device__ __forceinline__ void store4(float* p, const float (&v)[SPT]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[SPT]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// The unmasked score of one site from its clipped counts and reference
// symbol: sum_g post[g] k[g] - sum_b q[b] log q[b], floored at 0.
// tab layout: log_phi[LB*LG] | phi[LB*LG] | log_prior[4*LG] | k[LG]
template <int LB, int LG, class T>
__device__ __forceinline__ T contract(const T (&cnt)[LB], int ref, const T* tab) {
    const T* lphi = tab;
    const T* phi = tab + LB * LG;
    const T* lprior = tab + 2 * LB * LG + ref * LG;
    const T* kk = tab + 2 * LB * LG + 4 * LG;
    T lp[LG];
    T m = -INFINITY;
#pragma unroll
    for (int j = 0; j < LG; ++j) {
        T acc = 0;
#pragma unroll
        for (int s = 0; s < LB; ++s) acc = sc_fma(lphi[s * LG + j], cnt[s], acc);
        lp[j] = acc + lprior[j];
        m = sc_max(m, lp[j]);
    }
    // logsumexp over genotypes, shifted by a finite max; lp becomes the
    // posterior exp(lp - lse), rounded as the plain version rounds it
    T msafe = isfinite(m) ? m : (T)0;
    T se = 0;
#pragma unroll
    for (int j = 0; j < LG; ++j) se += sc_exp(lp[j] - msafe);
    T lse = sc_log(se) + msafe;
    T sk = 0;
#pragma unroll
    for (int j = 0; j < LG; ++j) {
        lp[j] = sc_exp(lp[j] - lse);
        sk = sc_fma(lp[j], kk[j], sk);
    }
    T sq = 0;
#pragma unroll
    for (int s = 0; s < LB; ++s) {
        T q = 0;
#pragma unroll
        for (int j = 0; j < LG; ++j) q = sc_fma(phi[s * LG + j], lp[j], q);
        if (q > (T)0) sq = sc_fma(q, sc_log(q), sq);
    }
    return sc_max(sk - sq, (T)0);
}

// f32 rounded to half and held in f32: the rounding after an f16 op
__device__ __forceinline__ float h16(float x) { return __half2float(__float2half_rn(x)); }

// sum_k w[k * stride] * x[k] in f32, in the order XLA's CPU dot takes for
// the engine's batched operands (ops/scores._contract_lanes): four lane
// sums over the whole groups of four, (l0 + l1) + (l2 + l3), plus the sum
// in order of the rest, taken on its own (K = 15: ... + ((t12 + t13) + t14))
template <int K>
__device__ __forceinline__ float lanes_dot(const float* w, int stride, const float* x) {
    constexpr int N4 = K / 4 * 4;
    float out = 0.f;
    if (N4) {
        float l[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) l[k] = w[k * stride] * x[k];
#pragma unroll
        for (int k = 4; k < N4; ++k) l[k % 4] += w[k * stride] * x[k];
        out = (l[0] + l[1]) + (l[2] + l[3]);
    }
    if (N4 < K) {
        float tail = w[N4 * stride] * x[N4];
#pragma unroll
        for (int k = N4 + 1; k < K; ++k) tail += w[k * stride] * x[k];
        out = N4 ? out + tail : tail;
    }
    return out;
}

// The unmasked f16 score of one site (f32 tables in shared memory holding
// the half values), floored at 0 as torch.clamp_min floors (NaN stays)
template <int LB, int LG>
__device__ __forceinline__ float contract_h16(const float (&cnt)[LB], int ref, const float* tab) {
    const float* lphi = tab;
    const float* phi = tab + LB * LG;
    const float* lprior = tab + 2 * LB * LG + ref * LG;
    const float* kk = tab + 2 * LB * LG + 4 * LG;
    float lp[LG];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < LG; ++j) {
        lp[j] = h16(h16(lanes_dot<LB>(lphi + j, LG, cnt)) + lprior[j]);
        m = fmaxf(m, lp[j]);
    }
    const float msafe = isfinite(m) ? m : 0.f;
    float se = 0.f;
#pragma unroll
    for (int j = 0; j < LG; ++j) se += h16(expf(h16(lp[j] - msafe)));
    const float lse = h16(h16(logf(fabsf(h16(se)))) + msafe);
    float t1 = 0.f;
#pragma unroll
    for (int j = 0; j < LG; ++j) {
        lp[j] = h16(expf(h16(lp[j] - lse)));  // the posterior
        t1 += h16(lp[j] * kk[j]);
    }
    float t2 = 0.f;
#pragma unroll
    for (int s = 0; s < LB; ++s) {
        const float q = h16(lanes_dot<LG>(phi + s * LG, 1, lp));
        if (q > 0.f) t2 += h16(q * h16(logf(q)));
    }
    const float score = h16(h16(t1) - h16(t2));
    return score < 0.f ? 0.f : score;
}

// the arithmetic type of a score type: half computes in float
template <class T>
struct Compute {
    using type = T;
};
template <>
struct Compute<__half> {
    using type = float;
};

template <int LB, int LG, class T>
__device__ __forceinline__ typename Compute<T>::type site_score(
        const typename Compute<T>::type (&cnt)[LB], int ref, const typename Compute<T>::type* tab) {
    if constexpr (std::is_same<T, __half>::value)
        return contract_h16<LB, LG>(cnt, ref, tab);
    else
        return contract<LB, LG, T>(cnt, ref, tab);
}

__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

// four f16 scores (already rounded) as one 8-byte store
__device__ __forceinline__ void store4(__half* p, const float (&v)[SPT]) {
    const __half2 a = __floats2half2_rn(v[0], v[1]), b = __floats2half2_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&a);
    w.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = w;
}

// Each block's set-up: the model tables into shared memory (widened to
// the arithmetic type) and the score of a valid site without counts per
// reference symbol, through the same device function as the full path.
template <int LB, int LG, class T>
__device__ __forceinline__ void load_tables(const T* __restrict__ tab,
                                            typename Compute<T>::type* s_tab,
                                            typename Compute<T>::type* s_empty) {
    using C = typename Compute<T>::type;
    constexpr int NT = 2 * LB * LG + 5 * LG;
    for (int i = threadIdx.x; i < NT; i += blockDim.x) s_tab[i] = widen(tab[i]);
    __syncthreads();
    if (threadIdx.x < 4) {
        C zero[LB];
#pragma unroll
        for (int s = 0; s < LB; ++s) zero[s] = 0;
        s_empty[threadIdx.x] = site_score<LB, LG, T>(zero, threadIdx.x, s_tab);
    }
    __syncthreads();
}

// One chunk of CHUNK sites of barcode b: this thread's four sites from g0
// on. Every thread of the block calls it (the warp votes below).
template <int LB, int LG, bool kVec, class T>
__device__ __forceinline__ void score_chunk(
        const uint16_t* __restrict__ cov, const int8_t* __restrict__ seq,
        const uint8_t* __restrict__ site_valid, const typename Compute<T>::type* s_tab,
        const typename Compute<T>::type* s_empty, int G, int freeze_cov,
        typename Compute<T>::type tiny, T* __restrict__ scores, int32_t* __restrict__ covsum,
        uint32_t g0, int64_t b) {
    using C = typename Compute<T>::type;
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

    C res[SPT];
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
        res[k] = frozen ? tiny : (valid[k] ? s_empty[ref[k]] : (C)0);
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
        // warp-uniform: the whole warp skips a slot in which no lane needs it
        if (__any_sync(0xffffffffu, need[k])) {
            C cnt[LB];
#pragma unroll
            for (int s = 0; s < LB; ++s)
                cnt[s] = (C)(v[s][k] < COUNT_CLIP ? v[s][k] : COUNT_CLIP);
            C score = site_score<LB, LG, T>(cnt, ref[k], s_tab);
            if (need[k]) res[k] = score;
        }
    }

    T* out_s = scores + b * G;
    int32_t* out_c = covsum + b * G;
    if (kVec) {
        if (g0 < (uint32_t)G) {
            store4(out_s + g0, res);
            *reinterpret_cast<int4*>(out_c + g0) = make_int4(cs[0], cs[1], cs[2], cs[3]);
        }
    } else {
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            if (g0 + k < (uint32_t)G) {
                out_s[g0 + k] = (T)res[k];
                out_c[g0 + k] = cs[k];
            }
        }
    }
}

// The marked tiles as a list: one thread a tile; each warp appends its
// marked tiles with one atomic on work[0] (list order does not matter).
// Nothing to do when every site is rescored.
__global__ void pick_tiles(const uint8_t* __restrict__ tiles, int n_tiles,
                           const int32_t* __restrict__ full, int32_t* __restrict__ list,
                           int32_t* __restrict__ work) {
    if (*full != 0) return;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const bool marked = t < n_tiles && tiles[t] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, marked);
    if (ballot == 0) return;
    const int lane = threadIdx.x & 31;
    int base = 0;
    if (lane == 0) base = atomicAdd(work, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (marked) list[base + __popc(ballot & ((1u << lane) - 1u))] = t;
}

// Resident blocks take (chunk, barcode) items from the counter
// work[1] until none is left: the chunks of the listed tiles, or of every
// tile when *full is set. Thread 0 takes the next item while the block
// scores the current one.
template <int LB, int LG, bool kVec, class T>
__global__ void __launch_bounds__(THREADS)
site_scores_tiled(const uint16_t* __restrict__ cov, const int8_t* __restrict__ seq,
                  const uint8_t* __restrict__ site_valid, const T* __restrict__ tab, int G,
                  int freeze_cov, typename Compute<T>::type tiny, T* __restrict__ scores,
                  int32_t* __restrict__ covsum, const int32_t* __restrict__ full,
                  const int32_t* __restrict__ list, int32_t* __restrict__ work, int nb,
                  int n_tiles) {
    using C = typename Compute<T>::type;
    __shared__ __align__(16) C s_tab[2 * LB * LG + 5 * LG];
    __shared__ C s_empty[4];
    __shared__ int s_item[2];
    load_tables<LB, LG, T>(tab, s_tab, s_empty);
    const bool all = *full != 0;
    const int n_items = (all ? n_tiles : work[0]) * CHUNKS_PER_TILE * nb;
    if (threadIdx.x == 0) s_item[0] = atomicAdd(work + 1, 1);
    __syncthreads();
    for (int k = 0;; k ^= 1) {
        const int item = s_item[k];
        if (item >= n_items) break;
        if (threadIdx.x == 0) s_item[k ^ 1] = atomicAdd(work + 1, 1);
        const int j = item / nb;
        const int tile = all ? j / CHUNKS_PER_TILE : list[j / CHUNKS_PER_TILE];
        const uint32_t chunk = (uint32_t)tile * CHUNKS_PER_TILE + j % CHUNKS_PER_TILE;
        score_chunk<LB, LG, kVec, T>(cov, seq, site_valid, s_tab, s_empty, G, freeze_cov, tiny,
                                     scores, covsum, chunk * CHUNK + threadIdx.x * SPT,
                                     item % nb);
        __syncthreads();  // s_item[k ^ 1] is written; s_item[k] is read by all
    }
}

// Resident blocks of one instantiation on the card (all SMs), asked
// once: the same for every call of a process.
template <int LB, int LG, bool kVec, class T>
int tiled_grid() {
    static const int blocks = [] {
        int dev = 0, sms = 0, per_sm = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, site_scores_tiled<LB, LG, kVec, T>, THREADS, 0) != cudaSuccess)
            return 0;
        return sms * per_sm;
    }();
    return blocks;
}

template <int LB, int LG, class T>
int launch(const void* cov, const void* seq, const void* site_valid, const void* tab, int64_t nb,
           int64_t G, int freeze_cov, typename Compute<T>::type tiny, void* scores, void* covsum,
           const void* tiles, const void* full, void* list, void* work, cudaStream_t st) {
    if (G <= 0 || nb <= 0) return 0;
    // a barcode row's five coverage planes on 32-bit offsets (score_chunk)
    if (5 * G > (int64_t{1} << 32) || nb > 65535) return -1;
    if (!tiles || !full || !list || !work) return -1;
    auto al = [](const void* p, uintptr_t a) { return (uintptr_t)p % a == 0; };
    bool vec = G % SPT == 0 && al(cov, 8) && al(seq, 4) && al(site_valid, 4) && al(scores, 16) &&
               al(covsum, 16);
    const int64_t n_tiles = (G + TILE - 1) / TILE;
    const int64_t n_items = n_tiles * CHUNKS_PER_TILE * nb;
    const int blocks = vec ? tiled_grid<LB, LG, true, T>() : tiled_grid<LB, LG, false, T>();
    if (blocks <= 0) {
        const cudaError_t err = cudaGetLastError();
        return err != cudaSuccess ? (int)err : -1;
    }
    if (n_items + blocks >= (int64_t{1} << 31)) return -1;
    pick_tiles<<<(unsigned)((n_tiles + 255) / 256), 256, 0, st>>>(
        (const uint8_t*)tiles, (int)n_tiles, (const int32_t*)full, (int32_t*)list, (int32_t*)work);
    BK_LAUNCHED();
    auto kern = vec ? site_scores_tiled<LB, LG, true, T> : site_scores_tiled<LB, LG, false, T>;
    kern<<<(unsigned)(blocks < n_items ? blocks : n_items), THREADS, 0, st>>>(
        (const uint16_t*)cov, (const int8_t*)seq, (const uint8_t*)site_valid, (const T*)tab,
        (int)G, freeze_cov, tiny, (T*)scores, (int32_t*)covsum, (const int32_t*)full,
        (const int32_t*)list, (int32_t*)work, (int)nb, (int)n_tiles);
    BK_LAUNCHED();
    return 0;
}

template <class T>
int site_scores(const void* coverage, const void* seq, const void* site_valid, const void* tab,
                int len_b, int len_g, int64_t nb, int64_t G, int freeze_cov,
                typename Compute<T>::type tiny, void* scores, void* covsum, const void* tiles,
                const void* full, void* list, void* work, cudaStream_t st) {
#define BK_SCORES(B, L)                                                                        \
    if (len_b == B && len_g == L)                                                              \
        return launch<B, L, T>(coverage, seq, site_valid, tab, nb, G, freeze_cov, tiny, scores, \
                               covsum, tiles, full, list, work, st);
    BK_SCORES(5, 5)
    BK_SCORES(4, 4)
    BK_SCORES(5, 15)
    BK_SCORES(4, 10)
#undef BK_SCORES
    return -1;
}

}  // namespace

// coverage uint16[nb,5,G], seq int8[G], site_valid bool[G], tab f32 (see
// above), tiles uint8[ceil(G / TILE)] (H1's flags), full int32[1]
// (nonzero: every site), list int32[ceil(G / TILE)] scratch and work
// int32[2] zeroed -> scores f32[nb,G], covsum int32[nb,G] at the sites of
// the flagged tiles, or at every site when *full; the rest of scores and
// covsum is left as it is. Returns -1 for a model shape without an
// instantiation, a NULL flag or scratch pointer, or a G (5 G <= 2^32) or
// nb (<= 65535) beyond the launch's range.
BK_API int bk_site_scores(const void* coverage, const void* seq, const void* site_valid,
                          const void* tab, int len_b, int len_g, int64_t nb, int64_t G,
                          int freeze_cov, float tiny, void* scores, void* covsum,
                          const void* tiles, const void* full, void* list, void* work,
                          void* stream) {
    return site_scores<float>(coverage, seq, site_valid, tab, len_b, len_g, nb, G, freeze_cov, tiny,
                              scores, covsum, tiles, full, list, work, (cudaStream_t)stream);
}

// the same with f64 tables and f64 scores
BK_API int bk_site_scores_s64(const void* coverage, const void* seq, const void* site_valid,
                              const void* tab, int len_b, int len_g, int64_t nb, int64_t G,
                              int freeze_cov, double tiny, void* scores, void* covsum,
                              const void* tiles, const void* full, void* list, void* work,
                              void* stream) {
    return site_scores<double>(coverage, seq, site_valid, tab, len_b, len_g, nb, G, freeze_cov, tiny,
                               scores, covsum, tiles, full, list, work, (cudaStream_t)stream);
}

// the same with f16 tables and f16 scores (tiny: the half's smallest
// normal, 6.1035e-05, passed as an exact float)
BK_API int bk_site_scores_h16(const void* coverage, const void* seq, const void* site_valid,
                              const void* tab, int len_b, int len_g, int64_t nb, int64_t G,
                              int freeze_cov, float tiny, void* scores, void* covsum,
                              const void* tiles, const void* full, void* list, void* work,
                              void* stream) {
    return site_scores<__half>(coverage, seq, site_valid, tab, len_b, len_g, nb, G, freeze_cov,
                               tiny, scores, covsum, tiles, full, list, work, (cudaStream_t)stream);
}
