// H1 coverage_update — the coverage stage of one BOSS-RUNS update step.
//
// Replaces: bossruns_tpu/models/runs.py:518-575 (RunsEngine._step stage 1:
// the +-1 match-run boundary scatter and cumsum, the flat explicit-
// observation scatter, the saturating uint16 add and the per-site changed
// flag) and runs.py:409-460 (RunsEngine._step_gated: the per-read bit
// gather that keeps full-record rows of accepted reads and trunc rows of
// rejected reads), which this kernel fuses into the scatter.
//
// Bound on the H100: device-memory bytes. A 4000-read batch touches ~14M
// bases, as integer atomics; the function must read and write the coverage
// entries it changes and write one changed flag per site. Zeroing or
// streaming a scratch over the whole genome every step (24 B per site and
// barcode at chr1: a 6 GB memset) is work the function does not need.
//
// Design: work only on the tiles of TILE sites that the batch touches.
// Four passes over the rows and tiles:
//   1. mark: every surviving match run and explicit observation sets the
//      flag of each tile it touches (plain idempotent stores; one thread per
//      row);
//   2. zero_tiles: a marked tile zeroes its part of the int32 match scratch
//      [nb, G] and of changed, so the scratch needs no memset and may come
//      fresh from the allocator each call;
//   3. add: each match run adds +1 per base into the match scratch (one warp
//      per run, lanes on consecutive bases, so the atomics coalesce); each
//      explicit observation goes straight into the uint16 coverage with a
//      saturating compare-and-swap on the 32-bit word that holds it, and
//      sets changed at its site;
//   4. combine: an unmarked tile writes changed = 0 and stops; a marked tile
//      adds each nonzero match count into plane seq[g] of the coverage with
//      saturation and ors the count into changed.
// The tile flags (one byte per tile, zeroed by the wrapper) and the scratch
// (4 B per site and barcode) belong to the call: nothing is kept between
// calls, so a failed call leaves nothing behind for the next one. A scratch
// kept zero between steps would stay allocated through the scores and row
// stages and raise the step's peak memory (PERF.md). Every increment is
// >= 0, so saturating per increment equals saturating the summed increment
// once (min(c + a + b, 65535)), and "changed" is "any match count or
// explicit observation" (the argument of models/runs.py:570-575): the
// result is exact in any order (F4). All index math
// is int64 with explicit range masks: an EX_PAD row (ex_g == 0xFFFFFFFF), a
// row with mr_len 0 or a flat index >= nb*5*G is dropped and can never wrap
// back in bounds (F2).
//
// H8, part 1: bk_shard_coverage, the coverage stage of one shard of the
// sharded step (bossruns_tpu/parallel/mesh.py:234-276, K11). The same
// kernels take a shard window: barcodes [b0, b0+nb) and sites [g0, g0+G)
// of the global axes. Every shard sees the whole replicated batch; a match
// run is clipped to [max(g, g0), min(g+L, g0+G)) and adds over that part
// only, and an explicit observation is kept iff (ex_g - g0) wraps below G
// in uint32 (the test of local_ex_indices, mesh.py:90-100). Because H1 adds
// per base, a run that starts left of the shard needs no carry: the +-1
// markers and the all-gathered net counts of mesh.py:238-251 have no
// counterpart here.
#include "common.cuh"

namespace {

constexpr uint32_t EX_PAD = 0xFFFFFFFFu;
constexpr int64_t TILE = 4096;  // sites per tile flag (COVERAGE_TILE in ops/genome_ops.py)
constexpr int TILE_THREADS = 256;

// true iff the row survives the gate: bits == nullptr means ungated
__device__ __forceinline__ bool keep_row(const uint32_t* read, int64_t i, const uint8_t* bits,
                                         int64_t n_bits, int want_on) {
    if (bits == nullptr) return true;
    uint32_t r = read[i];
    bool on = (int64_t)r < n_bits && bits[r] != 0;
    return on == (want_on != 0);
}

// The shard window: barcodes [b0, b0+nb), sites [g0, g0+G) of the global
// axes. Unsharded (kSharded false, b0 = g0 = 0), a row indexes the flat
// [nb*G] domain directly (a run may run on into the next barcode's row, as
// the reference's flat cumsum does); the two paths are separate
// instantiations, so the unsharded one carries no window arithmetic.
struct Window {
    int64_t b0, g0, nb, G;
};

// The part of match run i that lands in the window, as a range [lo, hi) of
// the flat [nb*G] match scratch (unsharded: the run's flat range clipped at
// nb*G; sharded: one barcode row, clipped to the window); lo >= hi when
// nothing lands.
template <bool kSharded>
__device__ __forceinline__ void run_range(const uint8_t* bc, const uint32_t* g, int64_t L,
                                          int64_t i, const Window& w, int64_t& lo, int64_t& hi) {
    if (!kSharded) {
        lo = (int64_t)bc[i] * w.G + (int64_t)g[i];
        hi = lo + L < w.nb * w.G ? lo + L : w.nb * w.G;
        return;
    }
    int64_t bl = (int64_t)bc[i] - w.b0;
    int64_t s = (int64_t)g[i], e = s + L;
    lo = s > w.g0 ? s : w.g0;
    hi = e < w.g0 + w.G ? e : w.g0 + w.G;
    if (bl < 0 || bl >= w.nb) hi = lo;
    lo += bl * w.G - w.g0;
    hi += bl * w.G - w.g0;
}

// Pass 1 for match runs: one thread per run sets the flags of the tiles its
// flat range covers, row by row of the scratch.
template <bool kSharded>
__global__ void mark_runs(const uint8_t* __restrict__ bc, const uint32_t* __restrict__ g,
                          const uint16_t* __restrict__ len, const uint32_t* __restrict__ read,
                          int64_t n, const uint8_t* __restrict__ bits, int64_t n_bits,
                          int want_on, uint8_t* __restrict__ tiles, Window w) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        int64_t L = len[i];
        if (L == 0 || !keep_row(read, i, bits, n_bits, want_on)) continue;
        int64_t lo, hi;
        run_range<kSharded>(bc, g, L, i, w, lo, hi);
        while (lo < hi) {  // unsharded, a run can continue in the next barcode's row
            int64_t row = lo / w.G * w.G;
            int64_t end = hi < row + w.G ? hi : row + w.G;
            for (int64_t t = (lo - row) / TILE; t <= (end - 1 - row) / TILE; ++t) tiles[t] = 1;
            lo = end;
        }
    }
}

// Pass 3 for match runs: +1 per base of the run's range, one warp per run.
template <bool kSharded>
__global__ void add_runs(const uint8_t* __restrict__ bc, const uint32_t* __restrict__ g,
                         const uint16_t* __restrict__ len, const uint32_t* __restrict__ read,
                         int64_t n, const uint8_t* __restrict__ bits, int64_t n_bits, int want_on,
                         int32_t* __restrict__ match, Window w) {
    int lane = threadIdx.x & 31;
    int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
    for (int64_t i = warp; i < n; i += n_warps) {
        int64_t L = len[i];
        if (L == 0 || !keep_row(read, i, bits, n_bits, want_on)) continue;
        int64_t lo, hi;
        run_range<kSharded>(bc, g, L, i, w, lo, hi);
        for (int64_t f = lo + lane; f < hi; f += 32) atomicAdd(match + f, 1);
    }
}

// The coverage entry (flat [nb*5*G]) and site of explicit observation i, or
// false when the row is dropped.
template <bool kSharded>
__device__ __forceinline__ bool obs_index(const uint16_t* bcsym, const uint32_t* g,
                                          const uint32_t* read, int64_t i, const uint8_t* bits,
                                          int64_t n_bits, int want_on, const Window& w,
                                          int64_t& f, int64_t& p) {
    uint32_t gg = g[i];
    if (!kSharded) {
        if (gg == EX_PAD || !keep_row(read, i, bits, n_bits, want_on)) return false;
        f = (int64_t)bcsym[i] * w.G + (int64_t)gg;
        if (f >= w.nb * 5 * w.G) return false;
        p = (int64_t)gg < w.G ? (int64_t)gg : f % w.G;
        return true;
    }
    // local_ex_indices: the position wraps in uint32, so a site left of the
    // shard (and EX_PAD) fails the < G test
    uint32_t gu = gg - (uint32_t)w.g0;
    int64_t bs = bcsym[i];
    int64_t bl = bs / 5 - w.b0;
    if ((int64_t)gu >= w.G || bl < 0 || bl >= w.nb || !keep_row(read, i, bits, n_bits, want_on))
        return false;
    f = (bl * 5 + bs % 5) * w.G + (int64_t)gu;
    p = (int64_t)gu;
    return true;
}

// +1 on the uint16 coverage entry f, saturating at 65535: a compare-and-
// swap on the aligned 32-bit word that holds it (the coverage base is
// 4-byte aligned, so entries 2k and 2k+1 share a word).
__device__ __forceinline__ void sat_increment(uint16_t* cov, int64_t f) {
    unsigned int* word = reinterpret_cast<unsigned int*>(cov + (f & ~int64_t{1}));
    const unsigned int shift = (unsigned int)(f & 1) * 16u;
    unsigned int old = *word, assumed;
    do {
        assumed = old;
        if (((assumed >> shift) & 0xFFFFu) == 0xFFFFu) return;
        old = atomicCAS(word, assumed, assumed + (1u << shift));
    } while (old != assumed);
}

// Passes 1 (kAdd false: set the tile flag) and 3 (kAdd true: the saturating
// add and the changed flag) for explicit observations, one thread each.
template <bool kSharded, bool kAdd>
__global__ void explicit_rows(const uint16_t* __restrict__ bcsym, const uint32_t* __restrict__ g,
                              const uint32_t* __restrict__ read, int64_t n,
                              const uint8_t* __restrict__ bits, int64_t n_bits, int want_on,
                              uint16_t* __restrict__ cov, uint8_t* __restrict__ changed,
                              uint8_t* __restrict__ tiles, Window w) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        int64_t f, p;
        if (!obs_index<kSharded>(bcsym, g, read, i, bits, n_bits, want_on, w, f, p)) continue;
        if (kAdd) {
            sat_increment(cov, f);
            changed[p] = 1;
        } else {
            tiles[p / TILE] = 1;
        }
    }
}

// Pass 2: one block per tile; a marked tile zeroes its match counts and
// changed flags (G % 4 == 0, so a tile's sites come in whole quads).
__global__ void __launch_bounds__(TILE_THREADS)
zero_tiles(int32_t* __restrict__ match, const uint8_t* __restrict__ tiles,
           uint8_t* __restrict__ changed, int64_t nb, int64_t G) {
    const int64_t t = blockIdx.x;
    if (tiles[t] == 0) return;
    const int64_t lo = t * TILE, hi = lo + TILE < G ? lo + TILE : G;
    for (int64_t g = lo + 4 * threadIdx.x; g < hi; g += 4 * TILE_THREADS) {
        *reinterpret_cast<uint32_t*>(changed + g) = 0;
        for (int64_t b = 0; b < nb; ++b)
            *reinterpret_cast<int4*>(match + b * G + g) = make_int4(0, 0, 0, 0);
    }
}

// Pass 4: one block per tile, four sites per thread and step.
__global__ void __launch_bounds__(TILE_THREADS)
combine(const int8_t* __restrict__ seq, const int32_t* __restrict__ match,
        const uint8_t* __restrict__ tiles, uint16_t* __restrict__ cov,
        uint8_t* __restrict__ changed, int64_t nb, int64_t G) {
    const int64_t t = blockIdx.x;
    const bool marked = tiles[t] != 0;
    const int64_t lo = t * TILE, hi = lo + TILE < G ? lo + TILE : G;
    for (int64_t g = lo + 4 * threadIdx.x; g < hi; g += 4 * TILE_THREADS) {
        if (!marked) {
            *reinterpret_cast<uint32_t*>(changed + g) = 0;
            continue;
        }
        uint32_t ch = *reinterpret_cast<const uint32_t*>(changed + g);  // explicit: bytes 0 or 1
        const uint32_t r4 = *reinterpret_cast<const uint32_t*>(seq + g);
        for (int64_t b = 0; b < nb; ++b) {
            int4 m4 = *reinterpret_cast<const int4*>(match + b * G + g);
            if ((m4.x | m4.y | m4.z | m4.w) == 0) continue;
            const int32_t m[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if (m[k] == 0) continue;
                int64_t idx = (b * 5 + ((r4 >> (8 * k)) & 0xFF)) * G + g + k;
                uint32_t v = (uint32_t)cov[idx] + (uint32_t)m[k];
                cov[idx] = (uint16_t)(v > 65535u ? 65535u : v);
                ch |= 1u << (8 * k);
            }
        }
        *reinterpret_cast<uint32_t*>(changed + g) = ch;
    }
}

}  // namespace

BK_API const char* bk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Rows come in up to two families. Ungated (bits == NULL): family f only,
// read pointers unused. Gated: a family-f (full record) row survives iff
// bits[read] == 1, a family-t (truncated record) row iff bits[read] == 0.
// match: int32[nb*G], any contents; tiles: uint8[ceil(G / TILE)], all zero.
// G % 4 == 0; coverage, seq and changed
// 8-, 4- and 4-byte aligned (the wrapper checks).
struct Family {
    const void *mr_bc, *mr_g, *mr_len, *mr_read;
    int64_t n_mr;
    const void *ex_bcsym, *ex_g, *ex_read;
    int64_t n_ex;
    int want_on;
};

static int coverage_launch(const Family* fams, int n_fams, const void* bits, int64_t n_bits,
                           const void* seq, void* coverage, void* changed, void* match_p,
                           void* tiles_p, Window w, bool sharded, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (w.G <= 0 || w.nb <= 0) return 0;
    if (w.G % 4) return -1;
    int32_t* match = (int32_t*)match_p;
    uint8_t* tiles = (uint8_t*)tiles_p;
    uint16_t* cov = (uint16_t*)coverage;
    uint8_t* ch = (uint8_t*)changed;
    const uint8_t* bt = (const uint8_t*)bits;
    const int64_t n_tiles = (w.G + TILE - 1) / TILE;
    for (int add = 0; add < 2; ++add) {
        if (add) {
            zero_tiles<<<(unsigned)n_tiles, TILE_THREADS, 0, st>>>(match, tiles, ch, w.nb, w.G);
            BK_LAUNCHED();
        }
        for (int k = 0; k < n_fams; ++k) {
            const Family& F = fams[k];
            auto bc = (const uint8_t*)F.mr_bc;
            auto gg = (const uint32_t*)F.mr_g;
            auto ln = (const uint16_t*)F.mr_len;
            auto rd = (const uint32_t*)F.mr_read;
            if (F.n_mr > 0) {
                if (!add) {
                    auto kern = sharded ? mark_runs<true> : mark_runs<false>;
                    kern<<<bk_grid(F.n_mr, 256), 256, 0, st>>>(bc, gg, ln, rd, F.n_mr, bt, n_bits,
                                                               F.want_on, tiles, w);
                } else {
                    auto kern = sharded ? add_runs<true> : add_runs<false>;
                    kern<<<bk_grid(F.n_mr, 8), 256, 0, st>>>(bc, gg, ln, rd, F.n_mr, bt, n_bits,
                                                             F.want_on, match, w);
                }
                BK_LAUNCHED();
            }
            if (F.n_ex > 0) {
                auto kern = sharded ? (add ? explicit_rows<true, true> : explicit_rows<true, false>)
                                    : (add ? explicit_rows<false, true> : explicit_rows<false, false>);
                kern<<<bk_grid(F.n_ex, 256), 256, 0, st>>>(
                    (const uint16_t*)F.ex_bcsym, (const uint32_t*)F.ex_g, (const uint32_t*)F.ex_read,
                    F.n_ex, bt, n_bits, F.want_on, cov, ch, tiles, w);
                BK_LAUNCHED();
            }
        }
    }
    combine<<<(unsigned)n_tiles, TILE_THREADS, 0, st>>>((const int8_t*)seq, match, tiles, cov, ch,
                                                        w.nb, w.G);
    BK_LAUNCHED();
    return 0;
}

BK_API int bk_coverage_update(
    const void* f_mr_bc, const void* f_mr_g, const void* f_mr_len, const void* f_mr_read, int64_t n_f_mr,
    const void* t_mr_bc, const void* t_mr_g, const void* t_mr_len, const void* t_mr_read, int64_t n_t_mr,
    const void* f_ex_bcsym, const void* f_ex_g, const void* f_ex_read, int64_t n_f_ex,
    const void* t_ex_bcsym, const void* t_ex_g, const void* t_ex_read, int64_t n_t_ex,
    const void* bits, int64_t n_bits, const void* seq, void* coverage, void* changed,
    void* match, void* tiles, int64_t nb, int64_t G, void* stream) {
    const Family fams[2] = {
        {f_mr_bc, f_mr_g, f_mr_len, f_mr_read, n_f_mr, f_ex_bcsym, f_ex_g, f_ex_read, n_f_ex, 1},
        {t_mr_bc, t_mr_g, t_mr_len, t_mr_read, n_t_mr, t_ex_bcsym, t_ex_g, t_ex_read, n_t_ex, 0},
    };
    return coverage_launch(fams, bits == nullptr ? 1 : 2, bits, n_bits, seq, coverage, changed,
                           match, tiles, Window{0, 0, nb, G}, false, stream);
}

// One shard (ungated, family f only): coverage [nb_l, 5, Gl] and seq [Gl]
// are the shard's blocks; rows carry global barcodes and positions.
BK_API int bk_shard_coverage(
    const void* mr_bc, const void* mr_g, const void* mr_len, int64_t n_mr,
    const void* ex_bcsym, const void* ex_g, int64_t n_ex, const void* seq, void* coverage,
    void* changed, void* match, void* tiles, int64_t b0, int64_t g0, int64_t nb_l,
    int64_t Gl, void* stream) {
    const Family f = {mr_bc, mr_g, mr_len, nullptr, n_mr, ex_bcsym, ex_g, nullptr, n_ex, 1};
    return coverage_launch(&f, 1, nullptr, 0, seq, coverage, changed, match, tiles,
                           Window{b0, g0, nb_l, Gl}, true, stream);
}
