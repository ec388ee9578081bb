// H1 coverage_update — the coverage stage of one BOSS-RUNS update step.
//
// Replaces: bossruns_tpu/models/runs.py:518-575 (RunsEngine._step stage 1:
// the +-1 match-run boundary scatter and cumsum, the flat explicit-
// observation scatter, the saturating uint16 add and the per-site changed
// flag) and runs.py:409-460 (RunsEngine._step_gated: the per-read bit
// gather that keeps full-record rows of accepted reads and trunc rows of
// rejected reads), which this kernel fuses into the scatter.
//
// Bound on the H100: device-memory bytes. The scatter touches ~14M bases
// per 4000-read batch as int32 atomics; the combine pass streams the int32
// scratch (4 B x 6 planes per site and barcode) and the uint16 coverage.
//
// Design: each surviving match run adds +1 per base straight into an int32
// [nb*G] scratch (one warp per run, lanes on consecutive bases, so the
// atomics coalesce) instead of the TPU's boundary scatter + scan; explicit
// observations add into an int32 [nb*5*G] scratch. Integer atomics commute,
// so the result is deterministic. A fused elementwise pass then does the
// saturating add into the uint16 coverage in place, touching only sites
// with a nonzero increment, and writes changed[g]. All index math is int64
// with explicit range masks: an EX_PAD row (ex_g == 0xFFFFFFFF) or a flat
// index >= nb*5*G is dropped and can never wrap back in bounds. Per-base
// atomics are the simple first version; a run-boundary scan is the
// obvious next step if the scatter dominates.
#include "common.cuh"

namespace {

constexpr uint32_t EX_PAD = 0xFFFFFFFFu;

// true iff the row survives the gate: bits == nullptr means ungated
__device__ __forceinline__ bool keep_row(const uint32_t* read, int64_t i, const uint8_t* bits,
                                         int64_t n_bits, int want_on) {
    if (bits == nullptr) return true;
    uint32_t r = read[i];
    bool on = (int64_t)r < n_bits && bits[r] != 0;
    return on == (want_on != 0);
}

__global__ void match_scatter(const uint8_t* __restrict__ bc, const uint32_t* __restrict__ g,
                              const uint16_t* __restrict__ len, const uint32_t* __restrict__ read,
                              int64_t n, const uint8_t* __restrict__ bits, int64_t n_bits,
                              int want_on, int32_t* __restrict__ match, int64_t nbG, int64_t G) {
    int lane = threadIdx.x & 31;
    int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
    for (int64_t i = warp; i < n; i += n_warps) {
        int64_t L = len[i];
        if (L == 0 || !keep_row(read, i, bits, n_bits, want_on)) continue;
        int64_t flat = (int64_t)bc[i] * G + (int64_t)g[i];
        for (int64_t k = lane; k < L; k += 32) {
            int64_t f = flat + k;
            if (f < nbG) atomicAdd(match + f, 1);
        }
    }
}

__global__ void explicit_scatter(const uint16_t* __restrict__ bcsym, const uint32_t* __restrict__ g,
                                 const uint32_t* __restrict__ read, int64_t n,
                                 const uint8_t* __restrict__ bits, int64_t n_bits, int want_on,
                                 int32_t* __restrict__ ex, int64_t n_dom, int64_t G) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        uint32_t gg = g[i];
        if (gg == EX_PAD || !keep_row(read, i, bits, n_bits, want_on)) continue;
        int64_t f = (int64_t)bcsym[i] * G + (int64_t)gg;
        if (f < n_dom) atomicAdd(ex + f, 1);
    }
}

__global__ void combine(const int8_t* __restrict__ seq, const int32_t* __restrict__ match,
                        const int32_t* __restrict__ ex, uint16_t* __restrict__ cov,
                        uint8_t* __restrict__ changed, int64_t nb, int64_t G) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < G; g += stride) {
        int ref = seq[g];
        bool ch = false;
        for (int64_t b = 0; b < nb; ++b) {
            int32_t m = match[b * G + g];
            ch |= m != 0;
#pragma unroll
            for (int s = 0; s < 5; ++s) {
                int64_t idx = (b * 5 + s) * G + g;
                int32_t inc = ex[idx] + (s == ref ? m : 0);
                ch |= inc != 0;
                if (inc != 0) {
                    int32_t v = (int32_t)cov[idx] + inc;
                    cov[idx] = (uint16_t)(v > 65535 ? 65535 : v);
                }
            }
        }
        changed[g] = ch ? 1 : 0;
    }
}

}  // namespace

BK_API const char* bk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Rows come in up to two families. Ungated (bits == NULL): family f only,
// read pointers unused. Gated: a family-f (full record) row survives iff
// bits[read] == 1, a family-t (truncated record) row iff bits[read] == 0.
// match_scratch: int32[nb*G], ex_scratch: int32[nb*5*G], zeroed here.
BK_API int bk_coverage_update(
    const void* f_mr_bc, const void* f_mr_g, const void* f_mr_len, const void* f_mr_read, int64_t n_f_mr,
    const void* t_mr_bc, const void* t_mr_g, const void* t_mr_len, const void* t_mr_read, int64_t n_t_mr,
    const void* f_ex_bcsym, const void* f_ex_g, const void* f_ex_read, int64_t n_f_ex,
    const void* t_ex_bcsym, const void* t_ex_g, const void* t_ex_read, int64_t n_t_ex,
    const void* bits, int64_t n_bits, const void* seq, void* coverage, void* changed,
    void* match_scratch, void* ex_scratch, int64_t nb, int64_t G, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int32_t* match = (int32_t*)match_scratch;
    int32_t* ex = (int32_t*)ex_scratch;
    const uint8_t* bt = (const uint8_t*)bits;
    BK_CHECK(cudaMemsetAsync(match, 0, sizeof(int32_t) * nb * G, st));
    BK_CHECK(cudaMemsetAsync(ex, 0, sizeof(int32_t) * nb * 5 * G, st));
    if (n_f_mr > 0) {
        match_scatter<<<bk_grid(n_f_mr, 8), 256, 0, st>>>(
            (const uint8_t*)f_mr_bc, (const uint32_t*)f_mr_g, (const uint16_t*)f_mr_len,
            (const uint32_t*)f_mr_read, n_f_mr, bt, n_bits, 1, match, nb * G, G);
        BK_LAUNCHED();
    }
    if (n_t_mr > 0 && bt != nullptr) {
        match_scatter<<<bk_grid(n_t_mr, 8), 256, 0, st>>>(
            (const uint8_t*)t_mr_bc, (const uint32_t*)t_mr_g, (const uint16_t*)t_mr_len,
            (const uint32_t*)t_mr_read, n_t_mr, bt, n_bits, 0, match, nb * G, G);
        BK_LAUNCHED();
    }
    if (n_f_ex > 0) {
        explicit_scatter<<<bk_grid(n_f_ex, 256), 256, 0, st>>>(
            (const uint16_t*)f_ex_bcsym, (const uint32_t*)f_ex_g, (const uint32_t*)f_ex_read, n_f_ex,
            bt, n_bits, 1, ex, nb * 5 * G, G);
        BK_LAUNCHED();
    }
    if (n_t_ex > 0 && bt != nullptr) {
        explicit_scatter<<<bk_grid(n_t_ex, 256), 256, 0, st>>>(
            (const uint16_t*)t_ex_bcsym, (const uint32_t*)t_ex_g, (const uint32_t*)t_ex_read, n_t_ex,
            bt, n_bits, 0, ex, nb * 5 * G, G);
        BK_LAUNCHED();
    }
    combine<<<bk_grid(G, 256), 256, 0, st>>>((const int8_t*)seq, match, ex, (uint16_t*)coverage,
                                             (uint8_t*)changed, nb, G);
    BK_LAUNCHED();
    return 0;
}
