// H5 seed_topn and H6 seed_candidates — minimizer seeding and diagonal
// voting for one length bucket of reads: the device half of the read
// aligner (H5) and of the AEONS all-vs-all overlap search (H6).
//
// Replaces: bossruns_tpu/aligner/seed.py:273-370 (_seed_topn_jit, K8) with
// its stages read_minimizers (:157), compact_minimizers (:185), the
// sort-join index lookup _lookup_join (:196) and the staggered-grid vote
// _vote (:231). Output row for output row the same int32
// [6 * ncand, R] block: row c*6 + i holds field i (strand, bkey, votes,
// dspan, qmin, qmax) of candidate c, placeholders included.
// H6 replaces bossruns_tpu/aligner/seed.py:410-469 (_seed_candidates_jit,
// K9): the same stages, then per strand space its own sort, vote with a
// caller-given tolerance and ncand peel rounds. Output entry for entry the
// same int32 [R, 6, 2 * ncand] block (votes, strand, qmin, qmax, tmin,
// tmax; column s * ncand + c is round c of space s), placeholders
// included and unclamped.
//
// Bound on the H100: the reads (R x L bytes) and the output are a few MB,
// so bytes bind nothing; block barriers and shared-memory traffic do. A
// read of the L=512 decision pass has ~130 minimizers and on the order of
// a hundred real anchors per strand space out of the 1024 anchor slots of
// its budget, so the design spends its barriers on real anchors only.
//
// Design: one launch, one block per read.
//   1. The read's minimizers are found tile by tile in shared memory (its
//      codes, the 2(w-1) halo hashes), compacted in position order with a
//      block scan, and the scan stops once `budget` are found: no [R, n]
//      minimizer array in device memory, no second launch, and a long read
//      hashes only the prefix that fills its budget.
//   2. Each minimizer is looked up in the sorted keys through a
//      direct-address table on the key's high bits (DeviceIndex.bucket_off):
//      the bucket bounds, then a binary search of its few keys, where a
//      search of the whole table took ~21 dependent loads. Hit and rank are
//      those of the sorted search.
//   3. Per strand space, only the anchors that exist are appended (a
//      shared-memory counter) as (diagonal, slot) 64-bit keys and
//      bitonic-sorted over the next power of two above their count. The
//      slot is the tie-break, which equals the stable sort of the plain
//      version and of jax.lax.sort; SENTINEL slots sort after every real
//      diagonal (the wrappers check that no anchor reaches it), so the kept
//      cw prefix is the sorted real anchors followed by SENTINELs, and
//      votes, peels and placeholders are unchanged while the sorts, votes
//      and peels touch real anchors only.
//   4. Votes count anchors in the key's bucket of either staggered grid of
//      width 2 * tol by binary search over the kept anchors; H5 peels ncand
//      clusters jointly over both spaces, H6 space by space (76 KB of shared
//      memory at budget 1024: one space's sort keys plus its kept keys,
//      read positions, genome positions and votes; an anchor's genome
//      position is re-read from pos_packed by its slot).
// Negative diagonals are floor-divided; uint32 hashing wraps in uint32_t;
// argmax ties go to the first index and strand ties to the forward space,
// as in the JAX functions.
#include "common.cuh"

namespace {

constexpr int OCC = 4;                        // OCC_CAP
constexpr int TOL = 256;                      // DIAG_TOL
constexpr int32_t SENT = 2130706432;          // 2^31 - 2^24
constexpr int32_t HMAX = 0x7fffffff;
constexpr int32_t BIG = 1 << 30;
constexpr uint32_t PAD = 0xffffffffu;
constexpr int MAX_K = 15;
constexpr int MAX_W = 16;
constexpr int VOTE_THREADS = 256;             // threads per read, positions per scan tile
constexpr int HALO = MAX_W - 1;

__device__ __forceinline__ uint32_t hash31(uint32_t h) {
    h ^= h >> 16;
    h *= 0x45D9F3Bu;
    h ^= h >> 16;
    h *= 0x45D9F3Bu;
    h ^= h >> 16;
    return h >> 1;
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && (a < 0)) --q;
    return q;
}

// first index in s[0, n) with s[i] >= x (s ascending)
__device__ __forceinline__ int lower_bound(const int32_t* s, int n, int64_t x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if ((int64_t)s[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// the block-wide maxima of N values at once (one pair of barriers for all
// N); every thread gets them. `smem` holds 32 * N values.
template <int N, typename T>
__device__ __forceinline__ void block_max(T (&v)[N], T* smem) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = max(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
    __syncthreads();
    if (lane == 0)
#pragma unroll
        for (int i = 0; i < N; ++i) smem[warp * N + i] = v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < N; ++i) {
        v[i] = smem[i];
        for (int j = 1; j < nw; ++j) v[i] = max(v[i], smem[j * N + i]);
    }
}

// (vote, index) -> one int64 whose max is the largest vote, first index
__device__ __forceinline__ long long pack_arg(int32_t v, int i) {
    return (long long)v * 4294967296LL + (long long)(0xffffffffu - (uint32_t)i);
}

// 1. the first a minimizers of the read (codes row[0, L)) in position order
// into s_cs (canonical << 1 | strand) and s_cpos; returns their count.
// Positions are hashed VOTE_THREADS at a time with their window halo.
__device__ int scan_minimizers(const int8_t* __restrict__ row, int L, int k, int w, int a,
                               int32_t* s_cs, int32_t* s_cpos) {
    __shared__ int8_t s_code[VOTE_THREADS + 2 * HALO + MAX_K];
    __shared__ int32_t s_h[VOTE_THREADS + 2 * HALO];
    __shared__ int32_t s_c[VOTE_THREADS + 2 * HALO];
    __shared__ int s_count;
    __shared__ int s_wtot[32];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = VOTE_THREADS >> 5;
    const int n = L - k + 1, h = w - 1;
    const int npos = VOTE_THREADS + 2 * h, ncode = npos + k - 1;
    if (t == 0) s_count = 0;
    for (int base = 0; base < n; base += VOTE_THREADS) {
        const int lo = base - h;               // first position whose hash is needed
        for (int i = t; i < ncode; i += VOTE_THREADS) {
            int p = lo + i;
            s_code[i] = (p >= 0 && p < L) ? row[p] : (int8_t)4;
        }
        __syncthreads();
        for (int i = t; i < npos; i += VOTE_THREADS) {
            int p = lo + i;
            uint32_t fwd = 0, rc = 0;
            bool ok = p >= 0 && p < n;
            for (int j = 0; j < k; ++j) {
                int c = s_code[i + j];
                ok &= c < 4;
                fwd = (fwd << 2) | (uint32_t)(c & 3);
                rc = (rc << 2) | (uint32_t)(3 - (s_code[i + k - 1 - j] & 3));
            }
            ok &= fwd != rc;
            uint32_t can = fwd < rc ? fwd : rc;
            s_h[i] = ok ? (int32_t)hash31(can ^ (can >> 15)) : HMAX;
            s_c[i] = ok ? (int32_t)((can << 1) | (rc < fwd ? 1u : 0u)) : -1;
        }
        __syncthreads();
        const int p = base + t, i = t + h;
        int32_t v = -1;
        if (p < n) {
            int32_t m = s_h[i];
            for (int j = t; j <= t + 2 * h; ++j) m = min(m, s_h[j]);
            if (s_c[i] >= 0 && s_h[i] == m) v = s_c[i];
        }
        const bool f = v >= 0;
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        const int lp = __popc(bal & ((1u << lane) - 1u));
        if (lane == 0) s_wtot[warp] = __popc(bal);
        __syncthreads();
        int wp = 0, tot = 0;
        for (int j = 0; j < nw; ++j) {
            int c = s_wtot[j];
            if (j < warp) wp += c;
            tot += c;
        }
        const int slot = s_count + wp + lp;
        if (f && slot < a) {
            s_cs[slot] = v;
            s_cpos[slot] = p;
        }
        __syncthreads();
        if (t == 0) s_count += tot;
        __syncthreads();
        if (s_count >= a) break;
    }
    return min(s_count, a);
}

// 2. each minimizer's row in the sorted keys (-1 on a miss): its bucket of
// the direct-address table on the key's high bits, then a binary search
// for the last key <= the query inside the bucket
__device__ void lookup_ranks(int nmin, const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ boff, int shift, int nbk,
                             const int32_t* s_cs, int32_t* s_rank) {
    for (int j = threadIdx.x; j < nmin; j += blockDim.x) {
        const int32_t q = s_cs[j] >> 1;
        const int b = min(q >> shift, nbk - 1);
        const int first = boff[b];
        int lo = first, hi = boff[b + 1];
        while (lo < hi) {
            int mid = (lo + hi) >> 1;
            if (keys[mid] <= q) lo = mid + 1; else hi = mid;
        }
        s_rank[j] = (lo > first && keys[lo - 1] == q) ? lo - 1 : -1;
    }
    __syncthreads();
}

__device__ __forceinline__ unsigned long long sort_key(int32_t key, int e) {
    return ((unsigned long long)((uint32_t)key ^ 0x80000000u) << 32) | (uint32_t)e;
}

__device__ __forceinline__ int32_t sorted_key(unsigned long long c) {
    return (int32_t)((uint32_t)(c >> 32) ^ 0x80000000u);
}

// 3. the anchors of strand space s that exist, as (diagonal, slot) keys,
// sorted ascending in s_sort[0, count); returns count
__device__ int gather_space(int s, int nmin, const uint32_t* __restrict__ packed,
                            const int32_t* s_cs, const int32_t* s_cpos, const int32_t* s_rank,
                            unsigned long long* s_sort) {
    __shared__ int s_n;
    const int t = threadIdx.x;
    if (t == 0) s_n = 0;
    __syncthreads();
    for (int e = t; e < nmin * OCC; e += blockDim.x) {
        const int j = e >> 2;
        if (s_rank[j] < 0) continue;
        const uint32_t pk = packed[(int64_t)s_rank[j] * OCC + (e & 3)];
        if (pk == PAD) continue;
        const int32_t gpos = (int32_t)(pk >> 1);
        const bool same = (int32_t)(pk & 1u) == (s_cs[j] & 1);
        if (same != (s == 0)) continue;
        const int32_t key = s == 0 ? gpos - s_cpos[j] : gpos + s_cpos[j];
        s_sort[atomicAdd(&s_n, 1)] = sort_key(key, e);
    }
    __syncthreads();
    const int nr = s_n;
    int P = 1;
    while (P < nr) P <<= 1;
    for (int i = nr + t; i < P; i += blockDim.x) s_sort[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = t; i < P / 2; i += blockDim.x) {
                int lo = 2 * i - (i & (stride - 1));
                int hi = lo + stride;
                bool asc = (lo & size) == 0;
                unsigned long long x = s_sort[lo], y = s_sort[hi];
                if ((x > y) == asc) {
                    s_sort[lo] = y;
                    s_sort[hi] = x;
                }
            }
            __syncthreads();
        }
    }
    return nr;
}

// 4. votes of a real key of one space: anchors sharing its bucket of either
// staggered grid of width 2 * tol. row[0, kept) are the kept real keys,
// sorted; the cw-wide row they stand for holds SENTINELs after them.
__device__ __forceinline__ int32_t bucket_votes(const int32_t* row, int kept, int cw, int64_t key,
                                                int64_t tol) {
    auto lb = [&](int64_t x) { return x > SENT ? cw : lower_bound(row, kept, x); };
    int64_t b0 = floor_div(key, 2 * tol) * (2 * tol);
    int64_t b1 = floor_div(key + tol, 2 * tol) * (2 * tol) - tol;
    int c0 = lb(b0 + 2 * tol) - lb(b0);
    int c1 = lb(b1 + 2 * tol) - lb(b1);
    return max(c0, c1);
}

__global__ void __launch_bounds__(VOTE_THREADS)
seed_vote(const int8_t* __restrict__ reads, int L, int k, int w, int a, int ncand,
          const int32_t* __restrict__ keys, const int32_t* __restrict__ boff, int shift, int nbk,
          const uint32_t* __restrict__ packed, int32_t* __restrict__ out, int64_t R) {
    extern __shared__ unsigned long long s_dyn[];
    const int na = a * OCC;                    // anchor slots per strand space
    const int cw = na / 2;                     // kept after the sort
    unsigned long long* s_sort = s_dyn;        // [na]
    int32_t* s_cs = (int32_t*)(s_sort + na);   // [a] canonical << 1 | strand
    int32_t* s_cpos = s_cs + a;                // [a]
    int32_t* s_rank = s_cpos + a;              // [a] index row, -1 on a miss
    int32_t* s_key = s_rank + a;               // [2][cw]
    int32_t* s_rp = s_key + 2 * cw;            // [2][cw]
    int32_t* s_vote = s_rp + 2 * cw;           // [2][cw]
    __shared__ long long s_red64[32 * 2];
    __shared__ int32_t s_red32[32 * 4];

    const int64_t r = blockIdx.x;
    const int t = threadIdx.x;
    const int nmin = scan_minimizers(reads + r * L, L, k, w, a, s_cs, s_cpos);
    lookup_ranks(nmin, keys, boff, shift, nbk, s_cs, s_rank);

    // 3. per strand space: the real anchors' diagonals, sorted by (diagonal, slot)
    int kept[2];
    for (int s = 0; s < 2; ++s) {
        kept[s] = min(gather_space(s, nmin, packed, s_cs, s_cpos, s_rank, s_sort), cw);
        for (int i = t; i < kept[s]; i += blockDim.x) {
            unsigned long long c = s_sort[i];
            s_key[s * cw + i] = sorted_key(c);
            s_rp[s * cw + i] = s_cpos[(int)(c & 0xffffffffu) >> 2];
        }
        if (t == 0 && kept[s] == 0) s_key[s * cw] = SENT;   // an empty space's placeholder
        __syncthreads();
    }

    // 4. votes: anchors in the same bucket of either staggered grid
    for (int s = 0; s < 2; ++s)
        for (int i = t; i < kept[s]; i += blockDim.x)
            s_vote[s * cw + i] = bucket_votes(s_key + s * cw, kept[s], cw, s_key[s * cw + i], TOL);
    __syncthreads();

    // 5. peel ncand clusters jointly over both strand spaces; a slot past
    // the kept anchors votes -1, as does entry 0 at the latest
    for (int c = 0; c < ncand; ++c) {
        long long best[2] = {pack_arg(-1, 0), pack_arg(-1, 0)};
        for (int i = t; i < kept[0]; i += blockDim.x) best[0] = max(best[0], pack_arg(s_vote[i], i));
        for (int i = t; i < kept[1]; i += blockDim.x)
            best[1] = max(best[1], pack_arg(s_vote[cw + i], i));
        block_max(best, s_red64);
        const long long bf = best[0], br = best[1];
        int32_t vf = (int32_t)floor_div(bf, 4294967296LL);
        int32_t vr = (int32_t)floor_div(br, 4294967296LL);
        int ibf = (int)(0xffffffffu - (uint32_t)(bf & 0xffffffffLL));
        int ibr = (int)(0xffffffffu - (uint32_t)(br & 0xffffffffLL));
        bool rev = vr > vf;
        int32_t votes = max(vf, vr);
        const int kp = kept[rev ? 1 : 0];
        const int32_t* krow = s_key + (rev ? cw : 0);
        const int32_t* prow = s_rp + (rev ? cw : 0);
        int32_t* vrow = s_vote + (rev ? cw : 0);
        int64_t key_i = krow[rev ? ibr : ibf];
        // cluster extents as maxima: dmax, -dmin, qmax, -qmin
        int32_t ext[4] = {-BIG, -BIG, -BIG, -BIG};
        for (int i = t; i < kp; i += blockDim.x) {
            int64_t kc = krow[i];
            int64_t d = kc > key_i ? kc - key_i : key_i - kc;
            if (d <= TOL) {
                ext[0] = max(ext[0], (int32_t)kc);
                ext[1] = max(ext[1], -(int32_t)kc);
                ext[2] = max(ext[2], prow[i]);
                ext[3] = max(ext[3], -prow[i]);
            }
        }
        block_max(ext, s_red32);
        const int32_t dmax = ext[0], dmin = -ext[1], qmax = ext[2], qmin = -ext[3];
        if (t == 0) {
            int32_t* o = out + (int64_t)c * 6 * R + r;
            int64_t span = (int64_t)dmax - (int64_t)dmin;
            o[0] = rev ? 1 : 0;
            o[R] = (int32_t)key_i;
            o[2 * R] = votes;
            o[3 * R] = span > 0 ? (int32_t)span : 0;
            o[4 * R] = max(qmin, 0);
            o[5 * R] = max(qmax, 0);
        }
        for (int i = t; i < kp; i += blockDim.x) {
            int64_t kc = krow[i];
            int64_t d = kc > key_i ? kc - key_i : key_i - kc;
            if (d <= 2 * TOL) vrow[i] = -1;
        }
        __syncthreads();
    }
}


// H6: per strand space on its own, sort, vote with tolerance tol and peel
// ncand rounds; out[r, f, s * ncand + c]
__global__ void __launch_bounds__(VOTE_THREADS)
cand_vote(const int8_t* __restrict__ reads, int L, int k, int w, int a, int ncand, int tol,
          const int32_t* __restrict__ keys, const int32_t* __restrict__ boff, int shift, int nbk,
          const uint32_t* __restrict__ packed, int32_t* __restrict__ out) {
    extern __shared__ unsigned long long s_dyn[];
    const int na = a * OCC;
    const int cw = na / 2;
    unsigned long long* s_sort = s_dyn;        // [na]
    int32_t* s_cs = (int32_t*)(s_sort + na);   // [a]
    int32_t* s_cpos = s_cs + a;                // [a]
    int32_t* s_rank = s_cpos + a;              // [a]
    int32_t* s_key = s_rank + a;               // [cw] this space's kept diagonals
    int32_t* s_rp = s_key + cw;                // [cw] read positions
    int32_t* s_gp = s_rp + cw;                 // [cw] genome positions
    int32_t* s_vote = s_gp + cw;               // [cw]
    __shared__ long long s_red64[32];
    __shared__ int32_t s_red32[32 * 4];

    const int64_t r = blockIdx.x;
    const int t = threadIdx.x;
    const int64_t tl = tol;
    const int nmin = scan_minimizers(reads + r * L, L, k, w, a, s_cs, s_cpos);
    lookup_ranks(nmin, keys, boff, shift, nbk, s_cs, s_rank);
    int32_t* orow = out + r * 6 * (2 * ncand);

    for (int s = 0; s < 2; ++s) {
        const int kp = min(gather_space(s, nmin, packed, s_cs, s_cpos, s_rank, s_sort), cw);
        for (int i = t; i < kp; i += blockDim.x) {
            unsigned long long c = s_sort[i];
            int e = (int)(c & 0xffffffffu);
            s_key[i] = sorted_key(c);
            s_rp[i] = s_cpos[e >> 2];
            s_gp[i] = (int32_t)(packed[(int64_t)s_rank[e >> 2] * OCC + (e & 3)] >> 1);
        }
        if (t == 0 && kp == 0) s_key[0] = SENT;   // an empty space's placeholder
        __syncthreads();
        for (int i = t; i < kp; i += blockDim.x) s_vote[i] = bucket_votes(s_key, kp, cw, s_key[i], tl);
        __syncthreads();
        for (int c = 0; c < ncand; ++c) {
            long long best[1] = {pack_arg(-1, 0)};
            for (int i = t; i < kp; i += blockDim.x) best[0] = max(best[0], pack_arg(s_vote[i], i));
            block_max(best, s_red64);
            const long long bp = best[0];
            int32_t bvote = (int32_t)floor_div(bp, 4294967296LL);
            int ib = (int)(0xffffffffu - (uint32_t)(bp & 0xffffffffLL));
            int64_t bkey = s_key[ib];
            // cluster extents as maxima: qmax, -qmin, tmax, -tmin
            int32_t ext[4] = {-BIG, -BIG, -BIG, -BIG};
            for (int i = t; i < kp; i += blockDim.x) {
                int64_t kc = s_key[i];
                int64_t d = kc > bkey ? kc - bkey : bkey - kc;
                if (d <= tl) {
                    ext[0] = max(ext[0], s_rp[i]);
                    ext[1] = max(ext[1], -s_rp[i]);
                    ext[2] = max(ext[2], s_gp[i]);
                    ext[3] = max(ext[3], -s_gp[i]);
                }
            }
            block_max(ext, s_red32);
            const int32_t qmax = ext[0], qmin = -ext[1], tmax = ext[2], tmin = -ext[3];
            if (t == 0) {
                int col = s * ncand + c, w2 = 2 * ncand;
                orow[0 * w2 + col] = bvote;
                orow[1 * w2 + col] = s;
                orow[2 * w2 + col] = qmin;
                orow[3 * w2 + col] = qmax;
                orow[4 * w2 + col] = tmin;
                orow[5 * w2 + col] = tmax;
            }
            for (int i = t; i < kp; i += blockDim.x) {
                int64_t kc = s_key[i];
                int64_t d = kc > bkey ? kc - bkey : bkey - kc;
                if (d <= 2 * tl) s_vote[i] = -1;
            }
            __syncthreads();
        }
    }
}

bool seed_shape_ok(int64_t R, int L, int k, int w, int budget, int ncand, int shift, int nbk) {
    int n = L - k + 1;
    return R > 0 && R <= 0x7fffffffLL && k >= 1 && k <= MAX_K && w >= 1 && w <= MAX_W &&
           n >= w && budget >= 64 && budget <= n && (budget & (budget - 1)) == 0 &&
           budget <= 1024 && ncand >= 1 && shift >= 0 && shift <= 30 && nbk >= 1;
}

}  // namespace

BK_API int bk_seed_topn(const int8_t* reads, int64_t R, int L, int k, int w, int budget,
                        int ncand, const int32_t* keys, const int32_t* boff, int shift, int nbk,
                        const uint32_t* packed, int32_t* out, cudaStream_t stream) {
    if (!seed_shape_ok(R, L, k, w, budget, ncand, shift, nbk)) return -1;
    int na = budget * OCC;
    size_t smem = (size_t)na * 8 + (size_t)budget * 12 + (size_t)na * 12;
    BK_CHECK(cudaFuncSetAttribute(seed_vote, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
    seed_vote<<<(unsigned)R, VOTE_THREADS, smem, stream>>>(reads, L, k, w, budget, ncand, keys,
                                                          boff, shift, nbk, packed, out, R);
    BK_LAUNCHED();
    return 0;
}

BK_API int bk_seed_candidates(const int8_t* reads, int64_t R, int L, int k, int w, int budget,
                              int ncand, int tol, const int32_t* keys, const int32_t* boff,
                              int shift, int nbk, const uint32_t* packed, int32_t* out,
                              cudaStream_t stream) {
    if (!seed_shape_ok(R, L, k, w, budget, ncand, shift, nbk) || ncand > 8 || tol < 1 ||
        tol > (1 << 24))
        return -1;
    int na = budget * OCC;
    size_t smem = (size_t)na * 8 + (size_t)budget * 12 + (size_t)(na / 2) * 16;
    BK_CHECK(cudaFuncSetAttribute(cand_vote, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
    cand_vote<<<(unsigned)R, VOTE_THREADS, smem, stream>>>(reads, L, k, w, budget, ncand, tol,
                                                          keys, boff, shift, nbk, packed, out);
    BK_LAUNCHED();
    return 0;
}
