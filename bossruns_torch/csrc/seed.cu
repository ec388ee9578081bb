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
// Bound on the H100: at 4000 reads x L=512 (the mu=400 decision pass) the
// per-read work is small (~200 minimizers, two 1024-key sorts), so the
// block-wide sorts, the barriers between their stages and the per-block
// reductions of the four peel rounds bound it, not bytes: the reads are
// 2 MB and the index lookups hit an L2-resident key table (~11 MB at an
// 8 Mb genome, k13/w5). At L >= 4096 the 1024-slot budget makes each
// block's binary searches into the key table (about 22 dependent loads per
// slot) and its 4096-key sorts the bound, with two blocks per SM for lack
// of shared memory. H6 runs at L = 8192 and 32768 with the full budget:
// its first launch streams R x L codes (16 MB per 500 reads at 32768), its
// second does two 4096-key sorts per read, so the sorts and their barriers
// bound it as they bound H5 at L >= 4096.
//
// Design: two launches. seed_minimizers: one thread per (read, position);
// a block stages its tile of codes and the 2(w-1) halo hashes in shared
// memory and writes (canonical << 1 | strand) where the position is a
// minimizer, -1 elsewhere. seed_vote (H5) and cand_vote (H6): one block per
// read. It compacts the first `budget` minimizers with a block scan,
// binary-searches each in the sorted keys (a hit is all that matters), and
// for each strand space bitonic-sorts (diagonal, anchor slot) pairs as
// 64-bit keys in shared memory (the slot is the tie-break, which equals the
// stable sort of the plain version and of jax.lax.sort), keeps the cw
// smallest, counts votes by binary search over the two staggered grids,
// and peels ncand clusters with block reductions. H5 votes both spaces and
// peels them jointly; H6 sorts, votes and peels one space at a time (76 KB
// of shared memory at budget 1024, one space's 4096 sort keys plus its
// kept keys, read positions, genome positions and votes) and re-reads an
// anchor's genome position from pos_packed by its slot. Negative diagonals
// are floor-divided; uint32 hashing wraps in uint32_t; argmax ties go to
// the first index and strand ties to the forward space, as in the JAX
// functions.
#include <climits>

#include "common.cuh"

namespace {

constexpr int OCC = 4;                        // OCC_CAP
constexpr int TOL = 256;                      // DIAG_TOL
constexpr int32_t SENT = 2130706432;          // 2^31 - 2^24
constexpr int32_t HMAX = 0x7fffffff;
constexpr int32_t BIG = 1 << 30;
constexpr uint32_t PAD = 0xffffffffu;
constexpr int TILE = 256;
constexpr int MAX_K = 15;
constexpr int MAX_W = 16;
constexpr int VOTE_THREADS = 256;

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

__global__ void seed_minimizers(const int8_t* __restrict__ reads, int64_t R, int L, int k,
                                int w, int n, int tiles, int32_t* __restrict__ mins) {
    __shared__ int8_t s_code[TILE + 2 * (MAX_W - 1) + MAX_K];
    __shared__ int32_t s_h[TILE + 2 * (MAX_W - 1)];
    __shared__ int32_t s_cs[TILE + 2 * (MAX_W - 1)];
    __shared__ uint8_t s_ok[TILE + 2 * (MAX_W - 1)];
    int64_t r = blockIdx.x / tiles;
    int tile = blockIdx.x % tiles;
    int t = threadIdx.x;
    int base = tile * TILE - (w - 1);          // first position whose hash is needed
    int npos = TILE + 2 * (w - 1);
    int ncode = npos + k - 1;
    const int8_t* row = reads + r * L;
    for (int i = t; i < ncode; i += TILE) {
        int p = base + i;
        s_code[i] = (p >= 0 && p < L) ? row[p] : (int8_t)4;
    }
    __syncthreads();
    for (int i = t; i < npos; i += TILE) {
        int p = base + i;
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
        s_ok[i] = ok;
        s_h[i] = ok ? (int32_t)hash31(can ^ (can >> 15)) : HMAX;
        s_cs[i] = (int32_t)((can << 1) | (rc < fwd ? 1u : 0u));
    }
    __syncthreads();
    int p = tile * TILE + t;
    if (p >= n) return;
    int i = t + (w - 1);
    int32_t m = s_h[i];
    for (int j = i - (w - 1); j <= i + (w - 1); ++j) m = min(m, s_h[j]);
    mins[r * n + p] = (s_ok[i] && s_h[i] == m) ? s_cs[i] : -1;
}

template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, T* smem, Op op) {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int nw = blockDim.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if (lane == 0) smem[warp] = v;
    __syncthreads();
    T out = smem[0];
    for (int i = 1; i < nw; ++i) out = op(out, smem[i]);
    return out;
}

struct MaxOp {
    template <typename T> __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct MinOp {
    template <typename T> __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};

// (vote, index) -> one int64 whose max is the largest vote, first index
__device__ __forceinline__ long long pack_arg(int32_t v, int i) {
    return (long long)v * 4294967296LL + (long long)(0xffffffffu - (uint32_t)i);
}

// 1-2. the first a minimizers of the read in position order (block scan per
// chunk) into s_cs/s_cpos, and each one's row in the sorted keys (-1 on a
// miss) into s_rank. Returns their count.
__device__ int compact_and_lookup(const int32_t* __restrict__ mrow, int n, int a,
                                  const int32_t* __restrict__ keys, int64_t U,
                                  int32_t* s_cs, int32_t* s_cpos, int32_t* s_rank) {
    __shared__ int s_count;
    __shared__ int s_wtot[32];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = blockDim.x >> 5;
    if (t == 0) s_count = 0;
    __syncthreads();
    for (int base = 0; base < n; base += blockDim.x) {
        int p = base + t;
        int32_t v = p < n ? mrow[p] : -1;
        bool f = v >= 0;
        unsigned bal = __ballot_sync(0xffffffffu, f);
        int lp = __popc(bal & ((1u << lane) - 1u));
        if (lane == 0) s_wtot[warp] = __popc(bal);
        __syncthreads();
        int wp = 0, tot = 0;
        for (int i = 0; i < nw; ++i) {
            int c = s_wtot[i];
            if (i < warp) wp += c;
            tot += c;
        }
        int slot = s_count + wp + lp;
        if (f && slot < a) {
            s_cs[slot] = v;
            s_cpos[slot] = p;
        }
        __syncthreads();
        if (t == 0) s_count += tot;
        __syncthreads();
        if (s_count >= a) break;
    }
    const int nmin = min(s_count, a);
    for (int j = t; j < nmin; j += blockDim.x) {
        int32_t q = s_cs[j] >> 1;
        int64_t lo = 0, hi = U;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (keys[mid] < q) lo = mid + 1; else hi = mid;
        }
        s_rank[j] = (lo < U && keys[lo] == q) ? (int32_t)lo : -1;
    }
    __syncthreads();
    return nmin;
}

// 3. the anchors of strand space s as (diagonal, slot) 64-bit keys in
// s_sort[0, na), sorted ascending (bitonic, na a power of two)
__device__ void sort_space(int s, int na, int nmin, const uint32_t* __restrict__ packed,
                           const int32_t* s_cs, const int32_t* s_cpos, const int32_t* s_rank,
                           unsigned long long* s_sort) {
    const int t = threadIdx.x;
    for (int e = t; e < na; e += blockDim.x) {
        int j = e >> 2;
        int32_t key = SENT;
        if (j < nmin && s_rank[j] >= 0) {
            uint32_t pk = packed[(int64_t)s_rank[j] * OCC + (e & 3)];
            if (pk != PAD) {
                int32_t gpos = (int32_t)(pk >> 1);
                bool same = (int32_t)(pk & 1u) == (s_cs[j] & 1);
                if (s == 0 && same) key = gpos - s_cpos[j];
                if (s == 1 && !same) key = gpos + s_cpos[j];
            }
        }
        s_sort[e] = ((unsigned long long)((uint32_t)key ^ 0x80000000u) << 32) | (uint32_t)e;
    }
    __syncthreads();
    for (int size = 2; size <= na; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = t; i < na / 2; i += blockDim.x) {
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
}

__device__ __forceinline__ int32_t sorted_key(unsigned long long c) {
    return (int32_t)((uint32_t)(c >> 32) ^ 0x80000000u);
}

// votes of one sorted, cw-wide space: anchors sharing the key's bucket of
// either staggered grid of width 2 * tol; -1 for SENTINEL keys
__device__ __forceinline__ int32_t bucket_votes(const int32_t* row, int cw, int64_t key,
                                                int64_t tol) {
    if (key >= SENT) return -1;
    int64_t b0 = floor_div(key, 2 * tol) * (2 * tol);
    int64_t b1 = floor_div(key + tol, 2 * tol) * (2 * tol) - tol;
    int c0 = lower_bound(row, cw, b0 + 2 * tol) - lower_bound(row, cw, b0);
    int c1 = lower_bound(row, cw, b1 + 2 * tol) - lower_bound(row, cw, b1);
    return max(c0, c1);
}

__global__ void seed_vote(const int32_t* __restrict__ mins, int n, int a, int ncand,
                          const int32_t* __restrict__ keys, int64_t U,
                          const uint32_t* __restrict__ packed, int32_t* __restrict__ out,
                          int64_t R) {
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
    __shared__ long long s_red64[32];
    __shared__ int32_t s_red32[32];

    const int64_t r = blockIdx.x;
    const int t = threadIdx.x;
    const int nmin = compact_and_lookup(mins + r * n, n, a, keys, U, s_cs, s_cpos, s_rank);

    // 3. per strand space: anchors' diagonals, sorted by (diagonal, slot)
    for (int s = 0; s < 2; ++s) {
        sort_space(s, na, nmin, packed, s_cs, s_cpos, s_rank, s_sort);
        for (int i = t; i < cw; i += blockDim.x) {
            unsigned long long c = s_sort[i];
            int32_t key = sorted_key(c);
            int e = (int)(c & 0xffffffffu);
            s_key[s * cw + i] = key;
            s_rp[s * cw + i] = key < SENT ? s_cpos[e >> 2] : 0;
        }
        __syncthreads();
    }

    // 4. votes: anchors in the same bucket of either staggered grid
    for (int i = t; i < 2 * cw; i += blockDim.x)
        s_vote[i] = bucket_votes(s_key + (i / cw) * cw, cw, s_key[i], TOL);
    __syncthreads();

    // 5. peel ncand clusters jointly over both strand spaces
    for (int c = 0; c < ncand; ++c) {
        long long bf = LLONG_MIN, br = LLONG_MIN;
        for (int i = t; i < cw; i += blockDim.x) {
            bf = MaxOp()(bf, pack_arg(s_vote[i], i));
            br = MaxOp()(br, pack_arg(s_vote[cw + i], i));
        }
        bf = block_reduce(bf, s_red64, MaxOp());
        br = block_reduce(br, s_red64, MaxOp());
        int32_t vf = (int32_t)floor_div(bf, 4294967296LL);
        int32_t vr = (int32_t)floor_div(br, 4294967296LL);
        int ibf = (int)(0xffffffffu - (uint32_t)(bf & 0xffffffffLL));
        int ibr = (int)(0xffffffffu - (uint32_t)(br & 0xffffffffLL));
        bool rev = vr > vf;
        int32_t votes = max(vf, vr);
        const int32_t* krow = s_key + (rev ? cw : 0);
        const int32_t* prow = s_rp + (rev ? cw : 0);
        int32_t* vrow = s_vote + (rev ? cw : 0);
        int64_t key_i = krow[rev ? ibr : ibf];
        int32_t dmax = -BIG, dmin = BIG, qmax = -BIG, qmin = BIG;
        for (int i = t; i < cw; i += blockDim.x) {
            int64_t kc = krow[i];
            int64_t d = kc > key_i ? kc - key_i : key_i - kc;
            if (kc < SENT && d <= TOL) {
                dmax = max(dmax, (int32_t)kc);
                dmin = min(dmin, (int32_t)kc);
                qmax = max(qmax, prow[i]);
                qmin = min(qmin, prow[i]);
            }
        }
        dmax = block_reduce(dmax, s_red32, MaxOp());
        dmin = block_reduce(dmin, s_red32, MinOp());
        qmax = block_reduce(qmax, s_red32, MaxOp());
        qmin = block_reduce(qmin, s_red32, MinOp());
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
        for (int i = t; i < cw; i += blockDim.x) {
            int64_t kc = krow[i];
            int64_t d = kc > key_i ? kc - key_i : key_i - kc;
            if (d <= 2 * TOL) vrow[i] = -1;
        }
        __syncthreads();
    }
}


// H6: per strand space on its own, sort, vote with tolerance tol and peel
// ncand rounds; out[r, f, s * ncand + c]
__global__ void cand_vote(const int32_t* __restrict__ mins, int n, int a, int ncand, int tol,
                          const int32_t* __restrict__ keys, int64_t U,
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
    __shared__ int32_t s_red32[32];

    const int64_t r = blockIdx.x;
    const int t = threadIdx.x;
    const int64_t tl = tol;
    const int nmin = compact_and_lookup(mins + r * n, n, a, keys, U, s_cs, s_cpos, s_rank);
    int32_t* orow = out + r * 6 * (2 * ncand);

    for (int s = 0; s < 2; ++s) {
        sort_space(s, na, nmin, packed, s_cs, s_cpos, s_rank, s_sort);
        for (int i = t; i < cw; i += blockDim.x) {
            unsigned long long c = s_sort[i];
            int32_t key = sorted_key(c);
            int e = (int)(c & 0xffffffffu);
            s_key[i] = key;
            s_rp[i] = 0;
            s_gp[i] = 0;
            if (key < SENT) {
                s_rp[i] = s_cpos[e >> 2];
                s_gp[i] = (int32_t)(packed[(int64_t)s_rank[e >> 2] * OCC + (e & 3)] >> 1);
            }
        }
        __syncthreads();
        for (int i = t; i < cw; i += blockDim.x) s_vote[i] = bucket_votes(s_key, cw, s_key[i], tl);
        __syncthreads();
        for (int c = 0; c < ncand; ++c) {
            long long bp = LLONG_MIN;
            for (int i = t; i < cw; i += blockDim.x) bp = MaxOp()(bp, pack_arg(s_vote[i], i));
            bp = block_reduce(bp, s_red64, MaxOp());
            int32_t bvote = (int32_t)floor_div(bp, 4294967296LL);
            int ib = (int)(0xffffffffu - (uint32_t)(bp & 0xffffffffLL));
            int64_t bkey = s_key[ib];
            int32_t qmax = -BIG, qmin = BIG, tmax = -BIG, tmin = BIG;
            for (int i = t; i < cw; i += blockDim.x) {
                int64_t kc = s_key[i];
                int64_t d = kc > bkey ? kc - bkey : bkey - kc;
                if (kc < SENT && d <= tl) {
                    qmax = max(qmax, s_rp[i]);
                    qmin = min(qmin, s_rp[i]);
                    tmax = max(tmax, s_gp[i]);
                    tmin = min(tmin, s_gp[i]);
                }
            }
            qmin = block_reduce(qmin, s_red32, MinOp());
            qmax = block_reduce(qmax, s_red32, MaxOp());
            tmin = block_reduce(tmin, s_red32, MinOp());
            tmax = block_reduce(tmax, s_red32, MaxOp());
            if (t == 0) {
                int col = s * ncand + c, w2 = 2 * ncand;
                orow[0 * w2 + col] = bvote;
                orow[1 * w2 + col] = s;
                orow[2 * w2 + col] = qmin;
                orow[3 * w2 + col] = qmax;
                orow[4 * w2 + col] = tmin;
                orow[5 * w2 + col] = tmax;
            }
            for (int i = t; i < cw; i += blockDim.x) {
                int64_t kc = s_key[i];
                int64_t d = kc > bkey ? kc - bkey : bkey - kc;
                if (d <= 2 * tl) s_vote[i] = -1;
            }
            __syncthreads();
        }
    }
}

}  // namespace

BK_API int bk_seed_topn(const int8_t* reads, int64_t R, int L, int k, int w, int budget,
                        int ncand, const int32_t* keys, int64_t U, const uint32_t* packed,
                        int32_t* mins, int32_t* out, cudaStream_t stream) {
    int n = L - k + 1;
    if (R <= 0 || k < 1 || k > MAX_K || w < 1 || w > MAX_W || n < w || budget < 64 ||
        budget > n || (budget & (budget - 1)) != 0 || budget > 1024 || U < 1 || ncand < 1)
        return -1;
    int tiles = (n + TILE - 1) / TILE;
    int64_t blocks = (int64_t)tiles * R;
    if (blocks > 0x7fffffffLL || R > 0x7fffffffLL) return -1;
    seed_minimizers<<<(unsigned)blocks, TILE, 0, stream>>>(reads, R, L, k, w, n, tiles, mins);
    BK_LAUNCHED();
    int na = budget * OCC;
    size_t smem = (size_t)na * 8 + (size_t)budget * 12 + (size_t)na * 12;
    BK_CHECK(cudaFuncSetAttribute(seed_vote, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
    seed_vote<<<(unsigned)R, VOTE_THREADS, smem, stream>>>(mins, n, budget, ncand, keys, U,
                                                          packed, out, R);
    BK_LAUNCHED();
    return 0;
}

BK_API int bk_seed_candidates(const int8_t* reads, int64_t R, int L, int k, int w, int budget,
                              int ncand, int tol, const int32_t* keys, int64_t U,
                              const uint32_t* packed, int32_t* mins, int32_t* out,
                              cudaStream_t stream) {
    int n = L - k + 1;
    if (R <= 0 || k < 1 || k > MAX_K || w < 1 || w > MAX_W || n < w || budget < 64 ||
        budget > n || (budget & (budget - 1)) != 0 || budget > 1024 || U < 1 || ncand < 1 ||
        ncand > 8 || tol < 1 || tol > (1 << 24))
        return -1;
    int tiles = (n + TILE - 1) / TILE;
    int64_t blocks = (int64_t)tiles * R;
    if (blocks > 0x7fffffffLL || R > 0x7fffffffLL) return -1;
    seed_minimizers<<<(unsigned)blocks, TILE, 0, stream>>>(reads, R, L, k, w, n, tiles, mins);
    BK_LAUNCHED();
    int na = budget * OCC;
    size_t smem = (size_t)na * 8 + (size_t)budget * 12 + (size_t)(na / 2) * 16;
    BK_CHECK(cudaFuncSetAttribute(cand_vote, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem));
    cand_vote<<<(unsigned)R, VOTE_THREADS, smem, stream>>>(mins, n, budget, ncand, tol, keys,
                                                          U, packed, out);
    BK_LAUNCHED();
    return 0;
}
