"""Minimizer index of the reference genome (host build, device resident).

A copy of ``bossruns_tpu.aligner.index`` for the port: the module is
host NumPy + SciPy + the native scans and imports no JAX, but importing it
from the JAX package runs ``bossruns_tpu/aligner/__init__.py``, which
imports the JAX seeding module. It replaces minimap2's .mmi index (the
reference delegates index construction to mappy). Canonical (k=15, w=10 —
the map-ont preset's parameters) minimizers of the concatenated padded
genome axis are computed with vectorised NumPy and stored sorted:

    keys [U]      sorted unique canonical k-mer codes (30 bits)
    offsets [U+1] prefix offsets into positions
    positions [S] global site of each minimizer occurrence (+ strand bit)

Matching is exact on the 30-bit k-mer code (the 32-bit mix hash is used only
for minimizer *selection* order, like minimap2's invertible hash), so seed
lookup is a binary search with zero collisions (``seed.DeviceIndex`` holds
the device copy). High-frequency minimizers are dropped (max_occ), mirroring
map-ont's repetitive-seed filtering.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
from scipy.ndimage import minimum_filter1d

K = 15
W = 10
MAX_OCC = 64
INVALID_HASH = np.int32(2**31 - 1)

#: inputs below this skip the threaded native scans (thread spawn overhead)
_SCAN_MT_MIN = 1 << 18


def _scan_threads(n: int) -> int:
    if n < _SCAN_MT_MIN:
        return 1
    import os

    return max(1, min(os.cpu_count() or 1, 4))


def selection_hash(x: np.ndarray) -> np.ndarray:
    """31-bit triple32-style mix; MUST match seed.hash31 (and csrc/seed.cu)
    so host index and device reads select identical minimizers."""
    h = x.astype(np.uint32)
    h ^= h >> 16
    h *= np.uint32(0x45D9F3B)
    h ^= h >> 16
    h *= np.uint32(0x45D9F3B)
    h ^= h >> 16
    return (h >> 1).astype(np.int32)


def kmer_codes(codes: np.ndarray, k: int = K):
    """(fwd, rc) 2-bit packed k-mer codes of a 0..3 int sequence.

    codes may contain values >= 4 (invalid/padding); caller masks those via
    the validity window. Returns int64 arrays of length len(codes)-k+1.
    """
    n = codes.shape[0] - k + 1
    fwd = np.zeros(n, dtype=np.int64)
    rc = np.zeros(n, dtype=np.int64)
    c = codes.astype(np.int64)
    for j in range(k):
        fwd = (fwd << 2) | (c[j : j + n] & 3)
        rc = (rc << 2) | (3 - (c[k - 1 - j : k - 1 - j + n] & 3))
    return fwd, rc


def minimizer_mask(h: np.ndarray, w: int = W) -> np.ndarray:
    """True where position i is the minimum of some w-window (all ties).

    Native monotonic-deque kernel when built (~3x over the scipy two-pass
    form, which dominated per-batch AEONS index rebuilds); the scipy path
    below is the executable spec (pinned equal in tests/test_native_host.py).
    """
    from . import native as native_mod

    lib = native_mod._load()
    if lib and hasattr(lib, "minimizer_mask_c") and h.shape[0]:
        import ctypes

        if not hasattr(lib, "_mmask_ready"):
            lib.minimizer_mask_c.restype = None
            lib.minimizer_mask_c.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.minimizer_mask_mt.restype = None
            lib.minimizer_mask_mt.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_int32,
            ]
            lib._mmask_ready = True
        out = np.empty(h.shape[0], np.int8)
        h32 = np.ascontiguousarray(h, np.int32)
        nt = _scan_threads(h.shape[0])
        if nt > 1:
            lib.minimizer_mask_mt(
                h32.ctypes.data_as(ctypes.c_void_p), np.int64(h.shape[0]),
                np.int32(w), out.ctypes.data_as(ctypes.c_void_p), np.int32(nt),
            )
        else:
            lib.minimizer_mask_c(
                h32.ctypes.data_as(ctypes.c_void_p), np.int64(h.shape[0]),
                np.int32(w), out.ctypes.data_as(ctypes.c_void_p),
            )
        return out.astype(bool)
    # wmin[p] = min(h[p : p+w]); i is a minimizer iff h[i] equals the min of
    # a window containing i <=> h[i] == min(wmin[i-w+1 : i+1])
    wmin = minimum_filter1d(h, size=w, mode="nearest", origin=-(w // 2))
    m2 = minimum_filter1d(wmin, size=w, mode="nearest", origin=(w - 1) // 2)
    return h == m2


@dataclasses.dataclass
class MinimizerIndex:
    keys: np.ndarray       # [U] int32 sorted canonical k-mer codes... int64 (30 bits)
    offsets: np.ndarray    # [U+1] int32
    positions: np.ndarray  # [S] int64 global genome position of k-mer start
    strands: np.ndarray    # [S] int8 (1 if the reverse complement is canonical)
    k: int = K
    w: int = W

    @property
    def n_minimizers(self) -> int:
        return int(self.positions.shape[0])


def _kmer_scan_arrays(codes: np.ndarray, k: int):
    """(canonical, strand, h, ok) per k-mer window. One native pass when the
    library is present (native/banded_align.cpp::kmer_scan); the NumPy pipeline
    below is the executable spec (pinned equal in tests/test_native_host.py)."""
    from . import native as native_mod

    n = codes.shape[0] - k + 1
    lib = native_mod._load()
    if lib and hasattr(lib, "kmer_scan") and n > 0:
        import ctypes

        if not hasattr(lib, "_kscan_ready"):
            lib.kmer_scan.restype = None
            lib.kmer_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.kmer_scan_mt.restype = None
            lib.kmer_scan_mt.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32,
            ]
            lib._kscan_ready = True
        canonical = np.empty(n, np.int64)
        strand = np.empty(n, np.int8)
        h = np.empty(n, np.int32)
        ok8 = np.empty(n, np.int8)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        nt = _scan_threads(n)
        if nt > 1:
            lib.kmer_scan_mt(
                c(np.ascontiguousarray(codes, np.int8)), np.int64(codes.shape[0]),
                np.int32(k), c(canonical), c(strand), c(h), c(ok8), np.int32(nt),
            )
        else:
            lib.kmer_scan(
                c(np.ascontiguousarray(codes, np.int8)), np.int64(codes.shape[0]),
                np.int32(k), c(canonical), c(strand), c(h), c(ok8),
            )
        return canonical, strand, h, ok8.astype(bool)

    fwd, rc = kmer_codes(codes, k)
    ok = np.ones(n, dtype=bool)
    bad = np.flatnonzero(codes >= 4)
    for off in range(k):
        idx = bad - off
        idx = idx[(idx >= 0) & (idx < n)]
        ok[idx] = False
    canonical = np.minimum(fwd, rc)
    strand = (rc < fwd).astype(np.int8)
    ok &= fwd != rc  # skip palindromic k-mers like minimap2
    h = np.where(
        ok,
        selection_hash(canonical.astype(np.uint32) ^ (canonical >> 15).astype(np.uint32)),
        INVALID_HASH,
    )
    return canonical, strand, h, ok


def load_or_build_index(
    seq_int: np.ndarray,
    site_valid: np.ndarray,
    source: str | None,
    k: int = K,
    w: int = W,
    max_occ: int = MAX_OCC,
) -> MinimizerIndex:
    """build_index with an on-disk cache next to the source fasta — the
    reference persists its .mmi the same way (reference.py:295-299). The
    cache invalidates on source mtime/size change or different parameters;
    writes are atomic (per-pid tmp + rename) so concurrent multi-host
    processes can't corrupt each other."""
    if source is None:
        return build_index(seq_int, site_valid, k=k, w=w, max_occ=max_occ)
    from pathlib import Path

    from ..io.sampler import _atomic_np_write, _cache_fresh, _stamp_cache

    src = Path(source)
    cache = Path(f"{source}.minidx.npz")
    if _cache_fresh(src, cache):
        try:
            with np.load(cache) as z:
                if (int(z["k"]), int(z["w"]), int(z["max_occ"])) == (k, w, max_occ):
                    return MinimizerIndex(
                        keys=z["keys"], offsets=z["offsets"],
                        positions=z["positions"], strands=z["strands"], k=k, w=w,
                    )
        except Exception:  # corrupt/foreign cache -> rebuild
            pass
    idx = build_index(seq_int, site_valid, k=k, w=w, max_occ=max_occ)
    try:
        _atomic_np_write(
            cache,
            lambda fh: np.savez(
                fh, keys=idx.keys, offsets=idx.offsets, positions=idx.positions,
                strands=idx.strands, k=k, w=w, max_occ=max_occ,
            ),
        )
        _stamp_cache(src, cache)
    except OSError:  # read-only source dir: cache is best-effort
        pass
    return idx


def _assemble_index(
    keys_all: np.ndarray,
    pos_all: np.ndarray,
    strand_all: np.ndarray,
    k: int,
    w: int,
    max_occ: int,
) -> MinimizerIndex:
    """Sort by key (stable: position order within a key is preserved), group
    into CSR, drop keys over max_occ."""
    order = np.argsort(keys_all, kind="stable")
    keys_sorted = keys_all[order]
    pos_sorted = pos_all[order].astype(np.int64)
    strand_sorted = strand_all[order]
    uniq, start, counts = np.unique(keys_sorted, return_index=True, return_counts=True)
    keep = counts <= max_occ
    # compact: rebuild positions with only kept keys
    seg_ids = np.repeat(keep, counts)
    positions = pos_sorted[seg_ids]
    strands = strand_sorted[seg_ids]
    kept_counts = counts[keep]
    offsets = np.concatenate([[0], np.cumsum(kept_counts)]).astype(np.int64)
    return MinimizerIndex(
        keys=uniq[keep].astype(np.int64),
        offsets=offsets,
        positions=positions,
        strands=strands,
        k=k,
        w=w,
    )


def build_index(
    seq_int: np.ndarray,
    site_valid: np.ndarray,
    k: int = K,
    w: int = W,
    max_occ: int = MAX_OCC,
) -> MinimizerIndex:
    codes = np.where(site_valid, seq_int, 4).astype(np.int8)
    canonical, strand, h, ok = _kmer_scan_arrays(codes, k)
    sel = minimizer_mask(h, w) & ok
    pos = np.flatnonzero(sel)
    return _assemble_index(
        canonical[pos].astype(np.int64), pos.astype(np.int64), strand[pos],
        k, w, max_occ,
    )


#: per-sequence minimizer-scan memo: (content digest, len, k, w) -> (keys,
#: local positions, strands) for the AEONS pool index (build_index_cached),
#: and (content digest, len, k, w, "layout") for build_index_layout's
#: contigs. AEONS rebuilds its pool index every batch over a mostly
#: unchanged sequence set, so each sequence value is scanned once.
#: LRU-bounded: hits refresh an entry's recency and the least-recently-used
#: half is evicted when full.
_SEQ_SCAN_CACHE: dict[tuple, tuple] = {}
_SEQ_SCAN_MAX = 8192
_memo_evictions = 0


def _digest(data: bytes) -> bytes:
    """128-bit content digest for memo keys. Python's process-seeded hash()
    was rejected (ADVICE r4): a 64-bit collision between distinct same-length
    sequences would silently return the wrong scan; blake2b-128 makes the
    collision probability cryptographically negligible at equal key size."""
    import hashlib

    return hashlib.blake2b(data, digest_size=16).digest()


def _memo_get(memo_key: tuple):
    """LRU hit: move the entry to the recent end so pool-resident sequences
    outlive transient ones (plain dicts preserve insertion order)."""
    hit = _SEQ_SCAN_CACHE.pop(memo_key, None)
    if hit is not None:
        _SEQ_SCAN_CACHE[memo_key] = hit
    return hit


def scan_seq_minimizers(seq: str, k: int = K, w: int = W):
    """(keys, local_positions, strands) of one sequence's minimizers, memoised
    by string value.

    Scanning a sequence alone is exactly equivalent to scanning it inside a
    gap-padded concatenation (aeons.ava.PoolIndex): gap-touching k-mers hash
    to INVALID_HASH (never a window minimum next to any valid k-mer) and the
    window-minimum edge clamping matches.
    """
    memo_key = (_digest(seq.encode()), len(seq), k, w)
    hit = _memo_get(memo_key)
    if hit is not None:
        return hit
    from . import encode

    out = _scan_codes(encode(seq), k, w)
    _memo_put(memo_key, out)
    return out


def _scan_uncached_bulk(seqs: list[str], keys: list[tuple], k: int, w: int) -> None:
    """Scan many sequences in ONE gap-padded concatenated pass (amortising
    the per-call overhead of small sequences) and memoise each sequence's
    local result. Equivalent to per-sequence scans, by the argument of
    scan_seq_minimizers."""
    from . import encode

    gap = 512
    lengths = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths + gap)[:-1]]).astype(np.int64)
    concat = np.full(int((lengths + gap).sum()), 4, np.int8)
    for st, s in zip(starts, seqs):
        concat[st : st + len(s)] = encode(s)
    if concat.shape[0] - k + 1 <= 0:
        canonical = strand = None
        sel_pos = np.empty(0, np.int64)
    else:
        canonical, strand, h, ok = _kmer_scan_arrays(concat, k)
        sel_pos = np.flatnonzero(minimizer_mask(h, w) & ok)
    for memo_key, st, ln in zip(keys, starts, lengths):
        lo, hi = np.searchsorted(sel_pos, [st, st + ln])
        pos = sel_pos[lo:hi] - st
        out = (
            (canonical[sel_pos[lo:hi]].astype(np.int64) if canonical is not None
             else np.empty(0, np.int64)),
            pos.astype(np.int64),
            (strand[sel_pos[lo:hi]] if strand is not None else np.empty(0, np.int8)),
        )
        _memo_put(memo_key, out)


def _memo_put(memo_key: tuple, out: tuple) -> None:
    global _memo_evictions
    if len(_SEQ_SCAN_CACHE) >= _SEQ_SCAN_MAX:
        if _memo_evictions == 0:
            logging.getLogger("boss_torch").info(
                f"minimizer-scan memo full ({_SEQ_SCAN_MAX}); evicting LRU half"
            )
        _memo_evictions += 1
        for old in list(_SEQ_SCAN_CACHE)[: _SEQ_SCAN_MAX // 2]:
            del _SEQ_SCAN_CACHE[old]
    _SEQ_SCAN_CACHE[memo_key] = out


def _scan_codes(codes: np.ndarray, k: int, w: int) -> tuple:
    """(keys, local_positions, strands) of one code array's minimizers."""
    if codes.shape[0] - k + 1 <= 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int8))
    canonical, strand, h, ok = _kmer_scan_arrays(codes, k)
    sel = minimizer_mask(h, w) & ok
    pos = np.flatnonzero(sel)
    return (canonical[pos].astype(np.int64), pos.astype(np.int64), strand[pos])


def build_index_layout(layout, k: int = K, w: int = W, max_occ: int = MAX_OCC) -> MinimizerIndex:
    """Per-contig memoised index build for in-memory GenomeLayouts.

    AEONS decision aligners rebuild their index whenever the contig set
    moves (aeons/simulation.py::make_decisions), usually changing only a few
    contigs — each contig block scans once and is remembered. Bit-identical
    to build_index over the padded concatenation: blocks are separated by
    >= 1 invalid padding site and k+1 > w, so no k-mer or selection window
    spans two contigs (pinned in tests/test_pool_index_cache.py). Falls
    back to the one-shot concat scan when a block has no trailing padding
    (contig length an exact CHUNK multiple) or k+1 <= w.
    """
    offs = layout.offsets.astype(np.int64)
    lens = layout.lengths.astype(np.int64)
    nexts = np.concatenate([offs[1:], [layout.G_pad]]).astype(np.int64)
    if k + 1 <= w or (lens.shape[0] and bool(np.any(offs + lens >= nexts))):
        return build_index(layout.seq_int, layout.site_valid(), k=k, w=w, max_occ=max_occ)
    keys_l, pos_l, strand_l = [], [], []
    for off, ln in zip(offs, lens):
        codes = np.ascontiguousarray(layout.seq_int[off : off + ln]).astype(np.int8)
        memo_key = (_digest(codes.tobytes()), int(ln), k, w, "layout")
        hit = _memo_get(memo_key)
        if hit is None:
            hit = _scan_codes(codes, k, w)
            _memo_put(memo_key, hit)
        ky, po, sd = hit
        keys_l.append(ky)
        pos_l.append(po + int(off))
        strand_l.append(sd)
    if not keys_l:
        z = np.empty(0, np.int64)
        return MinimizerIndex(z, np.zeros(1, np.int64), z, np.empty(0, np.int8), k, w)
    return _assemble_index(
        np.concatenate(keys_l), np.concatenate(pos_l), np.concatenate(strand_l),
        k, w, max_occ,
    )


def build_index_cached(
    seqs: list[str],
    starts: np.ndarray,
    k: int = K,
    w: int = W,
    max_occ: int = MAX_OCC,
) -> MinimizerIndex:
    """MinimizerIndex over a virtual gap-padded concatenation of seqs, built
    from per-sequence memoised scans (scan_seq_minimizers). starts must be
    ascending (concat order) so that within-key position order matches
    build_index on the real concatenation bit for bit."""
    memo_keys = [(_digest(s.encode()), len(s), k, w) for s in seqs]
    fresh = {}
    for s, mk in zip(seqs, memo_keys):
        if _memo_get(mk) is None:
            fresh[mk] = s  # dedupes repeated values within the batch
    if fresh:
        _scan_uncached_bulk(list(fresh.values()), list(fresh.keys()), k, w)
    keys_l, pos_l, strand_l = [], [], []
    for mk, st, s in zip(memo_keys, starts, seqs):
        hit = _memo_get(mk)
        if hit is None:  # evicted mid-build (pool larger than the memo cap)
            hit = scan_seq_minimizers(s, k, w)
        ky, po, sd = hit
        keys_l.append(ky)
        pos_l.append(po + int(st))
        strand_l.append(sd)
    if not keys_l:
        z = np.empty(0, np.int64)
        return MinimizerIndex(z, np.zeros(1, np.int64), z, np.empty(0, np.int8), k, w)
    return _assemble_index(
        np.concatenate(keys_l), np.concatenate(pos_l), np.concatenate(strand_l),
        k, w, max_occ,
    )
