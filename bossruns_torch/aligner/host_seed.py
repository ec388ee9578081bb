"""Vectorised host (NumPy/C) mirror of the seeding kernels H5 and H6.

A copy of ``bossruns_tpu.aligner.host_seed``. Its consumers are
``CpuAligner`` (cpu_baseline.py: the host baseline of the aligner and
``make_aligner(backend="host")``) and the AEONS overlap search
(``aeons.ava.find_overlaps``: ``backend="host"`` and the ultralong bucket,
through ``host_seed_candidates``). The reference maps with mappy
(minimap2's C library) over a 4-worker thread pool; mappy is not available,
so the stand-in walks the SAME minimizer index on the host and extends with
the same native banded_align.cpp.

The algorithms mirror ``seed.seed_topn`` and ``seed.seed_candidates`` step
for step — same (k, w, hash) minimizer selection, same anchor budget,
OCC_CAP occurrence cap and compaction-width drop, same vote/peel semantics —
so host and device seeding produce identical voted candidates
(tests/test_torch_aligner.py, tests/test_torch_aeons.py). Everything is
batch-vectorised NumPy: one k-mer scan (native C when built) over the
concatenated reads, one composite-key sort of all anchors, staggered-bucket
run-length votes (native C), reduceat cluster stats. No per-read Python.
"""
from __future__ import annotations

import numpy as np

from .index import MinimizerIndex, _kmer_scan_arrays, minimizer_mask
from .seed import DIAG_TOL, NCAND, OCC_CAP, anchor_budget

#: diagonal offset making composite sort keys non-negative (|diag| < 2^33)
_DOFF = np.int64(1) << 33
_SEG_SHIFT = 35  # composite = seg_id << 35 | (diag + _DOFF)


def _batch_minimizers(enc_reads: list[np.ndarray], k: int, w: int, budget: int):
    """Minimizers of all reads via ONE concatenated scan.

    Reads are joined with k+w invalid bases (code 4): every k-mer window
    touching a gap is invalid and every w-window min over gap hashes is
    INT32_MAX, so the per-read minimizer sets equal the device's padded-row
    computation (which pads each row with hmax on both sides).

    Returns (rid, qpos, key, strand) int64/int32 arrays of the kept
    minimizers (first ``budget`` per read, position order — the device's
    compact_minimizers semantics).
    """
    gap = k + w
    if not enc_reads:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    lens = np.array([e.shape[0] for e in enc_reads], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens + gap)[:-1]]).astype(np.int64)
    total = int((lens + gap).sum())
    concat = np.full(total, 4, np.int8)
    for s, e in zip(starts, enc_reads):
        concat[s : s + e.shape[0]] = e
    canonical, strand, h, ok = _kmer_scan_arrays(concat, k)
    # selection predicate is `ok & window-min` — the SAME predicate as the
    # device kernel (seed.py: is_min = valid & (h == m2)) and the memoised
    # scans (index._scan_codes), so all three paths are equivalent by
    # construction even for the p~2^-31 valid k-mer whose hash collides with
    # INVALID_HASH (ADVICE r4)
    sel = minimizer_mask(h, w) & ok
    pos = np.flatnonzero(sel)
    rid = np.searchsorted(starts, pos, side="right") - 1
    qpos = pos - starts[rid]
    # guard: a minimizer can only sit on valid in-read k-mers, but keep the
    # bounds check cheap and explicit
    keep = qpos < lens[rid]
    rid, qpos, pos = rid[keep], qpos[keep], pos[keep]
    # first `budget` minimizers per read (position-stable, like
    # compact_minimizers): pos is ascending, so rank-within-read works
    first = np.concatenate([[0], np.cumsum(np.bincount(rid, minlength=len(enc_reads)))[:-1]])
    rank = np.arange(rid.shape[0]) - first[rid]
    keep = rank < budget
    rid, qpos, pos = rid[keep], qpos[keep], pos[keep]
    return rid, qpos, canonical[pos].astype(np.int64), strand[pos].astype(np.int64)


def _merge_pre_scans(pre_scans, budget: int):
    """(rid, qpos, key, strand) from per-read memoised scans — identical to
    _batch_minimizers' output (minimizer positions are ascending per read and
    the first-`budget` cap matches compact_minimizers semantics)."""
    rids, qposs, keys, strands = [], [], [], []
    for r, (ky, po, sd) in enumerate(pre_scans):
        if po.shape[0] > budget:
            ky, po, sd = ky[:budget], po[:budget], sd[:budget]
        rids.append(np.full(po.shape[0], r, np.int64))
        qposs.append(po.astype(np.int64))
        keys.append(ky.astype(np.int64))
        strands.append(sd.astype(np.int64))
    if not rids:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    return (np.concatenate(rids), np.concatenate(qposs),
            np.concatenate(keys), np.concatenate(strands))


def _anchors(enc_reads, index: MinimizerIndex, budget: int, occ_cap: int = OCC_CAP,
             pre_scans=None):
    """(rid, space, diag, qpos, gpos) of every anchor, mirroring the device
    lookup: exact key match, first ``occ_cap`` occurrences per key.

    space 0 = same-strand (diag = gpos - qpos), 1 = opposite
    (diag = gpos + qpos). pre_scans: optional per-read memoised minimizer
    scans (index._SEQ_SCAN_CACHE entries) replacing the batch k-mer/window
    scan — exactly the same anchors.
    """
    if pre_scans is not None:
        rid, qpos, key, strand = _merge_pre_scans(pre_scans, budget)
    else:
        rid, qpos, key, strand = _batch_minimizers(enc_reads, index.k, index.w, budget)
    if index.keys.shape[0] == 0 or rid.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    ix = np.searchsorted(index.keys, key)
    ix_c = np.minimum(ix, index.keys.shape[0] - 1)
    hit = index.keys[ix_c] == key
    rid, qpos, strand, ix = rid[hit], qpos[hit], strand[hit], ix_c[hit]
    off = index.offsets
    if ix.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    cnt = np.minimum(off[ix + 1] - off[ix], occ_cap).astype(np.int64)
    rep = np.repeat(np.arange(ix.shape[0]), cnt)
    within = np.arange(rep.shape[0]) - np.repeat(
        np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt
    )
    src = off[ix[rep]] + within
    gpos = index.positions[src].astype(np.int64)
    gstrand = index.strands[src].astype(np.int64)
    rid, qpos, strand = rid[rep], qpos[rep], strand[rep]
    space = (gstrand != strand).astype(np.int64)
    diag = np.where(space == 0, gpos - qpos, gpos + qpos)
    return rid, space, diag, qpos, gpos


def _sorted_segments(rid, space, diag, qpos, gpos, n_reads: int, cw: int):
    """Sort anchors by (rid, space, diag); apply the device's
    compaction-width drop (keep the cw smallest diagonals per segment);
    return sorted columns + composite keys + per-segment start offsets.

    One stable argsort on the composite key (seg << 35 | diag+off) — the
    composite orders exactly like lexsort((diag, space, rid)) and ties
    (identical seg+diag) keep input order under both, so this is the same
    permutation at a third of the sort passes."""
    comp = ((rid * 2 + space) << _SEG_SHIFT) | (diag + _DOFF)
    order = np.argsort(comp, kind="stable")
    comp = comp[order]
    rid, space, diag = rid[order], space[order], diag[order]
    qpos, gpos = qpos[order], gpos[order]
    seg = rid * 2 + space
    first = np.concatenate([[0], np.cumsum(np.bincount(seg.astype(np.int64), minlength=2 * n_reads))[:-1]])
    rank = np.arange(seg.shape[0]) - first[seg]
    keep = rank < cw
    if not keep.all():
        rid, space, diag = rid[keep], space[keep], diag[keep]
        qpos, gpos, seg, comp = qpos[keep], gpos[keep], seg[keep], comp[keep]
    return rid, space, diag, qpos, gpos, seg, comp


def _votes(seg, diag, tol: int):
    """votes[i] = anchors in i's segment sharing i's best staggered
    diagonal bucket (width 2*tol, offsets 0 and tol) — run-length counts
    over the (seg, diag)-sorted anchors.

    MUST count elementwise-identically to the device vote (seed.vote and
    csrc/seed.cu): both sides partition with the same floor divide over raw
    diagonals, so the grids coincide for any tol. One native O(n) pass when built
    (seed_votes_bucket_c); the NumPy form below is the executable spec
    (pinned equal in tests/test_native_host.py)."""
    from . import native as native_mod

    lib = native_mod._load()
    if lib and hasattr(lib, "seed_votes_bucket_c") and seg.shape[0]:
        import ctypes

        if not hasattr(lib, "_bvotes_ready"):
            lib.seed_votes_bucket_c.restype = None
            lib.seed_votes_bucket_c.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib._bvotes_ready = True
        out = np.zeros(seg.shape[0], np.int64)
        s = np.ascontiguousarray(seg, np.int64)
        d = np.ascontiguousarray(diag, np.int64)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.seed_votes_bucket_c(c(s), c(d), np.int64(s.shape[0]),
                                np.int64(tol), c(out))
        return out

    def run_counts(b):
        newrun = np.empty(b.shape[0], bool)
        newrun[0] = True
        np.not_equal(b[1:], b[:-1], out=newrun[1:])
        starts = np.flatnonzero(newrun)
        lens = np.diff(np.append(starts, b.shape[0]))
        return np.repeat(lens, lens)

    width = 2 * tol
    m = np.int64(1) << 40
    c0 = run_counts(seg * m + diag // width)
    c1 = run_counts(seg * m + (diag + tol) // width)
    return np.maximum(c0, c1).astype(np.int64)


def _seg_tables(seg, values, n_reads: int, fill):
    """Scatter per-segment reduceat maxima into dense [n_reads, 2] tables."""
    out = np.full((n_reads, 2), fill, np.int64)
    if seg.shape[0] == 0:
        return out
    starts = np.concatenate([[0], np.flatnonzero(np.diff(seg)) + 1])
    red = np.maximum.reduceat(values, starts)
    segs = seg[starts]
    out[segs // 2, segs % 2] = red
    return out


def _interval_minmax(vals, lo, hi, empty):
    """min and max of vals[lo_i:hi_i] per interval.

    Native per-interval scan when built — work proportional to the summed
    interval (cluster) sizes instead of the full anchor array the reduceat
    interleave below touches; the NumPy form is the executable spec (pinned
    equal in tests/test_native_host.py)."""
    from . import native as native_mod

    lib = native_mod._load()
    n = lo.shape[0]
    if lib and hasattr(lib, "interval_minmax_c") and n:
        import ctypes

        if not hasattr(lib, "_iminmax_ready"):
            lib.interval_minmax_c.restype = None
            lib.interval_minmax_c.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib._iminmax_ready = True
        v = np.ascontiguousarray(vals, np.int64)
        lo_c = np.ascontiguousarray(np.minimum(lo, v.shape[0]), np.int64)
        hi_c = np.ascontiguousarray(np.minimum(hi, v.shape[0]), np.int64)
        mn = np.empty(n, np.int64)
        mx = np.empty(n, np.int64)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.interval_minmax_c(
            c(v), c(lo_c), c(hi_c), np.int64(n), np.int64(empty), c(mn), c(mx)
        )
        return mn, mx
    mn = np.full(n, empty, np.int64)
    mx = np.full(n, -empty, np.int64)
    ok = hi > lo
    if not ok.any():
        return mn, mx
    li, hi_i = lo[ok], hi[ok]
    # reduceat over interleaved [lo, hi) boundaries; a final sentinel start
    # (vals.size - 1) keeps reduceat happy when the last hi == vals.size
    idx = np.empty(2 * li.shape[0], np.int64)
    idx[0::2] = li
    idx[1::2] = np.minimum(hi_i, vals.shape[0] - 1)
    # intervals where hi-1 < lo never occur (ok guard), but reduceat needs
    # ascending pairs: compute via explicit min over [lo, hi) using the
    # pairwise trick only when safe, else fall back to cumulative forms
    mn_ok = np.minimum.reduceat(vals, idx)[0::2]
    mx_ok = np.maximum.reduceat(vals, idx)[0::2]
    # reduceat's [idx[2i], idx[2i+1]) excludes hi-1 when hi > lo, and the
    # clamped sentinel can also trim the last element: patch with vals[hi-1]
    mn_ok = np.minimum(mn_ok, vals[hi_i - 1])
    mx_ok = np.maximum(mx_ok, vals[hi_i - 1])
    mn[ok] = mn_ok
    mx[ok] = mx_ok
    return mn, mx


def _peel_mask(votes, comp, seg_sel, key_sel, tol2, have):
    """Set votes to -1 within tol2 of key_sel inside each selected segment."""
    sel = have.nonzero()[0]
    if sel.shape[0] == 0:
        return
    base = seg_sel[sel] << _SEG_SHIFT
    lo = np.searchsorted(comp, base | (key_sel[sel] - tol2 + _DOFF), side="left")
    hi = np.searchsorted(comp, base | (key_sel[sel] + tol2 + _DOFF), side="right")
    n = votes.shape[0]
    from . import native as native_mod

    lib = native_mod._load()
    if lib and hasattr(lib, "peel_mask_c") and votes.flags.c_contiguous:
        import ctypes

        if not hasattr(lib, "_peel_ready"):
            lib.peel_mask_c.restype = None
            lib.peel_mask_c.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib._peel_ready = True
        lo_c = np.ascontiguousarray(lo, np.int64)
        hi_c = np.ascontiguousarray(hi, np.int64)
        lib.peel_mask_c(
            votes.ctypes.data_as(ctypes.c_void_p), np.int64(n),
            lo_c.ctypes.data_as(ctypes.c_void_p),
            hi_c.ctypes.data_as(ctypes.c_void_p), np.int64(lo_c.shape[0]),
        )
        return
    mark = np.zeros(n + 1, np.int32)
    np.add.at(mark, lo, 1)
    np.add.at(mark, hi, -1)
    inside = np.cumsum(mark[:n]) > 0
    votes[inside] = -1


def host_seed_topn(enc_reads: list[np.ndarray], index: MinimizerIndex,
                   L: int, ncand: int = NCAND, tol: int = DIAG_TOL,
                   occ_cap: int = OCC_CAP) -> dict[str, np.ndarray]:
    """Host mirror of seed.seed_topn (kernel H5).

    enc_reads: encoded reads (int8 codes, variable length, already truncated
    to the bucket length L). Returns SEED_FIELDS dict of [n, ncand] int64
    arrays; candidates with votes <= 0 are unmapped placeholders.
    """
    n_reads = len(enc_reads)
    budget = anchor_budget(L, index.w)
    cw = (budget * occ_cap) // 2
    out = {f: np.zeros((n_reads, ncand), np.int64)
           for f in ("strand", "bkey", "votes", "dspan", "qmin", "qmax")}
    out["votes"][:] = -1
    rid, space, diag, qpos, gpos = _anchors(enc_reads, index, budget, occ_cap)
    if rid.shape[0] == 0:
        return out
    rid, space, diag, qpos, gpos, seg, comp = _sorted_segments(
        rid, space, diag, qpos, gpos, n_reads, cw
    )
    votes = _votes(seg, diag, tol)
    work = votes.copy()
    pos_idx = np.arange(comp.shape[0], dtype=np.int64)
    for c in range(ncand):
        # per-segment best (vote max, first position on ties = smallest diag)
        key2 = work * (np.int64(1) << 32) - pos_idx
        t2 = _seg_tables(seg, key2, n_reads, np.iinfo(np.int64).min)
        tv = _seg_tables(seg, work, n_reads, -1)
        # decode best index per (read, space)
        bidx = tv * (np.int64(1) << 32) - t2  # position of the best anchor
        # choose strand space: strict > favours rev only when strictly better
        rev = tv[:, 1] > tv[:, 0]
        votes_i = np.where(rev, tv[:, 1], tv[:, 0])
        bi = np.where(rev, bidx[:, 1], bidx[:, 0])
        have = votes_i > 0
        bi_c = np.where(have, bi, 0).astype(np.int64)
        key_i = diag[bi_c]
        seg_sel = (np.arange(n_reads, dtype=np.int64) * 2 + rev.astype(np.int64))
        # cluster extent [key-tol, key+tol] inside the chosen segment
        base = seg_sel << _SEG_SHIFT
        lo = np.searchsorted(comp, base | (key_i - tol + _DOFF), side="left")
        hi = np.searchsorted(comp, base | (key_i + tol + _DOFF), side="right")
        lo = np.where(have, lo, 0)
        hi = np.where(have, hi, 0)
        dmin, dmax = _interval_minmax(diag, lo, hi, _DOFF)
        qmn, qmx = _interval_minmax(qpos, lo, hi, _DOFF)
        out["strand"][:, c] = rev.astype(np.int64)
        out["bkey"][:, c] = np.where(have, key_i, 0)
        out["votes"][:, c] = votes_i
        out["dspan"][:, c] = np.where(have, np.maximum(dmax - dmin, 0), 0)
        out["qmin"][:, c] = np.where(have, np.maximum(qmn, 0), 0)
        out["qmax"][:, c] = np.where(have, np.maximum(qmx, 0), 0)
        if c + 1 < ncand:
            _peel_mask(work, comp, seg_sel, key_i, 2 * tol, have)
    return out


def host_seed_candidates(enc_reads: list[np.ndarray], index: MinimizerIndex,
                         ncand: int = 4, tol: int | None = None,
                         L: int | None = None,
                         occ_cap: int = OCC_CAP,
                         pre_scans=None,
                         budget: int | None = None) -> dict[str, np.ndarray]:
    """Host mirror of seed.seed_candidates (kernel H6, all-vs-all seeding).

    Returns dict of [n, 2*ncand] arrays (votes, strand, qmin, qmax, tmin,
    tmax): per strand space, the top-ncand diagonal clusters (columns
    0..ncand-1 = space 0, ncand..2*ncand-1 = space 1 — the device layout).
    Rounds with no vote left hold 0 in the span fields.

    budget: minimizer-slot cap per read; defaults to the device-matched
    anchor_budget. The ultralong ava path passes a raised cap so 100 kb
    reads keep all their anchors.
    """
    n_reads = len(enc_reads)
    if L is None:
        L = max((e.shape[0] for e in enc_reads), default=0)
    if tol is None:
        tol = max(DIAG_TOL, L // 32)
    if budget is None:
        budget = anchor_budget(max(L, 1), index.w)
    cw = (budget * occ_cap) // 2
    nc2 = 2 * ncand
    out = {f: np.zeros((n_reads, nc2), np.int64)
           for f in ("votes", "strand", "qmin", "qmax", "tmin", "tmax")}
    out["strand"][:, ncand:] = 1
    rid, space, diag, qpos, gpos = _anchors(
        enc_reads, index, budget, occ_cap, pre_scans=pre_scans
    )
    if rid.shape[0] == 0:
        return out
    rid, space, diag, qpos, gpos, seg, comp = _sorted_segments(
        rid, space, diag, qpos, gpos, n_reads, cw
    )
    votes = _votes(seg, diag, int(tol))
    work = votes.copy()
    pos_idx = np.arange(comp.shape[0], dtype=np.int64)
    all_segs = np.arange(2 * n_reads, dtype=np.int64)
    for c in range(ncand):
        key2 = work * (np.int64(1) << 32) - pos_idx
        t2 = _seg_tables(seg, key2, n_reads, np.iinfo(np.int64).min)
        tv = _seg_tables(seg, work, n_reads, -1)
        bidx = (tv * (np.int64(1) << 32) - t2).reshape(-1)   # [2*n_reads]
        bv = tv.reshape(-1)
        have = bv > 0
        bi_c = np.where(have, bidx, 0).astype(np.int64)
        key_i = diag[bi_c]
        base = all_segs << _SEG_SHIFT
        lo = np.searchsorted(comp, base | (key_i - tol + _DOFF), side="left")
        hi = np.searchsorted(comp, base | (key_i + tol + _DOFF), side="right")
        lo = np.where(have, lo, 0)
        hi = np.where(have, hi, 0)
        qmn, qmx = _interval_minmax(qpos, lo, hi, _DOFF)
        tmn, tmx = _interval_minmax(gpos, lo, hi, _DOFF)
        # device column order: space s, round c -> column s*ncand + c
        for s in (0, 1):
            col = s * ncand + c
            sel = all_segs % 2 == s
            out["votes"][:, col] = bv[sel]
            out["qmin"][:, col] = np.where(have[sel], qmn[sel], 0)
            out["qmax"][:, col] = np.where(have[sel], qmx[sel], 0)
            out["tmin"][:, col] = np.where(have[sel], tmn[sel], 0)
            out["tmax"][:, col] = np.where(have[sel], tmx[sel], 0)
        if c + 1 < ncand:
            _peel_mask(work, comp, all_segs, key_i, 2 * int(tol), have)
    return out
