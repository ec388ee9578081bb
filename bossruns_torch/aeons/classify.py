"""Overlap classification: miniasm algorithm-5 on columnar alignment records.

Port of the reference's PafLine classification semantics
(the reference's boss/paf.py:118-523) in vectorised NumPy over PafRecords:

  class 1  internal match (overhang > 15% of mapped length)
  class 2  query contained in target (incl. >=90% coverage fallback and the
           "mostly contained" long-sequence promotion)
  class 3  target contained in query
  class 4  query overlaps target ('A overlaps B')   + which ends touch
  class 5  target overlaps query ('B overlaps A')   + which ends touch
  class 6  internal match that could become an overlap after trimming

The trim-coordinate logic (find_trim_coords, paf.py:468-523) is kept
record-wise (only a handful of class-6 records per batch).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..io.paf import PafRecords


@dataclasses.dataclass
class Classified:
    c: np.ndarray        # [N] int8 class 1..6 (0 = filtered out)
    qside: np.ndarray    # [N] 'L'/'R'/'' for overlap classes
    tside: np.ndarray
    qprox: np.ndarray    # [N] bool markers for trimming
    tprox: np.ndarray


def _is_prox(start, end, length, lim=1000.0):
    limit = np.where(lim < 1, lim * length, lim)
    overhang = np.minimum(start, length - end)
    return overhang < limit


def classify(rec: PafRecords, min_map_len: int = 2000, min_s1: int = 200,
             min_seq_len: int = 2500) -> Classified:
    """Filter + classify all records; c=0 means filtered."""
    n = len(rec)
    qs, qe, ql = rec.qstart, rec.qend, rec.qlen
    ts, te, tl = rec.tstart, rec.tend, rec.tlen
    rev = rec.rev.astype(bool)

    maplen = np.minimum(qe - qs, te - ts)
    # overhang (paf.py:149-162)
    ovh_fwd = np.minimum(qs, ts) + np.minimum(ql - qe, tl - te)
    ovh_rev = np.minimum(qs, tl - te) + np.minimum(ts, ql - qe)
    overhang = np.where(rev, ovh_rev, ovh_fwd)

    filtered = (
        (rec.qname == rec.tname)
        | (maplen < min_map_len)
        | (rec.s1 < min_s1)
        | (np.minimum(ql, tl) < min_seq_len)
    )

    internal = overhang > maplen * 0.15
    # containments (paf.py:234-304)
    first_cont_fwd = (qs <= ts) & ((ql - qe) < (tl - te))
    first_cont_rev = (qs <= (tl - te)) & ((ql - qe) < ts)
    first_cont = np.where(rev, first_cont_rev, first_cont_fwd)
    second_cont_fwd = (qs >= ts) & ((ql - qe) > (tl - te))
    second_cont_rev = (qs >= (tl - te)) & ((ql - qe) > ts)
    second_cont = np.where(rev, second_cont_rev, second_cont_fwd)
    first_fb = (qe - qs) / np.maximum(ql, 1) >= 0.90
    second_fb = (te - ts) / np.maximum(tl, 1) >= 0.90

    c = np.zeros(n, np.int8)
    c[internal] = 1
    free = ~internal
    c[free & first_cont] = 2
    free &= ~first_cont
    c[free & second_cont] = 3
    free &= ~second_cont
    c[free & first_fb] = 2
    free &= ~first_fb
    c[free & second_fb] = 3
    free &= ~second_fb

    # overlap orientation (paf.py:338-369)
    qside = np.full(n, "", dtype=object)
    tside = np.full(n, "", dtype=object)
    ovl = free
    fwd_a = ~rev & (qs > ts)                       # 4, R, L
    fwd_b = ~rev & ~(qs > ts)                      # 5, L, R
    rev_q = rev & (qs > (ql - qe))
    rev_a1 = rev_q & (qs > (tl - te))              # 4, R, R
    rev_b1 = rev_q & ~(qs > (tl - te))             # 5, R, R
    rev_rest = rev & ~rev_q
    rev_a2 = rev_rest & ((ql - qs) > te)           # 4, L, L
    rev_b2 = rev_rest & ~((ql - qs) > te)          # 5, L, L
    for mask, cc, qsd, tsd in (
        (fwd_a, 4, "R", "L"), (fwd_b, 5, "L", "R"),
        (rev_a1, 4, "R", "R"), (rev_b1, 5, "R", "R"),
        (rev_a2, 4, "L", "L"), (rev_b2, 5, "L", "L"),
    ):
        m = ovl & mask
        c[m] = cc
        qside[m] = qsd
        tside[m] = tsd

    # second chance for internal matches (paf.py:205-215)
    im = internal
    first_mostly = ((qe - qs) / np.maximum(ql, 1) >= 0.50) & (ql > 20000)
    second_mostly = ((te - ts) / np.maximum(tl, 1) >= 0.50) & (ql > 20000)
    c[im & first_mostly] = 2
    rest = im & ~first_mostly
    c[rest & second_mostly] = 3
    rest &= ~second_mostly
    # internal_match_is_overlap (paf.py:439-464): relaxed dovetail promotion
    q_prox_true = _is_prox(qs, qe, ql)
    t_prox_true = _is_prox(ts, te, tl)
    q_prox_rel = _is_prox(qs, qe, ql, 0.15)
    t_prox_rel = _is_prox(ts, te, tl, 0.15)
    restrictions = (ql > 15000) & (tl > 15000) & (maplen > 5000)
    promote_q = rest & q_prox_true & t_prox_rel & restrictions
    promote_t = rest & ~q_prox_true & t_prox_true & q_prox_rel & restrictions
    qprox = np.zeros(n, bool)
    tprox = np.zeros(n, bool)
    qprox[promote_q] = True
    tprox[promote_t] = True
    c[promote_q | promote_t] = 6

    c[filtered] = 0
    return Classified(c=c, qside=qside, tside=tside, qprox=qprox, tprox=tprox)


def find_trim_coords(rec: PafRecords, i: int, qprox: bool) -> tuple[str, int, int | None, str]:
    """Which sequence to trim and where (paf.py:468-523).

    Returns (sid, trim_start, trim_stop, other); sid '0' = trimming would
    shorten the eventual merge, skip.
    """
    if qprox:
        sid, other = rec.tname[i], rec.qname[i]
        start, end, length = int(rec.tstart[i]), int(rec.tend[i]), int(rec.tlen[i])
        other_len, orig_len = int(rec.qlen[i]), int(rec.tlen[i])
    else:
        sid, other = rec.qname[i], rec.tname[i]
        start, end, length = int(rec.qstart[i]), int(rec.qend[i]), int(rec.qlen[i])
        other_len, orig_len = int(rec.tlen[i]), int(rec.qlen[i])
    if start <= length - end:
        trim_start, trim_stop = 0, start
    else:
        trim_start, trim_stop = end, None
    stop = orig_len if trim_stop is None else trim_stop
    trimmed_bit = stop - trim_start
    new_len = orig_len - trimmed_bit + other_len - int(rec.blocklen[i])
    if new_len < orig_len:
        sid = "0"
    return sid, trim_start, trim_stop, other


def containment_coords_role(rec: PafRecords, i: int, query_contained: bool):
    """(ostart, oend, olen, cstart, cend, clen) of a containment record
    (paf.py:527-548): o* = coordinates on the container, c* = contained."""
    if query_contained:  # class 2
        ostart, oend = int(rec.tstart[i]), int(rec.tend[i])
        cstart, cend = int(rec.qstart[i]), int(rec.qend[i])
    else:  # class 3
        ostart, oend = int(rec.qstart[i]), int(rec.qend[i])
        cstart, cend = int(rec.tstart[i]), int(rec.tend[i])
    return ostart, oend, oend - ostart, cstart, cend, cend - cstart


def multiline_containments(
    rec: PafRecords,
    cls: Classified,
    max_records: int = 10,
    min_cov: float = 0.9,
    min_span: float = 0.85,
):
    """Recover containments fragmented into multiple internal-match records.

    Long containments accumulate indel drift, so chaining splits them into
    several class-1 (internal match) records for the same sequence pair. The
    reference detects these with 100-bp occupancy arrays over the contained
    sequence (sequences.py:1373-1515): if 2..max_records same-strand records
    jointly occupy >= min_cov of the shorter sequence and their union span is
    >= min_span of its length, the pair is a containment and a single merged
    record is synthesised (union of coordinates per side, summed weights).

    Returns (merged PafRecords, [(row, query_contained), ...]).
    """
    from collections import defaultdict

    groups: dict[tuple, list[int]] = defaultdict(list)
    for i in np.flatnonzero(cls.c == 1):
        i = int(i)
        if rec.qname[i] != rec.tname[i]:
            groups[(rec.qname[i], rec.tname[i], int(rec.rev[i]))].append(i)

    cols: dict[str, list] = defaultdict(list)
    roles: list[bool] = []
    for (q, t, rev), idx in groups.items():
        if not 2 <= len(idx) <= max_records:
            continue
        ql, tl = int(rec.qlen[idx[0]]), int(rec.tlen[idx[0]])
        q_cont = ql <= tl
        clen = min(ql, tl)
        nbins = max(clen // 100, 1)
        occ = np.zeros(nbins + 1, np.int32)
        starts = (rec.qstart if q_cont else rec.tstart)[idx] // 100
        ends = np.minimum((rec.qend if q_cont else rec.tend)[idx] // 100, nbins)
        for s, e in zip(starts, ends):
            if e > s:
                occ[s] += 1
                occ[e] -= 1
        covered = (np.cumsum(occ[:-1]) > 0).sum() / nbins
        span = (ends.max() - starts.min()) / nbins
        if covered < min_cov or span < min_span:
            continue
        cols["qname"].append(q)
        cols["qlen"].append(ql)
        cols["qstart"].append(int(rec.qstart[idx].min()))
        cols["qend"].append(int(rec.qend[idx].max()))
        cols["rev"].append(rev)
        cols["tname"].append(t)
        cols["tlen"].append(tl)
        cols["tstart"].append(int(rec.tstart[idx].min()))
        cols["tend"].append(int(rec.tend[idx].max()))
        cols["nmatch"].append(int(rec.nmatch[idx].sum()))
        cols["blocklen"].append(int(rec.blocklen[idx].sum()))
        cols["mapq"].append(int(rec.mapq[idx].max()))
        cols["align_score"].append(int(rec.align_score[idx].sum()))
        cols["s1"].append(int(rec.s1[idx].sum()))
        cols["primary"].append(1)
        roles.append(q_cont)

    n = len(roles)
    merged = PafRecords(
        qname=np.array(cols["qname"], object),
        qlen=np.array(cols["qlen"], np.int64),
        qstart=np.array(cols["qstart"], np.int64),
        qend=np.array(cols["qend"], np.int64),
        rev=np.array(cols["rev"], np.int8),
        tname=np.array(cols["tname"], object),
        tlen=np.array(cols["tlen"], np.int64),
        tstart=np.array(cols["tstart"], np.int64),
        tend=np.array(cols["tend"], np.int64),
        nmatch=np.array(cols["nmatch"], np.int64),
        blocklen=np.array(cols["blocklen"], np.int64),
        mapq=np.array(cols["mapq"], np.int64),
        align_score=np.array(cols["align_score"], np.int64),
        s1=np.array(cols["s1"], np.int64),
        primary=np.array(cols["primary"], np.int8),
        cigars=[None] * n,
    )
    return merged, list(enumerate(roles))
