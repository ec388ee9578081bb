"""All-vs-all / new-vs-pool overlap discovery for BOSS-AEONS.

The port of ``bossruns_tpu.aeons.ava``, the replacement for the reference's
minimap2 subprocess calls (``minimap2 -x ava-ont`` and ``-x map-ont -w5
-e0 -m100 -r2k``): a minimizer index is built over the target pool, query
sequences are seeded against it (kernel H6 on a CUDA device, through
``aligner.seed.seed_candidates``), and the top diagonal clusters per strand
become chain-extent overlap records — the approximate-coordinate PAF that
minimap2 emits for ava (no base-level extension), which is all
miniasm-class classification needs.

Left out of the JAX module: the host/device size dispatch
(``HOST_MAX_MINIMIZERS``, ``HOST_MAX_QUERY_BASES``; the choice is the
caller's ``backend``, and where host seeding beats the card is measured on
the card, PERF.md), the index pad floors and the 256-row floor of a
seeding call (recompile guards of the JAX kernel; the rows are unchanged).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..aligner import encode
from ..aligner.host_seed import host_seed_candidates
from ..aligner.index import _digest, _memo_get, build_index_cached
from ..aligner.seed import CAND_FIELDS, DeviceIndex, anchor_budget, seed_candidates
from ..device import as_device
from ..io.paf import PafRecords

logger = logging.getLogger("boss_torch")

GAP = 512  # invalid-code spacer between pool sequences (> DIAG_TOL so
# clusters never span two sequences)


class PoolIndex:
    """Minimizer index over a set of pool sequences (concatenated), with its
    device copy on ``device``."""

    def __init__(self, seqs: dict[str, str], k: int = 15, w: int = 10, max_occ: int = 32,
                 *, device):
        self.device = as_device(device)
        self.names = list(seqs)
        self.lengths = np.array([len(seqs[n]) for n in self.names], np.int64)
        starts = np.concatenate([[0], np.cumsum(self.lengths + GAP)[:-1]]).astype(np.int64)
        self.starts = starts
        # assembled from per-sequence memoised scans: AEONS rebuilds this
        # index every batch over a mostly unchanged pool, so only NEW
        # sequences pay the k-mer/window scan (bit-identical to the concat
        # scan, tests/test_torch_aeons.py)
        self.host = build_index_cached(
            [seqs[n] for n in self.names], starts, k=k, w=w, max_occ=max_occ
        )
        self._dev: DeviceIndex | None = None
        self.k = k

    @property
    def dev(self) -> DeviceIndex:
        """The index on ``device``, built at first use: host-seeded calls
        never pay the upload."""
        if self._dev is None:
            self._dev = DeviceIndex(self.host, self.device)
        return self._dev

    def locate(self, gpos: int) -> int:
        """Global concat position -> sequence index."""
        return int(np.searchsorted(self.starts, gpos, side="right") - 1)


#: read length buckets of a seeding call; the 131072 bucket is host-only
#: (> AVA_DEVICE_MAX): ultralong reads keep their full length and anchor set
#: there instead of being cut to 32 kb
AVA_BUCKETS = (8192, 32768, 131072)
AVA_DEVICE_MAX = 32768
#: host anchor-slot cap for the ultralong bucket (~2.2*L/(w+1) at 131 kb)
ULTRALONG_BUDGET = 1 << 15


def _bucketize(enc: list[np.ndarray]):
    order = np.argsort([e.shape[0] for e in enc], kind="stable")
    groups = []
    i = 0
    while i < len(order):
        ln = enc[order[i]].shape[0]
        b = next((x for x in AVA_BUCKETS if ln <= x), AVA_BUCKETS[-1])
        group = []
        while i < len(order):
            ln = enc[order[i]].shape[0]
            bb = next((x for x in AVA_BUCKETS if ln <= x), AVA_BUCKETS[-1])
            if bb != b or len(group) >= 2048:
                break
            group.append(int(order[i]))
            i += 1
        groups.append((b, group))
    return groups


def find_overlaps(
    queries: dict[str, str],
    pool_index: PoolIndex,
    min_votes: int = 4,
    ncand: int = 4,
    exclude_self: bool = True,
    merge: bool = False,
    backend: str = "auto",
):
    """Seed queries against the pool; return overlap candidate rows.

    Returns dict of columnar lists (qname/qlen/qstart/qend/rev/tname/tlen/
    tstart/tend/nmatch/blocklen/s1) with approximate chain-extent coords.

    backend: 'auto' or 'device' seeds buckets up to AVA_DEVICE_MAX with
    ``seed_candidates`` on the pool index's device (H6 on CUDA, the plain
    version on the CPU); 'host' seeds every bucket with
    ``host_seed_candidates``. The ultralong bucket is always host-seeded.
    Both give identical rows.
    """
    if backend not in ("auto", "device", "host"):
        raise ValueError(f"unknown seeding backend {backend!r}")
    qnames = list(queries)
    enc = [encode(queries[q]) for q in qnames]
    rows: dict[str, list] = {k: [] for k in (
        "qname qlen qstart qend rev tname tlen tstart tend nmatch blocklen s1".split()
    )}
    k = pool_index.k
    qname_arr = np.array(qnames, dtype=object)
    name_arr = np.array(pool_index.names, dtype=object)
    for L, group in _bucketize(enc):
        if backend == "host" or L > AVA_DEVICE_MAX:
            # reuse memoised minimizer scans when available (new reads were
            # just scanned for the pool index build): same anchors, skips
            # the per-query re-scan. Truncated reads (> L) and memo misses
            # take the batch scan.
            w = pool_index.host.w
            budget = (anchor_budget(L, w, cap=ULTRALONG_BUDGET)
                      if L > AVA_DEVICE_MAX else None)
            scans = [
                _memo_get((_digest(queries[qnames[g]].encode()), enc[g].shape[0], k, w))
                if enc[g].shape[0] <= L else None
                for g in group
            ]
            cands = host_seed_candidates(
                [enc[g][:L] for g in group], pool_index.host, ncand=ncand, L=L,
                pre_scans=scans if all(s is not None for s in scans) else None,
                budget=budget,
            )
        else:
            mat = np.full((len(group), L), 4, np.int8)
            for r, g in enumerate(group):
                mat[r, : min(enc[g].shape[0], L)] = enc[g][:L]
            reads = torch.from_numpy(mat).to(pool_index.device)
            packed = seed_candidates(reads, pool_index.dev, ncand=ncand).cpu().numpy()
            cands = {f: packed[:, i] for i, f in enumerate(CAND_FIELDS)}
        nc = cands["votes"].shape[1]
        # columnar candidate -> record conversion (no per-candidate Python)
        g_idx = np.repeat(np.asarray(group, np.int64), nc)
        votes = np.asarray(cands["votes"]).ravel()
        keep = votes >= min_votes
        if not keep.any():
            continue
        g_idx, votes = g_idx[keep], votes[keep]
        tmin = np.asarray(cands["tmin"]).ravel()[keep]
        tmax = np.asarray(cands["tmax"]).ravel()[keep] + k
        qmin = np.asarray(cands["qmin"]).ravel()[keep]
        qmax = np.asarray(cands["qmax"]).ravel()[keep] + k
        rev = np.asarray(cands["strand"]).ravel()[keep]
        tid = np.searchsorted(pool_index.starts, tmin, side="right") - 1
        tname = name_arr[tid]
        qname = qname_arr[g_idx]
        qlen = np.array([enc[g].shape[0] for g in g_idx], np.int64)
        t0 = pool_index.starts[tid]
        tl = pool_index.lengths[tid]
        ts = tmin - t0
        te = np.minimum(tmax - t0, tl)
        qs = qmin
        qe = np.minimum(qmax, qlen)
        keep2 = te > ts
        if exclude_self:
            keep2 &= tname != qname
        if not keep2.any():
            continue
        span = np.minimum(qe - qs, te - ts)
        nmatch = np.minimum(votes * k, span)
        blocklen = np.maximum(qe - qs, te - ts)
        for field, vals in (
            ("qname", qname), ("qlen", qlen), ("qstart", qs), ("qend", qe),
            ("rev", rev), ("tname", tname), ("tlen", tl), ("tstart", ts),
            ("tend", te), ("nmatch", nmatch), ("blocklen", blocklen),
            ("s1", nmatch),
        ):
            rows[field].extend(vals[keep2].tolist())
    return merge_chains(rows) if merge else rows


def merge_chains(rows: dict[str, list], slope_tol: float = 0.03,
                 max_gap: int = 5000) -> dict[str, list]:
    """Merge split diagonal clusters of the same (query, target, strand)
    into one chain — minimap2-style bounded gap/drift joining.

    Indel drift fragments chains of long overlaps (> ~30 kb of accumulated
    drift) into several clusters. Two clusters belong to one alignment iff
    ALL of:

      * collinear: diagonals within max(256, slope_tol * joined span) —
        drift grows with span;
      * query-adjacent: the q gap between them is <= max_gap and they do
        not overlap by more than half the shorter fragment;
      * target-adjacent: same bound on the t gap (orientation-aware).

    Without the adjacency conditions co-diagonal repeat clusters of the
    SAME pair fuse into inflated spans that turn dovetails into
    containments; with them only true fragments of one alignment join.
    """
    n = len(rows["qname"])
    if n == 0:
        return rows
    order = sorted(
        range(n), key=lambda i: (rows["qname"][i], rows["tname"][i], rows["rev"][i],
                                 rows["qstart"][i])
    )
    merged: list[dict] = []
    for i in order:
        cand = {k: rows[k][i] for k in rows}
        if merged:
            prev = merged[-1]
            same = (
                prev["qname"] == cand["qname"]
                and prev["tname"] == cand["tname"]
                and prev["rev"] == cand["rev"]
            )
            if same:
                if cand["rev"]:
                    d_prev = prev["tend"] + prev["qstart"]
                    d_cand = cand["tend"] + cand["qstart"]
                    gap_t = prev["tstart"] - cand["tend"]
                else:
                    d_prev = prev["tstart"] - prev["qstart"]
                    d_cand = cand["tstart"] - cand["qstart"]
                    gap_t = cand["tstart"] - prev["tend"]
                gap_q = cand["qstart"] - prev["qend"]
                shorter = min(prev["qend"] - prev["qstart"],
                              cand["qend"] - cand["qstart"])
                span = max(prev["qend"], cand["qend"]) - min(prev["qstart"], cand["qstart"])
                collinear = abs(d_prev - d_cand) <= max(256, slope_tol * span)
                adjacent = (
                    -shorter // 2 <= gap_q <= max_gap
                    and -shorter // 2 <= gap_t <= max_gap
                )
                if collinear and adjacent:
                    prev["qstart"] = min(prev["qstart"], cand["qstart"])
                    prev["qend"] = max(prev["qend"], cand["qend"])
                    prev["tstart"] = min(prev["tstart"], cand["tstart"])
                    prev["tend"] = max(prev["tend"], cand["tend"])
                    prev["nmatch"] += cand["nmatch"]
                    prev["s1"] += cand["s1"]
                    prev["blocklen"] = max(
                        prev["qend"] - prev["qstart"], prev["tend"] - prev["tstart"]
                    )
                    continue
        merged.append(cand)
    return {k: [m[k] for m in merged] for k in rows}


def rows_to_records(rows: dict[str, list]) -> PafRecords:
    n = len(rows["qname"])
    arr = lambda key, dt: np.array(rows[key], dtype=dt)  # noqa: E731
    return PafRecords(
        qname=arr("qname", object), qlen=arr("qlen", np.int64),
        qstart=arr("qstart", np.int64), qend=arr("qend", np.int64),
        rev=arr("rev", np.int8), tname=arr("tname", object),
        tlen=arr("tlen", np.int64), tstart=arr("tstart", np.int64),
        tend=arr("tend", np.int64), nmatch=arr("nmatch", np.int64),
        blocklen=arr("blocklen", np.int64), mapq=np.zeros(n, np.int64),
        align_score=arr("s1", np.int64), s1=arr("s1", np.int64),
        primary=np.ones(n, np.int8), cigars=[None] * n,
    )
