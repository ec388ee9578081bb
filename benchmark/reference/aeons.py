"""Plain reference of the port's BOSS-AEONS card work, in float64 PyTorch
with NumPy glue.

What the reference-free sim computes on the card, or decides what the
readfish side sees, written again from the stated semantics (the module
docstrings of the port's ``aeons/ava.py`` and ``aeons/benefit.py``, and
the upstream's overlap and ``Benefit`` steps):

* **Overlaps** (``overlaps``). The pool (the sequences the program
  indexes, in its order) is concatenated with 512 codes 4 after each
  sequence, and the minimizer index of that axis is built at k 15, w 10,
  with at most 32 occurrences a key (``align.Index`` over the axis). A
  query goes to the first length bucket of 8,192, 32,768 and 131,072 that
  holds it (longer queries are cut to 131,072 bases). Its first ``budget``
  minimizers by position (the power of two, at least 64, that holds 2.2 L
  / (w + 1) + 16; at most 1,024 in the two short buckets, which the card
  seeds, and 32,768 in the longest, which the host seeds) look up the
  index: an occurrence on the query's strand gives the forward diagonal
  ``gpos - qpos`` (space 0), one on the other strand the reverse diagonal
  ``gpos + qpos`` (space 1). Each space on its own keeps its ``2 budget``
  smallest diagonals (ties by the minimizer's rank, then the occurrence's),
  votes each by the larger of the counts of kept diagonals in its cell of
  two grids of width 2 tol, offset by tol (tol = max(256, L // 32)), and
  peels 4 clusters: the first best vote, the cluster its space's kept
  diagonals within tol of it (query span ``qmin``..``qmax``, target span
  ``tmin``..``tmax``), after which every diagonal within 2 tol stops
  voting. A cluster of at least 4 votes is a record: the target is the
  sequence that holds ``tmin``, ``tstart = tmin`` and ``tend = min(tmax +
  k, length)`` in its coordinates, ``qstart = qmin``, ``qend = min(qmax +
  k, qlen)``; it is kept where ``tend > tstart`` and the target is not the
  query; ``nmatch = s1 = min(votes k, the shorter span)`` and ``blocklen``
  the longer span. Records of one (query, target, strand),
  ordered by ``qstart`` (then by space and round), join the last joined
  record while their diagonals lie within max(256, 0.03 of the joined
  query span) (forward: ``tstart - qstart``; reverse: ``tend + qstart``)
  and both the query gap and the target gap lie between minus half the
  shorter query span (rounded up) and 5,000: the spans become the union,
  ``nmatch`` and ``s1`` add up, ``blocklen`` is the longer joined span.
* **Strategy** (``strategy``). Per contig, in the program's order: each
  100-base chunk's coverage sum (the last chunk may be short; added in
  float32 by NumPy's ``add.reduceat``, as the upstream's ``Benefit`` and
  the program add it) gives its mean ``min(floor(sum / 100), 100)``; an end that is not capped and whose
  chunk sum is at most 5,000 is a node of interest. A chunk's score is the
  float32 sigmoid 1 / (exp(mean - lowcov) + 1) of its mean (1 at a node of
  interest). Forward and reverse window sums over w chunks stop at the
  contig's ends, and an end that is a node of interest adds one unit of
  score for each chunk the window reaches beyond it. S_mu is the window of
  mu / 100 chunks; the benefit is the sum over the ten windows of
  ``max(ccl // 100, 1)`` chunks, weighted 1.0 down to 0.1, less S_mu, and
  at least 0. The threshold: with ``norm`` the largest benefit, each
  benefit above 0 falls into the bin of the exponent of benefit / norm (its
  absolute value, at most 191); over the bins in order, the cumulative
  ``sum(2^-bin norm count) + sum S_mu`` over ``sum(tc count) + 9`` (tc =
  max((lam - mu - 300) // 100, 1)) peaks at some used bin; the threshold
  is 2^-bin norm of the next used bin, else of the last used bin, and a
  row's strand is accepted where its benefit reaches it (all accepted when
  no benefit is above 0). The window sums add in float64 per contig; the
  control (``dtype=torch.float32``) adds everything in float32 over one
  prefix sum of the whole pool, as the JAX package's device kernel does.
* **Decisions** (``decisions``). ``align.RefAligner`` at k 13, w 5,
  ``min_votes`` 2 over the contigs declared at that batch (each contig its
  own block, as the program's layout) maps each read's first mu bases; the
  read's best record (``align.best_paf``) is looked up as
  ``strat[tname][start // 100, rev]`` (start: ``tend - 1`` on the reverse
  strand, else ``tstart``). Unmapped, an unknown contig or a row past the
  mask accept: the program fails open. With no contigs or no strategy
  every read is accepted and none counts as mapped.
* **Publication** (``publication``): the written contig FASTA and mask
  file against the contigs and strategy the batch computed.

Departures from the program, none of which changes a result:

* The overlap's index is built on the device from the concatenated axis
  at once, not from per-sequence scans; queries are seeded a bucket at a
  time in blocks of any size, each space by sort and binary search.
"""
from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from . import align as A
from .layout import Genome

K, W, MAX_OCC = 15, 10, 32
GAP = 512
NCAND = 4
MIN_VOTES = 4
BUCKETS = (8192, 32768, 131072)
DEVICE_MAX = 32768
ULTRALONG_BUDGET = 1 << 15
SLOPE_TOL, MAX_GAP = 0.03, 5000
FIELDS = ("qname", "qlen", "qstart", "qend", "rev", "tname", "tlen", "tstart", "tend",
          "nmatch", "blocklen", "s1")
NODE = 100
NBINS = 192
END_LIM = 50
#: ten ccl window weights, heaviest first
WEIGHTS = tuple(float(x) for x in np.arange(0.1, 1.1, 0.1)[::-1])


# -------------------------------------------------------------- overlaps --

class _Axis:
    """The pool concatenated, each sequence followed by GAP codes 4: the
    ``seq`` and ``site_valid`` that ``align.Index`` reads."""

    def __init__(self, seqs: dict[str, str]):
        self.names = list(seqs)
        self.lengths = np.array([len(seqs[n]) for n in self.names], np.int64)
        self.starts = np.concatenate([[0], np.cumsum(self.lengths + GAP)[:-1]]).astype(np.int64)
        self.seq = np.full(int((self.lengths + GAP).sum()), 4, np.uint8)
        for st, n in zip(self.starts.tolist(), self.names):
            self.seq[st: st + len(seqs[n])] = A.encode(seqs[n])
        self.site_valid = self.seq < 4


def bucket(n: int) -> int:
    return next((b for b in BUCKETS if n <= b), BUCKETS[-1])


def budget(L: int, w: int) -> int:
    need = int(2.2 * L / (w + 1)) + 16
    p = 64
    while p < need:
        p *= 2
    return min(p, A.ANCHOR_BUDGET if L <= DEVICE_MAX else ULTRALONG_BUDGET)


def _candidates(codes: torch.Tensor, index: A.Index, a: int, tol: int) -> dict:
    """2 NCAND clusters a row of ``codes`` (int64 [R, L]), column s NCAND +
    c holding round c of space s: field -> int64 [R, 2 NCAND]."""
    k, w = index.k, index.w
    canonical, strand, is_min = A.minimizers(codes, k, w)
    R, n = canonical.shape
    dev = codes.device
    rank = torch.cumsum(is_min.to(torch.int64), dim=1) - 1
    take = is_min & (rank < a)
    slot = torch.where(take, rank, a)

    def compact(x, dt=torch.int64):
        return torch.zeros((R, a + 1), dtype=dt, device=dev).scatter_(1, slot, x)[:, :a]

    ck, cs = compact(canonical), compact(strand)
    cp = compact(torch.arange(n, device=dev).expand(R, n))
    cv = compact(take, torch.bool)
    U = index.keys.shape[0]
    if U:
        at = torch.searchsorted(index.keys, ck.contiguous()).clamp_max(U - 1)
        hit = cv & (index.keys[at] == ck)
        occ = index.occ[at]                                  # [R, a, OCC_CAP]
    else:
        hit = torch.zeros_like(cv)
        occ = torch.full((R, a, A.OCC_CAP), -1, dtype=torch.int64, device=dev)
    here = hit[:, :, None] & (occ >= 0)
    gpos, same = occ >> 1, (occ & 1) == cs[:, :, None]
    qpos = cp[:, :, None]
    flat = lambda x: x.expand(R, a, A.OCC_CAP).reshape(R, a * A.OCC_CAP)  # noqa: E731
    out = {f: [] for f in ("votes", "qmin", "qmax", "tmin", "tmax")}
    for space, diag in ((0, torch.where(here & same, gpos - qpos, A.SENTINEL)),
                        (1, torch.where(here & ~same, gpos + qpos, A.SENTINEL))):
        key, order = torch.sort(flat(diag), dim=1, stable=True)
        order = order[:, : 2 * a]
        key = key[:, : 2 * a].contiguous()
        qp = torch.gather(flat(qpos), 1, order)
        gp = torch.gather(flat(gpos), 1, order)
        counts = []
        for off in (0, tol):
            lo = torch.div(key + off, 2 * tol, rounding_mode="floor") * (2 * tol) - off
            counts.append(torch.searchsorted(key, lo + 2 * tol) - torch.searchsorted(key, lo))
        real = key < A.SENTINEL
        vote = torch.where(real, torch.maximum(*counts), -1)
        for _ in range(NCAND):
            bi, bv = A._first_max(vote)
            dist = (key - key.gather(1, bi[:, None])).abs()
            inside = (dist <= tol) & real
            out["votes"].append(bv)
            for f, x, lo_hi in (("qmin", qp, 0), ("qmax", qp, 1), ("tmin", gp, 0),
                                ("tmax", gp, 1)):
                out[f].append(torch.where(inside, x, -A.BIG).max(dim=1).values if lo_hi
                              else torch.where(inside, x, A.BIG).min(dim=1).values)
            vote = torch.where(dist <= 2 * tol, -1, vote)
    return {f: torch.stack(v, dim=1).cpu().numpy() for f, v in out.items()}


def _merge(rows: list[tuple]) -> list[tuple]:
    """Join split clusters of one (query, target, strand), rows in FIELDS
    order, ordered by (qname, tname, rev, qstart) and then their order."""
    qn, qs_, qe_, rv, tn, ts_, te_, nm, bl, s1 = (FIELDS.index(f) for f in (
        "qname", "qstart", "qend", "rev", "tname", "tstart", "tend", "nmatch", "blocklen", "s1"))
    order = sorted(range(len(rows)), key=lambda i: (rows[i][qn], rows[i][tn], rows[i][rv],
                                                    rows[i][qs_]))
    out: list[list] = []
    for i in order:
        c = list(rows[i])
        p = out[-1] if out else None
        if p is not None and (p[qn], p[tn], p[rv]) == (c[qn], c[tn], c[rv]):
            if c[rv]:
                drift = (p[te_] + p[qs_]) - (c[te_] + c[qs_])
                gap_t = p[ts_] - c[te_]
            else:
                drift = (p[ts_] - p[qs_]) - (c[ts_] - c[qs_])
                gap_t = c[ts_] - p[te_]
            gap_q = c[qs_] - p[qe_]
            least = -((min(p[qe_] - p[qs_], c[qe_] - c[qs_]) + 1) // 2)
            span = max(p[qe_], c[qe_]) - min(p[qs_], c[qs_])
            if (abs(drift) <= max(256, SLOPE_TOL * span) and least <= gap_q <= MAX_GAP
                    and least <= gap_t <= MAX_GAP):
                p[qs_], p[qe_] = min(p[qs_], c[qs_]), max(p[qe_], c[qe_])
                p[ts_], p[te_] = min(p[ts_], c[ts_]), max(p[te_], c[te_])
                p[nm] += c[nm]
                p[s1] += c[s1]
                p[bl] = max(p[qe_] - p[qs_], p[te_] - p[ts_])
                continue
        out.append(c)
    return [tuple(r) for r in out]


def overlaps(queries: dict[str, str], pool: dict[str, str], device,
             elements_per_call: int = 1 << 23) -> list[tuple]:
    """The merged overlap records of ``queries`` against ``pool`` (both
    {name: sequence}, the pool in the program's order), each a tuple of
    FIELDS."""
    dev = torch.device(device)
    axis = _Axis(pool)
    index = A.Index(axis, K, W, dev, max_occ=MAX_OCC)
    names = list(queries)
    by_L: dict[int, list[int]] = {}
    for i, q in enumerate(names):
        by_L.setdefault(bucket(len(queries[q])), []).append(i)
    rows = []
    for L, idx in sorted(by_L.items()):
        tol = max(A.DIAG_TOL, L // 32)
        step = max(1, elements_per_call // L)
        for s in range(0, len(idx), step):
            part = idx[s: s + step]
            mat = np.full((len(part), L), 4, np.int64)
            for r, i in enumerate(part):
                q = A.encode(queries[names[i]][:L])
                mat[r, : len(q)] = q
            c = _candidates(torch.as_tensor(mat, device=dev), index, budget(L, W), tol)
            for r, i in enumerate(part):
                qname, qlen = names[i], len(queries[names[i]])
                for col in range(2 * NCAND):
                    v = int(c["votes"][r, col])
                    if v < MIN_VOTES:
                        continue
                    tmin = int(c["tmin"][r, col])
                    t = int(np.searchsorted(axis.starts, tmin, side="right")) - 1
                    t0, tl = int(axis.starts[t]), int(axis.lengths[t])
                    ts, te = tmin - t0, min(int(c["tmax"][r, col]) + K - t0, tl)
                    qs, qe = int(c["qmin"][r, col]), min(int(c["qmax"][r, col]) + K, qlen)
                    if te <= ts or axis.names[t] == qname:
                        continue
                    nmatch = min(v * K, min(qe - qs, te - ts))
                    rows.append((qname, qlen, qs, qe, col // NCAND, axis.names[t], tl, ts, te,
                                 nmatch, max(qe - qs, te - ts), nmatch))
    return _merge(rows)


def row_mismatch(a: list[tuple], b: list[tuple]) -> int:
    """Rows in one multiset of records and not the other."""
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


# -------------------------------------------------------------- strategy --

def strategy(contigs: list[tuple], ccl, lam: float, lowcov: float, mu: int = 400,
             dtype=torch.float64) -> tuple[dict, float]:
    """({contig: accept mask [ceil(len / 100), 2] bool}, threshold) of
    ``contigs`` = [(name, float32 coverage array, capped left, capped
    right)], in the program's order."""
    names, means, noi_l, noi_r, nch = [], [], [], [], []
    f64 = torch.float64
    for name, cov, cap_l, cap_r in contigs:
        n = cov.shape[0]
        nc = -(-n // NODE)
        # the upstream's chunk sums: float32, NumPy's reduceat
        sums = torch.as_tensor(np.add.reduceat(np.asarray(cov, np.float32),
                                               np.arange(0, n, NODE)).astype(np.float64))
        means.append(torch.clamp(torch.floor(sums / NODE), max=100).to(torch.int64))
        noi_l.append(not cap_l and float(sums[0]) <= END_LIM * NODE)
        noi_r.append(not cap_r and float(sums[-1]) <= END_LIM * NODE)
        names.append(name)
        nch.append(nc)
    with np.errstate(over="ignore"):
        table = torch.as_tensor((1.0 / (np.exp(np.arange(101, dtype=np.float32)
                                               - np.float32(lowcov)) + 1.0)).astype(np.float32))
    wins = [mu // NODE] + [max(int(c) // NODE, 1) for c in np.asarray(ccl)]
    smu_parts, ben_parts = [], []
    if dtype != f64:   # one prefix sum over the whole pool, in float32
        score_all = torch.cat([_scores(table, m, l, r) for m, l, r in zip(means, noi_l, noi_r)])
        cs_all = torch.cat([torch.zeros(1), torch.cumsum(score_all.to(dtype), 0)])
    at = 0
    for ci, (m, l, r, nc) in enumerate(zip(means, noi_l, noi_r, nch)):
        if dtype == f64:
            cs = torch.cat([torch.zeros(1, dtype=f64),
                            torch.cumsum(_scores(table, m, l, r).to(f64), 0)])
        else:
            cs = cs_all[at: at + nc + 1]
        at += nc
        i = torch.arange(nc)

        def fwd(w):
            v = cs[torch.clamp(i + w, max=nc)] - cs[i]
            return v + torch.clamp(i + w - nc, 0, w).to(dtype) if r else v

        def rev(w):
            v = cs[i + 1] - cs[torch.clamp(i + 1 - w, min=0)]
            return v + torch.clamp(w - 1 - i, 0, w).to(dtype) if l else v

        smu = torch.stack([fwd(wins[0]), rev(wins[0])], dim=1)
        eb = torch.zeros((nc, 2), dtype=dtype)
        for wt, w in zip(WEIGHTS, wins[1:]):
            eb = eb + wt * torch.stack([fwd(w), rev(w)], dim=1)
        smu_parts.append(smu)
        ben_parts.append(torch.clamp(eb - smu, min=0.0))
    smu = torch.cat(smu_parts)
    benefit = torch.cat(ben_parts)
    if not bool((benefit > 0).any()):
        thr, mask = 0.0, torch.ones(benefit.shape, dtype=torch.bool)
    else:
        thr = _threshold(benefit, float(smu.sum()), max((lam - mu - 300) // NODE, 1.0),
                         200 // NODE + 300 // NODE + mu // NODE)
        mask = benefit >= thr
    out, at = {}, 0
    for name, nc in zip(names, nch):
        out[name] = mask[at: at + nc].numpy()
        at += nc
    return out, thr


def _scores(table, means, noi_l, noi_r) -> torch.Tensor:
    s = table[means].clone()
    if noi_l:
        s[0] = 1.0
    if noi_r:
        s[-1] = 1.0
    return s


def _threshold(benefit: torch.Tensor, smu_sum: float, tc: float, tbar0: float) -> float:
    b = benefit.reshape(-1).to(torch.float64)
    nz = b[b > 0]
    norm = float(b.max())
    bins = torch.frexp(nz / norm).exponent.abs().clamp(max=NBINS - 1)
    counts = torch.bincount(bins.to(torch.int64), minlength=NBINS).tolist()
    used = [k for k in range(NBINS) if counts[k] > 0]
    su = st = 0.0
    best, kmax = -math.inf, used[0]
    for k in range(NBINS):
        su += math.ldexp(1.0, -k) * norm * counts[k]
        st += tc * counts[k]
        if counts[k] and (su + smu_sum) / (st + tbar0) > best:
            best, kmax = (su + smu_sum) / (st + tbar0), k
    after = [k for k in used if k > kmax]
    return math.ldexp(1.0, -(after[0] if after else used[-1])) * norm


def strat_mismatch(a: dict, b: dict) -> tuple[int, int]:
    """(rows whose two strands differ anywhere, rows) of two strategies;
    a contig in one only counts all its rows."""
    bad = total = 0
    for name in set(a) | set(b):
        x, y = a.get(name), b.get(name)
        rows = max(0 if x is None else x.shape[0], 0 if y is None else y.shape[0])
        total += rows
        if x is None or y is None or x.shape != y.shape:
            bad += rows
        else:
            bad += int((x != y).any(axis=1).sum())
    return bad, total


# ------------------------------------------------------------- decisions --

def decisions(reads: dict[str, str], contigs: dict[str, str], strat: dict, device,
              k: int = 13, w: int = 5, min_votes: int = 2, mu: int = 400
              ) -> tuple[dict[str, bool], int]:
    """({read: accepted}, reads mapped) of one batch decided against the
    contigs and strategy in force."""
    if not contigs or not strat:
        return {r: True for r in reads}, 0
    g = Genome({n: A.encode(s).astype(np.uint8) for n, s in contigs.items()}, n_barcodes=1,
               min_len=500)
    ref = A.RefAligner(g, k, w, min_votes, device, mu=mu)
    best = A.best_paf(ref.map(reads, trunc=True))
    del ref
    out = {}
    for rid in reads:
        b = best.get(rid)
        m = None if b is None else strat.get(b[4])
        if m is None:
            out[rid] = True
            continue
        _ql, _qs, _qe, rev, _tn, tstart, tend, _cg = b
        row = (tend - 1 if rev else tstart) // NODE
        out[rid] = True if row >= m.shape[0] else bool(m[row, int(rev)])
    return out, len(best)


# ----------------------------------------------------------- publication --

def publication(fasta: str, npz: str, contigs: dict[str, str], strat: dict) -> int:
    """Contigs whose written name, bases or mask (its ``ceil(len / 100)``
    rows) differ from those computed, or that one side lacks."""
    written, name, parts = {}, None, []
    with open(fasta) as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    written[name] = "".join(parts)
                name, parts = line[1:].strip(), []
            else:
                parts.append(line.strip())
    if name is not None:
        written[name] = "".join(parts)
    with np.load(npz) as z:
        masks = {n: z[n] for n in z.files}
    bad = 0
    for n in set(contigs) | set(written) | set(masks) | set(strat):
        s, m = contigs.get(n), masks.get(n)
        if (s is None or written.get(n) != s or m is None or n not in strat
                or m.shape != (-(-len(s) // NODE), 2) or not np.array_equal(m, strat[n])):
            bad += 1
    return bad
