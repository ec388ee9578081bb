"""The simulation's data plane, plain: from the corpus files to observations.

What a batch contributes under the upstream's simulation semantics
(boss/runs/simulation.py and sequences.py): each read's best full-length
mapping if its decision accepted it, else the mapping of its first mu
bases; a mapping adds one observation per target site it spans, the read's
base (strand-corrected) where the CIGAR matches and the deletion symbol
(4) where it deletes; accepted reads add their read-start window, and
their lengths feed the read-length distribution (boss/readlengthdist.py)
that sets the next update's CCL pieces and time cost. A read is decided
from the strategy row of its truncated mapping's 5' end (reverse reads:
the end - 1), fail-closed: no truncated mapping, or a row past the
contig's strategy, rejects it. Everything here reads the corpus files
itself: NumPy over the FASTQ, the two PAFs and the reference FASTA.
"""
from __future__ import annotations

import numpy as np

from .layout import DS

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_CODE = np.full(256, 0, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
_OPS = {ord("M"): 0, ord("="): 0, ord("X"): 0, ord("I"): 1, ord("S"): 1,
        ord("D"): 2, ord("N"): 2}


def read_fasta(path) -> dict[str, np.ndarray]:
    """{name: codes 0..3} (other letters 0)."""
    out, name, parts = {}, None, []
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    out[name] = _CODE[np.frombuffer(b"".join(parts), np.uint8)].astype(np.uint8)
                name, parts = line[1:].split()[0].decode(), []
            else:
                parts.append(line.strip())
    if name is not None:
        out[name] = _CODE[np.frombuffer(b"".join(parts), np.uint8)].astype(np.uint8)
    return out


def read_fastq(path, offsets: bool = False):
    """{read id: sequence} in file order; with ``offsets`` also {byte
    offset of the record: read id}."""
    out, at = {}, {}
    with open(path, "rb") as fh:
        while True:
            pos = fh.tell()
            head = fh.readline()
            if not head:
                return (out, at) if offsets else out
            seq = fh.readline().rstrip(b"\n")
            fh.readline()
            fh.readline()
            rid = head[1:].split()[0].decode()
            out[rid] = seq
            at[pos] = rid


def read_paf(path) -> dict[str, tuple]:
    """{read id: (qlen, qstart, qend, rev, tname, tstart, tend, cigar)} of
    its best record: highest (mapq, AS), the last of full ties."""
    best = {}
    with open(path, "rb") as fh:
        for line in fh:
            f = line.rstrip(b"\n").split(b"\t")
            if len(f) < 12:
                continue
            tags = {t[:2]: t[5:] for t in f[12:]}
            key = (int(f[11]), int(tags.get(b"AS", b"0")))
            rid = f[0].decode()
            if rid not in best or key >= best[rid][0]:
                best[rid] = (key, (int(f[1]), int(f[2]), int(f[3]), f[4] == b"-",
                                   f[5].decode(), int(f[7]), int(f[8]), tags[b"cg"]))
    return {r: v for r, (_, v) in best.items()}


def _parse_cigars(cigars: list[bytes]):
    """(op lengths, op codes 0 M / 1 I / 2 D, ops per cigar) of cg:Z strings."""
    cat = np.frombuffer(b"".join(cigars), np.uint8)
    is_op = cat >= 65
    op_pos = np.flatnonzero(is_op)
    code = np.vectorize(_OPS.__getitem__, otypes=[np.int64])(cat[op_pos]) \
        if op_pos.size else np.zeros(0, np.int64)
    digit = np.where(is_op, 0, cat.astype(np.int64) - 48)
    prev = np.concatenate([[-1], op_pos[:-1]])
    ndig = op_pos - prev - 1
    length = np.zeros(op_pos.size, np.int64)
    for j in range(int(ndig.max()) if ndig.size else 0):
        has = ndig > j
        length[has] += digit[op_pos[has] - 1 - j] * 10 ** j
    clen = np.array([len(c) for c in cigars], np.int64)
    ends = np.cumsum(clen)
    n_ops = np.diff(np.concatenate([[0], np.searchsorted(op_pos, ends, side="left")]))
    return length, code, n_ops


def expand(records: list[tuple], seqs: list[bytes], genome_index: dict[str, tuple]):
    """Flat observations of mappings: (contig index, site, symbol) arrays.

    ``records[i]`` is a mapping of the read whose (decided) sequence is
    ``seqs[i]``; ``genome_index`` maps a contig name to (index, length)."""
    if not records:
        z = np.zeros(0, np.int64)
        return z, z, z
    aln, ts, cid = [], [], []
    for (qlen, qs, qe, rev, tname, tstart, _te, _cg), s in zip(records, seqs):
        if rev:
            s = s.translate(_COMP)[::-1]
            qs, qe = qlen - qe, qlen - qs
        aln.append(s[qs:qe])
        ts.append(tstart)
        cid.append(genome_index[tname][0])
    codes = _CODE[np.frombuffer(b"".join(aln), np.uint8)].astype(np.int64)
    qbase = np.concatenate([[0], np.cumsum([len(a) for a in aln])[:-1]])
    length, code, n_ops = _parse_cigars([r[7] for r in records])
    read_of = np.repeat(np.arange(len(records)), n_ops)
    t_adv = np.where(code != 1, length, 0)
    q_adv = np.where(code != 2, length, 0)
    first_op = np.concatenate([[0], np.cumsum(n_ops)[:-1]])
    t_off = np.cumsum(t_adv) - t_adv
    q_off = np.cumsum(q_adv) - q_adv
    t_off -= np.repeat(t_off[first_op], n_ops)
    q_off -= np.repeat(q_off[first_op], n_ops)
    emit = code != 1
    n = length[emit]
    r = read_of[emit]
    step = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    site = np.repeat(np.asarray(ts, np.int64)[r] + t_off[emit], n) + step
    qpos = np.repeat(qbase[r] + q_off[emit], n) + step
    is_del = np.repeat(code[emit] == 2, n)
    sym = np.where(is_del, 4, codes[np.where(is_del, 0, qpos)])
    return np.repeat(np.asarray(cid, np.int64)[r], n), site, sym


def decide(trunc: tuple | None, strat: dict[str, np.ndarray], barcode: int = 0) -> bool:
    """Accept iff the truncated mapping's 5' end falls on an accepting row."""
    if trunc is None:
        return False
    _ql, _qs, _qe, rev, tname, tstart, tend, _cg = trunc
    row = (tend - 1 if rev else tstart) // DS
    s = strat.get(tname)
    if s is None or row >= s.shape[0]:
        return False
    return bool(s[row, int(rev), barcode])


class ReadLengthDist:
    """The upstream's read-length distribution (boss/readlengthdist.py): a
    truncated-normal prior (lambda 6000, sd 4000), accepted lengths above
    2 mu into a 1M-bin histogram, 10 CCL pieces, time cost lambda - 700."""

    MAX_LEN = 1_000_000

    def __init__(self, mu: int = 400, sd: int = 4000, lam: float = 6000.0, eta: int = 11):
        self.mu, self.eta, self.lam = mu, eta, lam
        self.hist = np.zeros(self.MAX_LEN, np.int64)
        x = np.arange(int(lam + 10 * sd), dtype=np.float64)
        dens = np.exp(-((x - lam + 1) ** 2) / (2.0 * sd ** 2))
        self.L = dens / dens.sum()
        self.approx_ccl = self._ccl()
        self.time_cost = float(lam) - 700.0

    def update(self, lengths) -> None:
        arr = np.asarray(lengths, np.int64)
        arr = arr[arr > 2 * self.mu]
        if arr.size:
            np.add.at(self.hist, np.minimum(arr, self.MAX_LEN - 1), 1)
        nz = np.flatnonzero(self.hist)
        if nz.size == 0:
            return
        counts = self.hist[nz]
        self.lam = float((nz * counts).sum() / counts.sum())
        self.L = self.hist[: int(nz[-1]) + 1].astype(np.float64)
        self.L /= self.L.sum()
        self.approx_ccl = self._ccl()
        self.time_cost = self.lam - 700.0

    def _ccl(self) -> np.ndarray:
        ccl = np.empty(self.L.shape[0] + 1)
        ccl[0] = 1.0
        ccl[1:-1] = 1.0 - np.cumsum(self.L[1:])
        ccl[-1] = 0.0
        ccl[ccl < 1e-6] = 0.0
        last = np.flatnonzero(ccl)
        ccl = np.append(ccl[: last[-1] + 1], 0.0) if last.size else np.zeros(2)
        probs = 1.0 - (np.arange(self.eta - 1) + 0.5) / (self.eta - 1)
        return np.searchsorted(-ccl, -probs, side="left").astype(np.int64)
