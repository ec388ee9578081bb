"""PAF alignment records as columnar NumPy arrays + CIGAR -> coverage COO.

The reference models alignments as one Python object per line
(the reference's boss/paf.py:12-75) and walks dicts of them in every hot loop.
Here a PAF blob parses into one columnar ``PafRecords`` (struct-of-arrays):
best-mapper selection, decision lookups and coverage conversion then become
vectorised array ops, and the COO triplets the device consumes
(site, symbol, barcode, weight) come straight out of the CIGAR expansion.

CIGAR expansion semantics match CoverageConverter._parse_cigar
(runs/sequences.py:744-794): M consumes read+target, D consumes target and
counts as symbol 4 with quality 20, I consumes read only and is dropped,
S/H are clipped. Reverse-strand reads contribute the reverse complement
against the forward target coordinates.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=XB])")

# symbol codes
DEL_SYMBOL = 4
DEL_QUAL = 20

_COMP = np.arange(256, dtype=np.uint8)
for a, b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[a] = b

# read-base mapping: non-ACGT (N, ambiguity codes) -> 4, the same "no-call"
# class as deletions. NOTE the reference's own read translation garbles such
# bases into out-of-range ints (sequences.py:666-668 translates only ACGT,
# then subtracts ord('0')) and would IndexError in its coverage scatter; any
# defined behaviour is a superset. The reference-GENOME mapping (other -> 0,
# reference.py:46-68) lives in models/layout.py and is intentionally
# different.
_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _BASE_LUT[b] = i
    _BASE_LUT[b + 32] = i

_CIG_OP = np.zeros(256, dtype=np.uint8)
_CIG_OP[ord("M")] = 1
_CIG_OP[ord("=")] = 1
_CIG_OP[ord("X")] = 1
_CIG_OP[ord("D")] = 2
_CIG_OP[ord("N")] = 2
_CIG_OP[ord("I")] = 3
_CIG_OP[ord("S")] = 4


def revcomp(seq: str) -> str:
    arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    return _COMP[arr][::-1].tobytes().decode()


@dataclass
class PafRecords:
    """Columnar PAF records. ``cigars`` holds raw cg:Z strings, packed
    uint32 arrays ((len<<4)|op, the TpuAligner's native format), or None."""

    qname: np.ndarray   # object
    qlen: np.ndarray    # int64
    qstart: np.ndarray
    qend: np.ndarray
    rev: np.ndarray     # int8 (0 fwd / 1 rev)
    tname: np.ndarray   # object
    tlen: np.ndarray
    tstart: np.ndarray
    tend: np.ndarray
    nmatch: np.ndarray
    blocklen: np.ndarray
    mapq: np.ndarray
    align_score: np.ndarray  # AS:i
    s1: np.ndarray
    primary: np.ndarray      # tp:A == P
    cigars: list

    def __len__(self) -> int:
        return self.qname.shape[0]

    def row(self, i: int) -> dict:
        return {f: getattr(self, f)[i] for f in (
            "qname", "qlen", "qstart", "qend", "rev", "tname", "tlen",
            "tstart", "tend", "mapq", "align_score")}


def parse_paf(text: str | bytes, min_len: int = 1, primary_only: bool = True) -> PafRecords:
    """Parse PAF text. Drops records with block length < min_len and, by
    default, non-primary alignments (boss/paf.py:652-672).

    Fast path: one native call (native/banded_align.cpp::parse_paf_blob)
    parses the whole blob into columnar arrays with cg:Z tags packed
    directly to uint32 ops; Python only slices out the name strings."""
    rec = _parse_paf_native(text, min_len, primary_only)
    if rec is not None:
        return rec
    if isinstance(text, bytes):
        text = text.decode()
    cols: list[list] = [[] for _ in range(12)]
    cigars: list = []
    align_scores: list[int] = []
    s1s: list[int] = []
    prims: list[int] = []

    def tag_val(rest: str, key: str) -> str | None:
        # tags always follow a tab; find is one C substring search instead of
        # splitting the (cigar-bearing) remainder into tag strings
        j = rest.find(key)
        if j < 0:
            return None
        j += len(key)
        e = rest.find("\t", j)
        return rest[j:] if e < 0 else rest[j:e]

    for line in text.splitlines():
        if not line:
            continue
        f = line.split("\t", 12)  # f[12] = raw tag remainder (if any)
        if len(f) < 12:
            continue
        blocklen = int(f[10])
        rest = f[12] if len(f) > 12 else ""
        prim = 1 if tag_val(rest, "tp:A:") == "P" else 0
        if blocklen < min_len or (primary_only and not prim):
            continue
        cg = tag_val(rest, "cg:Z:")
        a_s = tag_val(rest, "AS:i:")
        s1 = tag_val(rest, "s1:i:")
        for c, v in zip(cols, f):
            c.append(v)
        cigars.append(cg)
        align_scores.append(int(a_s) if a_s else 0)
        s1s.append(int(s1) if s1 else 0)
        prims.append(prim)

    def ints(i):
        return np.array([int(x) for x in cols[i]], dtype=np.int64)

    return PafRecords(
        qname=np.array(cols[0], dtype=object),
        qlen=ints(1), qstart=ints(2), qend=ints(3),
        rev=np.array([0 if s == "+" else 1 for s in cols[4]], dtype=np.int8),
        tname=np.array(cols[5], dtype=object),
        tlen=ints(6), tstart=ints(7), tend=ints(8),
        nmatch=ints(9), blocklen=ints(10), mapq=ints(11),
        align_score=np.array(align_scores, dtype=np.int64),
        s1=np.array(s1s, dtype=np.int64),
        primary=np.array(prims, dtype=np.int8),
        cigars=cigars,
    )


def _parse_paf_native(text: str | bytes, min_len: int, primary_only: bool) -> PafRecords | None:
    """C fast path; None -> caller falls back to the Python line loop.
    Byte offsets from C index the decoded string directly, so the blob must
    be ASCII (PAF is; a non-ASCII name falls back)."""
    import ctypes

    from ..aligner import native as native_mod

    lib = native_mod._load()
    if not lib or not hasattr(lib, "parse_paf_blob"):
        return None
    if isinstance(text, bytes):
        try:
            text = text.decode("ascii")
        except UnicodeDecodeError:
            return None
    elif not text.isascii():
        return None
    if not hasattr(lib, "_pafparse_ready"):
        lib.parse_paf_blob.restype = ctypes.c_int64
        lib.parse_paf_blob.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._pafparse_ready = True
    raw = text.encode()
    cap = text.count("\n") + 1
    nums = np.empty((cap, 11), np.int64)
    names = np.empty((cap, 4), np.int64)
    flags = np.empty((cap, 2), np.int8)
    cg_cap = len(raw) // 2 + cap
    cg_ops = np.empty(cg_cap, np.uint32)
    cg_bound = np.empty(cap + 1, np.int64)
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n = lib.parse_paf_blob(
        raw, np.int64(len(raw)), np.int64(min_len), np.int32(primary_only),
        c(nums), c(names), c(flags), c(cg_ops), np.int64(cg_cap),
        c(cg_bound), np.int64(cap),
    )
    if n < 0:
        return None
    # tolist first: per-element numpy scalar extraction costs ~1 us each
    rows = names[:n].tolist()
    qname = np.array([text[r[0] : r[0] + r[1]] for r in rows], object)
    tname = np.array([text[r[2] : r[2] + r[3]] for r in rows], object)
    bnd = cg_bound[: n + 1].tolist()
    cigars: list = [
        cg_ops[bnd[i] : bnd[i + 1]] if bnd[i + 1] > bnd[i] else None
        for i in range(n)
    ]
    nums = nums[:n]
    flags = flags[:n]
    return PafRecords(
        qname=qname, qlen=nums[:, 0].copy(), qstart=nums[:, 1].copy(),
        qend=nums[:, 2].copy(), rev=flags[:, 0].copy(), tname=tname,
        tlen=nums[:, 3].copy(), tstart=nums[:, 4].copy(),
        tend=nums[:, 5].copy(), nmatch=nums[:, 6].copy(),
        blocklen=nums[:, 7].copy(), mapq=nums[:, 8].copy(),
        align_score=nums[:, 9].copy(), s1=nums[:, 10].copy(),
        primary=flags[:, 1].copy(), cigars=cigars,
    )


def best_per_query(rec: PafRecords) -> dict[str, int]:
    """qname -> row index of its best mapping.

    Tie-break like Paf.choose_best_mapper (boss/paf.py:709-722): max by
    (mapq, AS); among full ties the record appearing last wins (stable
    argsort + take-last).
    """
    n = len(rec)
    if n == 0:
        return {}
    order = np.lexsort((np.arange(n), rec.align_score, rec.mapq))
    best: dict[str, int] = {}
    for i in order:
        best[rec.qname[i]] = int(i)
    return best


def expand_cigar(cigar, seq_aln: str, qual_aln: str):
    """Per-target-position (symbol, qual) arrays for one alignment.

    cigar: a cg:Z string, or a packed uint32 array ((len<<4)|op, op 0=M
    1=I 2=D — the TpuAligner's native format). seq_aln/qual_aln: the aligned
    slice of the (strand-corrected) read, i.e. read[qstart:qend] on the
    mapped strand. Returns (symbols uint8 [tspan], quals uint8 [tspan])
    where symbol 4 marks a deletion.
    """
    if isinstance(cigar, np.ndarray):
        lengths = (cigar >> 4).astype(np.int64)
        rep = np.repeat((cigar & 0xF).astype(np.uint8), lengths)
        consumes_read = rep != 2      # M, I
        consumes_target = rep != 1    # M, D
    else:
        parts = _CIG_RE.findall(cigar)
        lengths = np.array([int(p[0]) for p in parts], dtype=np.int64)
        ops = _CIG_OP[np.frombuffer("".join(p[1] for p in parts).encode(), dtype=np.uint8)]
        rep = np.repeat(ops, lengths)
        consumes_read = rep != 2          # M, I, S
        consumes_target = (rep == 1) | (rep == 2)

    read_sym = _BASE_LUT[np.frombuffer(seq_aln.encode(), dtype=np.uint8)]
    read_qual = np.frombuffer(qual_aln.encode(), dtype=np.uint8) - 33

    sym = np.full(rep.shape[0], DEL_SYMBOL, dtype=np.uint8)
    qual = np.full(rep.shape[0], DEL_QUAL, dtype=np.uint8)
    n_read = int(consumes_read.sum())
    sym[consumes_read] = read_sym[:n_read]
    # no quality string (fasta input) -> fill 40, like the packed C path
    qual[consumes_read] = read_qual[:n_read] if read_qual.size else 40
    return sym[consumes_target], qual[consumes_target]


def alignment_coverage(
    rec: PafRecords, i: int, seq: str, qual: str
) -> tuple[int, int, np.ndarray, np.ndarray]:
    """(tstart, tend, symbols, quals) of record i given the read's sequence.

    Handles reverse-strand reads by reverse-complementing the read and
    mirroring the query interval (runs/sequences.py:706-716).
    """
    qs, qe, ql = int(rec.qstart[i]), int(rec.qend[i]), int(rec.qlen[i])
    if rec.rev[i]:
        seq = revcomp(seq)
        qual = qual[::-1]
        qs, qe = ql - qe, ql - qs
    cigar = rec.cigars[i]
    if cigar is None:
        raise ValueError(f"record for {rec.qname[i]} has no cg:Z tag")
    sym, q = expand_cigar(cigar, seq[qs:qe], qual[qs:qe] if qual else "")
    ts, te = int(rec.tstart[i]), int(rec.tend[i])
    assert sym.shape[0] == te - ts, (sym.shape[0], ts, te, rec.qname[i])
    return ts, te, sym, q
