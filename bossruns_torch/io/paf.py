"""PAF parsing for the port: ``bossruns_tpu.io.paf.parse_paf`` without JAX.

The JAX package's parser reaches its native fast path through
``bossruns_tpu.aligner``, whose package import pulls in JAX. This copy is
the same code bound through the port's jax-free loader
(``bossruns_torch.aligner.native``). The record type and the helpers that
need no native code are re-exported from the JAX package unchanged.
"""
from __future__ import annotations

import ctypes

import numpy as np

from bossruns_tpu.io.paf import PafRecords, alignment_coverage, best_per_query

from ..aligner import native as native_mod

__all__ = ["PafRecords", "alignment_coverage", "best_per_query", "parse_paf"]


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
