"""ctypes loader for the shared native host library (native/libbossnative.so).

The same C++ source and Makefile as ``bossruns_tpu.aligner.native``, with the
same stale check and atomic build, but importing no JAX: the JAX package
reaches its loader through ``bossruns_tpu/aligner/__init__.py``, which
imports the device seeding module and so JAX. Besides the loader it holds
the batch banded DP (``align_batch``, with its NumPy fallback) that the
aligner's extension stage calls; the PAF parser, the CIGAR expansion and
the host seeding bind their own symbols.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger("boss_torch")

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libbossnative.so"
_lib = None

#: symbols the current source provides; a .so missing any of them is stale
_EXPECTED_SYMS = (
    "banded_align_batch", "kmer_scan", "kmer_scan_mt", "parse_paf_block",
    "minimizer_mask_c", "minimizer_mask_mt",
    "seed_votes_c", "seed_votes_bucket_c", "peel_mask_c", "interval_minmax_c",
)


def _build() -> bool:
    """make into a per-pid temp name, then rename into place (atomic on one
    filesystem: a concurrent dlopen sees the old or the new library)."""
    tmp = _NATIVE_DIR / f"libbossnative.tmp{os.getpid()}.so"
    try:
        subprocess.run(
            ["make", "-B", "-C", str(_NATIVE_DIR), f"OUT={tmp.name}"],
            check=True, capture_output=True,
        )
        os.rename(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        logger.info(f"native build failed ({e}); using numpy fallbacks")
        tmp.unlink(missing_ok=True)
        return False


def _stale() -> bool:
    """True when the .so predates its source or lacks an expected export
    (probed on the raw bytes before any dlopen, which caches by path)."""
    try:
        st = _LIB_PATH.stat()
        for src in (_NATIVE_DIR / "banded_align.cpp", _NATIVE_DIR / "Makefile"):
            if src.stat().st_mtime > st.st_mtime:
                return True
        blob = _LIB_PATH.read_bytes()
        return not all(s.encode() in blob for s in _EXPECTED_SYMS)
    except OSError:
        return True


def _load():
    """The loaded library, or False when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale() and not _build():
        _lib = False
        return _lib
    try:
        _lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        logger.info(f"native load failed ({e}); using numpy fallbacks")
        _lib = False
    return _lib


def _fallback_one(q, t, half, pad):
    """NumPy banded edit distance with traceback; mirrors the C++ kernel."""
    m, n = q.shape[0], t.shape[0]
    bw = 2 * half + 1
    INF = 1 << 28
    prev = np.full(bw, INF, np.int32)
    trace = np.zeros((m + 1, bw), np.uint8)
    j0 = pad - half
    js = np.arange(bw) + j0
    prev[(js >= 0) & (js <= n)] = 0
    trace[0] = 2
    for i in range(1, m + 1):
        lo = i + pad - half
        js = np.arange(bw) + lo
        diag_ok = (js >= 1) & (js <= n)
        sub = np.ones(bw, np.int32)
        valid_j = js[diag_ok]
        sub[diag_ok] = np.where((t[valid_j - 1] == q[i - 1]) & (q[i - 1] < 4), 0, 1)
        cand_d = np.where(diag_ok & (prev < INF), prev + sub, INF)
        cand_u = np.full(bw, INF, np.int32)
        cand_u[:-1] = np.where(prev[1:] < INF, prev[1:] + 1, INF)
        curr = np.minimum(cand_d, cand_u)
        op = np.where(cand_u < cand_d, 1, 0).astype(np.uint8)
        # left moves need a sequential pass
        for b in range(bw):
            j = b + lo
            if j < 0 or j > n:
                curr[b] = INF
                continue
            if b >= 1 and curr[b - 1] + 1 < curr[b]:
                curr[b] = curr[b - 1] + 1
                op[b] = 2
        trace[i] = op
        prev = curr
    lo_m = m + pad - half
    js = np.arange(bw) + lo_m
    okj = (js >= 0) & (js <= n)
    masked = np.where(okj, prev, INF)
    bestb = int(np.argmin(masked))
    best = int(masked[bestb])
    if best >= INF:
        return -1, 0, 0, []
    i, j = m, bestb + lo_m
    tend = j
    cig = []
    while i > 0:
        b = j - (i + pad - half)
        op = trace[i, b]
        if op == 0:
            i -= 1
            j -= 1
        elif op == 1:
            i -= 1
        else:
            j -= 1
        if cig and cig[-1][0] == op:
            cig[-1][1] += 1
        else:
            cig.append([op, 1])
    return best, j, tend, [(int(l), int(o)) for o, l in cig[::-1]]


def align_batch(queries_cat, q_off, target, win_start, win_end, pad, half, threads=8,
                cigar_cap=4096):
    """Batch banded alignment.

    Returns (cost [n], tstart [n], tend [n], cigars: list of packed uint32
    arrays in forward order, (length << 4) | op with op 0=M 1=I 2=D — the
    same packing the C kernels and io/coo_native consume, so CIGARs flow
    through the pipeline without string round-trips). cost < 0 or empty
    cigar => failed.
    """
    n = int(q_off.shape[0] - 1)
    lib = _load()
    if lib:
        if not hasattr(lib, "_align_ready"):
            lib.banded_align_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.banded_align_batch.restype = None
            lib._align_ready = True
        cost = np.empty(n, np.int32)
        tstart = np.empty(n, np.int64)
        tend = np.empty(n, np.int64)
        cbuf = np.zeros((n, cigar_cap), np.uint32)
        clen = np.zeros(n, np.int32)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        lib.banded_align_batch(
            c(queries_cat), c(q_off), n,
            c(target), len(target),
            c(win_start), c(win_end),
            c(pad), c(half),
            int(threads),
            c(cost), c(tstart), c(tend),
            c(cbuf), cigar_cap, c(clen),
        )
        # traceback order -> forward; a reversed-slice copy per read, no
        # per-op Python (the tuple-list form cost ~1 s per 2000 long reads)
        cigars = [np.ascontiguousarray(cbuf[r, : clen[r]][::-1]) for r in range(n)]
        return cost, tstart, tend, cigars

    cost = np.full(n, -1, np.int32)
    tstart = np.zeros(n, np.int64)
    tend = np.zeros(n, np.int64)
    cigars = []
    for r in range(n):
        q = queries_cat[q_off[r] : q_off[r + 1]]
        ws, we = int(win_start[r]), int(win_end[r])
        cst, ts, te, cig = _fallback_one(q, target[ws:we], int(half[r]), int(pad[r]))
        cost[r] = cst
        tstart[r] = ws + ts
        tend[r] = ws + te
        cigars.append(
            np.array([(l << 4) | o for l, o in cig], np.uint32)
        )
    return cost, tstart, tend, cigars
