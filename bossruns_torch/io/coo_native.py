"""Native-accelerated CIGAR -> packed ReadBatch expansion (host hot path).

The port's copy of ``bossruns_tpu.io.coo_native``: the JAX module imports
``bossruns_tpu.aligner`` (and so JAX) at its top, and its ``pack_batch``
builds the JAX ReadBatch. Here the same NumPy and native code is bound
through the port's jax-free loader, and ``pack_batch`` returns the port's
``ReadBatch`` of torch tensors on an explicit device.

This path preps strand-corrected code/qual slices and packed cigars in
vectorised NumPy, then C calls (native/banded_align.cpp::
prep_read_windows, expand_cigars_packed and split_match_runs_wide) emit the
match-run + explicit COO pieces the device consumes; ``coverage_rows``
makes those calls on record chunks on every usable core (``pack_batch``
and the sim's gated flow build their rows with it). NumPy fallbacks keep
everything functional without the shared library.
"""
from __future__ import annotations

import ctypes
import itertools
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..aligner import native as native_mod
from ..models.layout import GenomeLayout
from ..utils import spans
from .coo import _pad_len

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=XB])")
_OP_CODE = {"M": 0, "=": 0, "X": 0, "I": 1, "S": 1, "D": 2, "N": 2}

def _pack_cigar(cig) -> np.ndarray:
    """cg:Z string -> packed (len<<4|op) uint32; packed arrays (the
    aligner's native output format) pass through untouched."""
    if isinstance(cig, np.ndarray):
        return cig.astype(np.uint32, copy=False)
    parts = _CIG_RE.findall(cig)
    return np.array(
        [(int(l) << 4) | _OP_CODE[o] for l, o in parts], dtype=np.uint32
    )


def _cat_cigars(parts: list) -> tuple[np.ndarray, np.ndarray]:
    """(concatenated packed ops uint32, offsets int64[n+1]) for a mixed list
    of cg:Z strings and packed arrays. Strings are parsed in ONE native call
    (native/parse_cigar_batch) instead of a Python regex parse per record."""
    lib = native_mod._load()
    s_idx = [i for i, p in enumerate(parts) if not isinstance(p, np.ndarray)]
    arrs: list = list(parts)
    if s_idx and lib is not None and hasattr(lib, "parse_cigar_batch"):
        if not hasattr(lib, "_cigparse_ready"):
            lib.parse_cigar_batch.restype = ctypes.c_int64
            lib.parse_cigar_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib._cigparse_ready = True
        cat = "".join(parts[i] for i in s_idx).encode()
        offs = np.zeros(len(s_idx) + 1, np.int64)
        np.cumsum([len(parts[i]) for i in s_idx], out=offs[1:])
        cap = len(cat) // 2 + len(s_idx) + 1
        out = np.empty(cap, np.uint32)
        counts = np.empty(len(s_idx), np.int32)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        tot = lib.parse_cigar_batch(cat, c(offs), np.int32(len(s_idx)),
                                    c(out), np.int64(cap), c(counts))
        assert tot >= 0, "malformed cigar string"
        bnd = np.zeros(len(s_idx) + 1, np.int64)
        np.cumsum(counts, out=bnd[1:])
        for j, i in enumerate(s_idx):
            arrs[i] = out[bnd[j] : bnd[j + 1]]
    elif s_idx:
        for i in s_idx:
            arrs[i] = _pack_cigar(parts[i])
    c_off = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([a.shape[0] for a in arrs], out=c_off[1:])
    cat_ops = (
        np.concatenate(arrs).astype(np.uint32, copy=False)
        if arrs else np.zeros(0, np.uint32)
    )
    return cat_ops, c_off


#: the routines the coverage rows' passes call
_ROW_SYMS = ("prep_read_windows", "expand_cigars_packed", "split_match_runs_wide_v2",
             "split_match_runs_wide_v3")


def _bound():
    """The native library with the coverage rows' routines declared, or None
    where it is missing or lacks one (the NumPy fallbacks run then)."""
    lib = native_mod._load()
    if not lib or not all(hasattr(lib, s) for s in _ROW_SYMS):
        return None
    if not hasattr(lib, "_rows_ready"):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.prep_read_windows.restype = i64
        lib.prep_read_windows.argtypes = [ctypes.c_char_p, p, ctypes.c_char_p, p, p, p, p, i32,
                                          p, p, i64]
        lib.expand_cigars_packed.restype = i64
        lib.expand_cigars_packed.argtypes = [p, p, p, p, p, i32, p, p, i64]
        lib.split_match_runs_wide_v2.restype = i64
        lib.split_match_runs_wide_v2.argtypes = [p, p, i64, p, p, p, i32, p, i64, i32, i32,
                                                 p, p, p, i64, p, p, i64]
        lib.split_match_runs_wide_v3.restype = i64
        lib.split_match_runs_wide_v3.argtypes = [p, p, i64, p, p, p, p, i32, p, i64, i32, i32,
                                                 p, p, p, p, i64, p, p, p, i64]
        lib._rows_ready = True
    return lib


class _Set(NamedTuple):
    """One record set made ready for the compiled passes: the records on
    known contigs, in the set's order, their reads' text joined once, and
    per-record arrays with ``[n + 1]`` offsets into the text, the
    strand-corrected windows (``w_off``), the packed CIGARs and the
    covered bases (``b_off``)."""
    seq_cat: bytes
    seq_off: np.ndarray   # int64 [n+1]
    qual_cat: bytes
    qual_off: np.ndarray  # int64 [n+1]
    qs: np.ndarray        # int64 [n]
    qe: np.ndarray        # int64 [n]
    rev: np.ndarray       # uint8 [n]
    w_off: np.ndarray     # int64 [n+1]
    cig: np.ndarray       # uint32, every record's ops
    c_off: np.ndarray     # int64 [n+1]
    b_off: np.ndarray     # int64 [n+1]
    rstart: np.ndarray    # int64 [n]
    rspan: np.ndarray     # int32 [n]
    rbc: np.ndarray       # int32 [n]
    rrow: np.ndarray | None  # int32 [n], each record's read row


def _prepare(layout, tid_of, rec, rows, seqs, quals, barcodes, read_rows=None):
    """A record set as a ``_Set``, or None when it has no record on a
    known contig. Python touches each record only to look up its names
    (contig, read, barcode, read row) and its text and CIGAR. The text is
    joined from each read's bytes: one ``encode`` of a joined string of
    megabases costs several times as much."""
    rows = np.asarray(list(rows), dtype=np.int64)
    if rows.shape[0] == 0:
        return None
    tids = np.array([tid_of.get(t, -1) for t in rec.tname[rows].tolist()], dtype=np.int64)
    keep = tids >= 0
    sel, tids = rows[keep], tids[keep]
    n = sel.shape[0]
    if n == 0:
        return None
    rids = rec.qname[sel].tolist()
    cig_parts = [rec.cigars[i] for i in sel.tolist()]
    if any(p is None for p in cig_parts):
        bad = rids[[j for j, p in enumerate(cig_parts) if p is None][0]]
        raise ValueError(f"record for {bad} has no cigar")
    seq_strs = [seqs[r] for r in rids]
    qual_strs = [quals.get(r, "") for r in rids]
    seq_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, seq_strs), np.int64, n), out=seq_off[1:])
    qual_off = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, qual_strs), np.int64, n), out=qual_off[1:])
    qs = rec.qstart[sel].astype(np.int64)
    qe = rec.qend[sel].astype(np.int64)
    w_off = np.zeros(n + 1, np.int64)
    np.cumsum(qe - qs, out=w_off[1:])
    span = (rec.tend[sel] - rec.tstart[sel]).astype(np.int64)
    b_off = np.zeros(n + 1, np.int64)
    np.cumsum(span, out=b_off[1:])
    cig, c_off = _cat_cigars(cig_parts)
    return _Set(
        seq_cat=b"".join([t.encode() for t in seq_strs]), seq_off=seq_off,
        qual_cat=b"".join([t.encode() for t in qual_strs]), qual_off=qual_off,
        qs=qs, qe=qe, rev=rec.rev[sel].astype(np.uint8), w_off=w_off, cig=cig, c_off=c_off,
        b_off=b_off, rstart=layout.offsets[tids] + rec.tstart[sel].astype(np.int64),
        rspan=span.astype(np.int32),
        rbc=(np.zeros(n, np.int32) if barcodes is None
             else np.array([barcodes.get(r, 0) for r in rids], np.int32)),
        rrow=None if read_rows is None else np.array([read_rows[r] for r in rids], np.int32),
    )


def _at(a: np.ndarray, i=0) -> int:
    """The address of ``a[i]`` (``a`` one-dimensional and contiguous)."""
    return a.ctypes.data + int(i) * a.itemsize


def _expand_calls(lib, s: _Set, a: int, b: int, win, out) -> list:
    """The native calls that write the symbols and quals at every base that
    records ``[a, b)`` of ``s`` cover into their place in ``out`` (int8
    pair at ``b_off``): their strand-corrected windows into ``win`` (int8
    pair at ``w_off``), then their CIGARs expanded over them (deletions:
    symbol 4, qual 20). Each call as (routine, arguments, the count it
    must return), for ``_run``; the arguments hold addresses, so the
    caller keeps ``s``, ``win`` and ``out`` until the calls have run."""
    n, w0, b0 = b - a, s.w_off[a], s.b_off[a]
    w, m = int(s.w_off[b] - w0), int(s.b_off[b] - b0)
    return [
        (lib.prep_read_windows, (s.seq_cat, _at(s.seq_off, a), s.qual_cat, _at(s.qual_off, a),
                                 _at(s.qs, a), _at(s.qe, a), _at(s.rev, a), n,
                                 _at(win[0], w0), _at(win[1], w0), w), w),
        (lib.expand_cigars_packed, (_at(win[0]), _at(win[1]), _at(s.w_off, a), _at(s.cig),
                                    _at(s.c_off, a), n, _at(out[0], b0), _at(out[1], b0), m), m),
    ]


def _run(calls) -> int:
    """Make native calls in turn, each checked against the count it must
    return (None: any count of 0 or more); the last one's return value."""
    for fn, args, want in calls:
        got = fn(*args)
        assert got == want if want is not None else got >= 0, (fn.__name__, got, want)
    return got


def _pair(n: int) -> tuple[np.ndarray, np.ndarray]:
    return np.empty(n, np.int8), np.empty(n, np.int8)


def build_packed_runs(
    layout: GenomeLayout,
    record_sets,  # list of (rec, rows, seqs, quals)
    barcodes: dict[str, int] | None = None,
):
    """Packed per-read-run batch pieces for models.runs.ReadBatch.

    Returns (sym int8 [M], qual int8 [M], rstart int64 [R], rspan int32 [R],
    rbc int32 [R]) UNPADDED; callers pad. One C pass per record set emits
    symbols/quals; site indices are reconstructed on device. rstart is int64:
    concatenated-genome offsets exceed int32 beyond ~2.1 Gb.
    """
    lib = _bound()
    if lib is None:
        return _build_packed_runs_numpy(layout, record_sets, barcodes)
    tid_of = {n: i for i, n in enumerate(layout.names)}
    sym_chunks, qual_chunks = [], []
    rstarts, rspans, rbcs = [], [], []
    for rec, rows, seqs, quals in record_sets:
        s = _prepare(layout, tid_of, rec, rows, seqs, quals, barcodes)
        if s is None:
            continue
        win, (sym, qual) = _pair(int(s.w_off[-1])), _pair(int(s.b_off[-1]))
        _run(_expand_calls(lib, s, 0, s.rspan.shape[0], win, (sym, qual)))
        sym_chunks.append(sym)
        qual_chunks.append(qual)
        rstarts.append(s.rstart)
        rspans.append(s.rspan)
        rbcs.append(s.rbc)
    if not rspans:
        z8 = np.zeros(0, np.int8)
        z32 = np.zeros(0, np.int32)
        return z8, z8.copy(), z32, z32.copy(), z32.copy()
    return (
        np.concatenate(sym_chunks),
        np.concatenate(qual_chunks),
        np.concatenate(rstarts).astype(np.int64),
        np.concatenate(rspans),
        np.concatenate(rbcs),
    )


def _build_packed_runs_numpy(layout, record_sets, barcodes):
    from .paf import alignment_coverage

    tid_of = {n: i for i, n in enumerate(layout.names)}
    sym_chunks, qual_chunks = [], []
    rstarts, rspans, rbcs = [], [], []
    for rec, rows, seqs, quals in record_sets:
        for i in rows:
            tid = tid_of.get(rec.tname[i])
            if tid is None:
                continue
            rid = rec.qname[i]
            ts, te, symv, qv = alignment_coverage(rec, i, seqs[rid], quals.get(rid, ""))
            sym_chunks.append(symv.astype(np.int8))
            qual_chunks.append(np.clip(qv, 0, 127).astype(np.int8))
            rstarts.append(int(layout.offsets[tid]) + ts)
            rspans.append(te - ts)
            rbcs.append(0 if barcodes is None else barcodes.get(rid, 0))
    if not rspans:
        z8 = np.zeros(0, np.int8)
        z32 = np.zeros(0, np.int32)
        return z8, z8.copy(), z32, z32.copy(), z32.copy()
    return (
        np.concatenate(sym_chunks),
        np.concatenate(qual_chunks),
        np.asarray(rstarts, np.int64),
        np.asarray(rspans, np.int32),
        np.asarray(rbcs, np.int32),
    )


def split_runs(layout, sym, qual, rstart, rspan, rbc, qt: int = 0, len_b: int = 5):
    """Split per-base observations into match runs + explicit COO.

    Returns (mr_bc uint8, mr_g uint32, mr_len uint16, ex_bcsym uint16,
    ex_g uint32) UNPADDED (see models.runs.ReadBatch). Positions are carried
    as (barcode, uint32 position) pairs rather than flattened bc*G+g int32
    indices so the host format supports genomes up to 2^32 sites (~4.3 Gb;
    a human genome is 3.1e9); the device kernels flatten in int64. Dtypes
    are the narrowest that carry the ranges (<=256 barcodes; runs longer
    than 65535 are emitted as chunks), which keeps the per-batch upload
    small. C fast path with a NumPy fallback.
    """
    G = layout.G_pad
    ref = layout.seq_int.astype(np.int8)
    m = sym.shape[0]
    if m == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.uint32),
                np.zeros(0, np.uint16), np.zeros(0, np.uint16),
                np.zeros(0, np.uint32))
    if rbc.size and int(rbc.max()) > 255:
        raise ValueError("ReadBatch carries barcodes as uint8 (max 256 rows)")
    lib = _bound()
    if lib is not None:
        cap = m + 1
        mr_bc = np.empty(cap, np.uint8)
        mr_g = np.empty(cap, np.uint32)
        mr_len = np.empty(cap, np.uint16)
        ex_bcsym = np.empty(cap, np.uint16)
        ex_g = np.empty(cap, np.uint32)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        sym8 = np.ascontiguousarray(sym, np.int8)
        qual8 = np.ascontiguousarray(qual, np.int8)
        packed = lib.split_match_runs_wide_v2(
            c(sym8), c(qual8), m,
            c(np.ascontiguousarray(rstart, np.int64)),
            c(np.ascontiguousarray(rspan, np.int32)),
            c(np.ascontiguousarray(rbc, np.int32)), np.int32(rstart.shape[0]),
            c(ref), G, np.int32(qt), np.int32(len_b),
            c(mr_bc), c(mr_g), c(mr_len), cap, c(ex_bcsym), c(ex_g), cap,
        )
        assert packed >= 0
        nr, ne = packed >> 32, packed & 0xFFFFFFFF
        return (mr_bc[:nr].copy(), mr_g[:nr].copy(), mr_len[:nr].copy(),
                ex_bcsym[:ne].copy(), ex_g[:ne].copy())

    # NumPy fallback: expand positions, find match-run boundaries
    prefix = np.concatenate([[0], np.cumsum(rspan)])
    pos = np.concatenate(
        [np.arange(s, s + sp) for s, sp in zip(rstart, rspan)]
    ).astype(np.int64) if m else np.zeros(0, np.int64)
    bc = np.repeat(rbc.astype(np.int64), rspan)
    valid = (qual >= qt) & (pos < G)
    if len_b == 4:
        valid &= sym != 4
    is_match = valid & (sym == ref[np.minimum(pos, G - 1)])
    cont = (
        is_match[1:] & is_match[:-1]
        & (pos[1:] == pos[:-1] + 1) & (bc[1:] == bc[:-1])
    )
    # read boundaries always break runs (adjacent reads are adjacent in the
    # arrays but arbitrary in the genome; pos-continuity mostly covers this)
    bnd = prefix[1:-1] - 1
    cont[bnd[bnd >= 0]] = False
    starts = np.flatnonzero(is_match & ~np.concatenate([[False], cont]))
    ends = np.flatnonzero(is_match & ~np.concatenate([cont, [False]]))
    run_bc, run_g = bc[starts], pos[starts]
    run_len = ends - starts + 1
    if run_len.size and int(run_len.max()) > 65535:
        # chunk runs beyond the uint16 length cap (matches the C kernel)
        nch = -(-run_len // 65535)
        row = np.repeat(np.arange(run_len.size), nch)
        k = np.arange(row.size) - np.repeat(np.cumsum(nch) - nch, nch)
        run_bc = run_bc[row]
        run_g = run_g[row] + k * 65535
        run_len = np.minimum(run_len[row] - k * 65535, 65535)
    mr_bc = run_bc.astype(np.uint8)
    mr_g = run_g.astype(np.uint32)
    mr_len = run_len.astype(np.uint16)
    expl = valid & ~is_match
    ex_bcsym = (bc[expl] * 5 + sym[expl]).astype(np.uint16)
    ex_g = pos[expl].astype(np.uint32)
    return mr_bc, mr_g, mr_len, ex_bcsym, ex_g


def split_runs_rows(layout, sym, qual, rstart, rspan, rbc, rrow,
                    qt: int = 0, len_b: int = 5):
    """split_runs + the SOURCE READ INDEX of every output row.

    rrow: int32 per input record — callers pass each record's read index so
    the device can gate whole reads on/off with a per-read bit vector
    (models/runs.py step_gated). Returns (mr_bc, mr_g, mr_len, mr_read u32,
    ex_bcsym, ex_g, ex_read u32) UNPADDED. C fast path (v3) with a NumPy
    fallback mirroring split_runs' semantics exactly.
    """
    G = layout.G_pad
    ref = layout.seq_int.astype(np.int8)
    m = sym.shape[0]
    z32 = np.zeros(0, np.uint32)
    if m == 0:
        return (np.zeros(0, np.uint8), z32, np.zeros(0, np.uint16), z32,
                np.zeros(0, np.uint16), z32, z32)
    if rbc.size and int(rbc.max()) > 255:
        raise ValueError("ReadBatch carries barcodes as uint8 (max 256 rows)")
    lib = _bound()
    if lib is not None:
        cap = m + 1
        mr_bc = np.empty(cap, np.uint8)
        mr_g = np.empty(cap, np.uint32)
        mr_len = np.empty(cap, np.uint16)
        mr_read = np.empty(cap, np.uint32)
        ex_bcsym = np.empty(cap, np.uint16)
        ex_g = np.empty(cap, np.uint32)
        ex_read = np.empty(cap, np.uint32)
        c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        sym8 = np.ascontiguousarray(sym, np.int8)
        qual8 = np.ascontiguousarray(qual, np.int8)
        packed = lib.split_match_runs_wide_v3(
            c(sym8), c(qual8), m,
            c(np.ascontiguousarray(rstart, np.int64)),
            c(np.ascontiguousarray(rspan, np.int32)),
            c(np.ascontiguousarray(rbc, np.int32)),
            c(np.ascontiguousarray(rrow, np.int32)), np.int32(rstart.shape[0]),
            c(ref), G, np.int32(qt), np.int32(len_b),
            c(mr_bc), c(mr_g), c(mr_len), c(mr_read), cap,
            c(ex_bcsym), c(ex_g), c(ex_read), cap,
        )
        assert packed >= 0
        nr, ne = packed >> 32, packed & 0xFFFFFFFF
        return (mr_bc[:nr].copy(), mr_g[:nr].copy(), mr_len[:nr].copy(),
                mr_read[:nr].copy(), ex_bcsym[:ne].copy(), ex_g[:ne].copy(),
                ex_read[:ne].copy())

    # NumPy fallback: split each record alone and tag its outputs with its
    # read row (slow but exact; the C path is the production route)
    outs, mr_rows, ex_rows = [], [], []
    prefix = np.concatenate([[0], np.cumsum(rspan)]).astype(np.int64)
    for i in range(rstart.shape[0]):
        lo, hi = int(prefix[i]), int(prefix[i + 1])
        out = split_runs(layout, sym[lo:hi], qual[lo:hi], rstart[i: i + 1],
                         rspan[i: i + 1], rbc[i: i + 1], qt, len_b)
        outs.append(out)
        mr_rows.append(np.full(out[0].shape[0], rrow[i], np.uint32))
        ex_rows.append(np.full(out[3].shape[0], rrow[i], np.uint32))
    if not outs:
        return (np.zeros(0, np.uint8), z32, np.zeros(0, np.uint16), z32,
                np.zeros(0, np.uint16), z32, z32)
    cat = lambda k: np.concatenate([o[k] for o in outs])
    return (cat(0), cat(1), cat(2), np.concatenate(mr_rows),
            cat(3), cat(4), np.concatenate(ex_rows))


#: covered bases a chunk of the record-parallel pass is cut to; a set of
#: fewer than twice as many is one chunk, built on the calling thread.
#: Measured on an 8-core host: from ~64 Kbases two chunks beat one, and
#: chunks of 0.1-2 Mbases do best (PERF.md, section 6)
CHUNK_BASES = 1 << 17
#: chunks a set is cut into at most, for each worker: a chunk costs its
#: calls' hand-offs of the interpreter lock, and on 8 cores 8 chunks of a
#: 16-Mbase set beat 16 and 32 (cut by bases, no one read holds up one)
CHUNKS_PER_WORKER = 1

_pool: ThreadPoolExecutor | None = None
_pool_size = 0
_pool_lock = threading.Lock()


def _workers() -> tuple[ThreadPoolExecutor, int]:
    """The pass's pool, one thread for each core this process may use, made
    at its first use and kept for the process's life; and its size."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None:
            _pool_size = len(os.sched_getaffinity(0))
            _pool = ThreadPoolExecutor(_pool_size, thread_name_prefix="coo")
        return _pool, _pool_size


def _cuts(s: _Set, most: int) -> list[int]:
    """Record bounds ``[0, ..., n]`` that cut ``s`` into chunks of about
    ``CHUNK_BASES`` covered bases each, at most ``most`` and at least one."""
    n, total = s.rspan.shape[0], int(s.b_off[-1])
    k = min(n, most, total // CHUNK_BASES)
    if k <= 1:
        return [0, n]
    inner = np.searchsorted(s.b_off, total * np.arange(1, k) / k)
    return np.unique(np.concatenate([[0], inner, [n]])).tolist()


class _Bufs(NamedTuple):
    """A set's buffers for the pass, made on the calling thread: each chunk
    writes its own stretch of each (the rows of chunk ``j`` of records
    ``[a, b)`` from ``b_off[a] + j``, room for its bases and one more)."""
    win: tuple   # int8 symbols and quals of the windows, at w_off
    base: tuple  # int8 symbols and quals of the covered bases, at b_off
    mr: tuple    # mr_bc uint8, mr_g uint32, mr_len uint16[, mr_read uint32]
    ex: tuple    # ex_bcsym uint16, ex_g uint32[, ex_read uint32]

    @classmethod
    def of(cls, s: _Set, chunks: int) -> _Bufs:
        cap = int(s.b_off[-1]) + chunks
        rows = s.rrow is not None
        mr = (np.uint8, np.uint32, np.uint16) + ((np.uint32,) if rows else ())
        ex = (np.uint16, np.uint32) + ((np.uint32,) if rows else ())
        return cls(_pair(int(s.w_off[-1])), _pair(int(s.b_off[-1])),
                   tuple(np.empty(cap, t) for t in mr), tuple(np.empty(cap, t) for t in ex))


def _chunk_calls(lib, s: _Set, bufs: _Bufs, j: int, a: int, b: int, ref: np.ndarray,
                 G: int, qt: int, len_b: int) -> list:
    """The native calls of chunk ``j`` of ``s``, its records ``[a, b)``:
    their bases (``_expand_calls``), then split_runs of them (or, where
    ``s`` has read rows, split_runs_rows) into ``bufs`` from ``b_off[a] +
    j``. Made on the calling thread, so that a worker runs only the
    calls."""
    b0 = s.b_off[a]
    m, r0 = int(s.b_off[b] - b0), int(b0) + j
    mr = [_at(x, r0) for x in bufs.mr]
    ex = [_at(x, r0) for x in bufs.ex]
    head = (_at(bufs.base[0], b0), _at(bufs.base[1], b0), m, _at(s.rstart, a),
            _at(s.rspan, a), _at(s.rbc, a))
    tail = (_at(ref), G, qt, len_b)
    if s.rrow is None:
        split = (lib.split_match_runs_wide_v2,
                 (*head, b - a, *tail, *mr, m + 1, *ex, m + 1), None)
    else:
        split = (lib.split_match_runs_wide_v3,
                 (*head, _at(s.rrow, a), b - a, *tail, *mr, m + 1, *ex, m + 1), None)
    return _expand_calls(lib, s, a, b, bufs.win, bufs.base) + [split]


def coverage_rows(layout, record_sets, barcodes=None, *, read_rows=None, qt: int = 0,
                  len_b: int = 5):
    """The match runs and explicit rows of record sets: ``split_runs`` of
    ``build_packed_runs``, the same arrays in the same order; with
    ``read_rows`` (read id -> row), ``split_runs_rows``' seven, each
    record's row being its read's.

    One record-parallel pass: each set is made ready once (``_prepare``,
    its buffers ``_Bufs``), then cut into chunks of about equal covered
    bases, and each chunk's three compiled passes (windows, CIGAR
    expansion, match-run split) run on the shared pool (ctypes releases
    the interpreter lock); the chunks' rows are joined in order. No run
    crosses a record, so the join equals one call over the set. Where
    every set is one chunk (under twice ``CHUNK_BASES``), it runs on the
    calling thread and no pool is made. Span ``coo.build`` (attrs
    ``records``, ``bases``, ``chunks``, ``workers``) covers the passes.
    Without the native library, the NumPy fallbacks of
    ``build_packed_runs`` and the split.
    """
    lib = _bound()
    with_rows = read_rows is not None
    tid_of = {n: i for i, n in enumerate(layout.names)}
    if lib is None:
        packed = build_packed_runs(layout, record_sets, barcodes)
        if not with_rows:
            return split_runs(layout, *packed, qt, len_b)
        rrow = np.array([read_rows[rec.qname[i]] for rec, rows, _s, _q in record_sets
                         for i in rows if rec.tname[i] in tid_of], np.int32)
        return split_runs_rows(layout, *packed, rrow, qt, len_b)
    sets = [s for s in (_prepare(layout, tid_of, rec, rows, seqs, quals, barcodes, read_rows)
                        for rec, rows, seqs, quals in record_sets) if s is not None]
    bases = sum(int(s.b_off[-1]) for s in sets)
    if bases == 0:
        z32 = np.zeros(0, np.uint32)
        if with_rows:
            return (np.zeros(0, np.uint8), z32, np.zeros(0, np.uint16), z32.copy(),
                    np.zeros(0, np.uint16), z32.copy(), z32.copy())
        return (np.zeros(0, np.uint8), z32, np.zeros(0, np.uint16), np.zeros(0, np.uint16),
                z32.copy())
    if max(int(s.rbc.max()) for s in sets) > 255:
        raise ValueError("ReadBatch carries barcodes as uint8 (max 256 rows)")
    most = CHUNKS_PER_WORKER * len(os.sched_getaffinity(0))
    ref = layout.seq_int.view(np.int8)
    chunks, calls = [], []   # (where its rows start in which buffers), its calls
    for s in sets:
        cuts = list(itertools.pairwise(_cuts(s, most)))
        bufs = _Bufs.of(s, len(cuts))
        for j, (a, b) in enumerate(cuts):
            chunks.append((bufs, int(s.b_off[a]) + j))
            calls.append(_chunk_calls(lib, s, bufs, j, a, b, ref, layout.G_pad, qt, len_b))
    inline = len(chunks) == len(sets)
    pool, size = (None, 1) if inline else _workers()
    with spans.span("coo.build", records=sum(s.rspan.shape[0] for s in sets), bases=bases,
                    chunks=len(chunks), workers=size):
        packed = [_run(c) for c in calls] if inline else list(pool.map(_run, calls))
    mr = [[x[r0:r0 + (p >> 32)] for x in bufs.mr] for (bufs, r0), p in zip(chunks, packed)]
    ex = [[x[r0:r0 + (p & 0xFFFFFFFF)] for x in bufs.ex] for (bufs, r0), p in zip(chunks, packed)]
    return tuple(np.concatenate(f) for f in (*zip(*mr), *zip(*ex)))


EX_PAD = np.uint32(0xFFFFFFFF)
"""Sentinel ex_g value marking padding rows: it flattens to a negative /
out-of-shard scatter index that the device drops, so no separate weight
array rides the host->device transfer (models.runs.ReadBatch)."""


def pad_split(split, floors=(0, 0)):
    """Pad split_runs output into the ReadBatch array fields.

    Returns a dict with mr_bc/mr_g/mr_len/ex_bcsym/ex_g padded to _pad_len
    and at least ``floors`` — shared by pack_batch, the benches and the
    engine tests so every producer of a ReadBatch pads identically.
    Padding: mr_len 0, ex_g EX_PAD.
    """
    mr_bc, mr_g, mr_len, ex_bcsym, ex_g = split
    rm = max(_pad_len(mr_bc.shape[0]), floors[0], 4)
    me = max(_pad_len(ex_g.shape[0]), floors[1], 4)
    out = dict(
        mr_bc=np.zeros(rm, np.uint8), mr_g=np.zeros(rm, np.uint32),
        mr_len=np.zeros(rm, np.uint16),  # len 0 = padding
        ex_bcsym=np.zeros(me, np.uint16), ex_g=np.full(me, EX_PAD, np.uint32),
    )
    out["mr_bc"][: mr_bc.shape[0]] = mr_bc
    out["mr_g"][: mr_g.shape[0]] = mr_g
    out["mr_len"][: mr_len.shape[0]] = mr_len
    out["ex_bcsym"][: ex_bcsym.shape[0]] = ex_bcsym
    out["ex_g"][: ex_g.shape[0]] = ex_g
    return out


def pack_batch(layout, record_sets, *, device: str | torch.device | None, barcodes=None,
               rs=None, floors=(0, 0), qt: int = 0, len_b: int = 5):
    """Build a fully padded models.runs.ReadBatch on ``device`` from record
    sets; with ``device=None``, its fields as a dict of numpy arrays (a host
    batch, for RunsEngine.step_from_numpy).

    rs: optional (rs_row, rs_strand, rs_w) arrays. floors: (mr_floor,
    ex_floor) minimum pad sizes — callers pass the largest sizes seen so
    the batch shapes (and the allocator's blocks) stay stable.
    """
    padded = pad_split(coverage_rows(layout, record_sets, barcodes, qt=qt, len_b=len_b), floors)
    from ..models.convert import batch_from_numpy

    if rs is None:
        rs = (np.zeros(512, np.int32), np.zeros(512, np.int32), np.zeros(512, np.float32))
    fields = dict(rs_row=rs[0], rs_strand=rs[1], rs_w=rs[2], **padded)
    return fields if device is None else batch_from_numpy(fields, device)
