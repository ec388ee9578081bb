"""Native-accelerated CIGAR -> packed ReadBatch expansion (host hot path).

The port's copy of ``bossruns_tpu.io.coo_native``: the JAX module imports
``bossruns_tpu.aligner`` (and so JAX) at its top, and its ``pack_batch``
builds the JAX ReadBatch. Here the same NumPy and native code is bound
through the port's jax-free loader, and ``pack_batch`` returns the port's
``ReadBatch`` of torch tensors on an explicit device.

This path preps strand-corrected code/qual slices and packed cigars in
vectorised NumPy, then C calls (native/banded_align.cpp::
expand_cigars_packed + split_match_runs_wide) emit the match-run + explicit
COO pieces the device consumes. NumPy fallbacks keep everything functional
without the shared library.
"""
from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from ..aligner import native as native_mod
from ..models.layout import GenomeLayout
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
    lib = native_mod._load()
    if not lib or not hasattr(lib, "prep_read_windows"):
        return _build_packed_runs_numpy(layout, record_sets, barcodes)
    if not hasattr(lib, "_packed_ready"):
        lib.expand_cigars_packed.restype = ctypes.c_int64
        lib.expand_cigars_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.prep_read_windows.restype = ctypes.c_int64
        lib.prep_read_windows.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib._packed_ready = True
    tid_of = {n: i for i, n in enumerate(layout.names)}
    sym_chunks, qual_chunks = [], []
    rstarts, rspans, rbcs = [], [], []
    c = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    for rec, rows, seqs, quals in record_sets:
        rows = np.asarray(list(rows), dtype=np.int64)
        if rows.shape[0] == 0:
            continue
        tids = np.array(
            [tid_of.get(t, -1) for t in rec.tname[rows]], dtype=np.int64
        )
        sel = rows[tids >= 0]
        tids = tids[tids >= 0]
        n = sel.shape[0]
        if n == 0:
            continue
        rids = rec.qname[sel]
        cig_parts = [rec.cigars[i] for i in sel]
        if any(p is None for p in cig_parts):
            bad = rids[[j for j, p in enumerate(cig_parts) if p is None][0]]
            raise ValueError(f"record for {bad} has no cigar")
        seq_strs = [seqs[r] for r in rids]
        qual_strs = [quals.get(r, "") for r in rids]
        seq_cat = "".join(seq_strs).encode()
        qual_cat = "".join(qual_strs).encode()
        seq_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in seq_strs], out=seq_off[1:])
        qual_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in qual_strs], out=qual_off[1:])
        qs = rec.qstart[sel].astype(np.int64)
        qe = rec.qend[sel].astype(np.int64)
        rev = rec.rev[sel].astype(np.uint8)
        wtot = int((qe - qs).sum())
        seqs_win = np.empty(wtot, np.int8)
        quals_win = np.empty(wtot, np.int8)
        k = lib.prep_read_windows(
            seq_cat, c(seq_off), qual_cat, c(qual_off),
            c(qs), c(qe), c(np.ascontiguousarray(rev)), np.int32(n),
            c(seqs_win), c(quals_win), np.int64(wtot),
        )
        assert k == wtot, (k, wtot)
        s_off = np.zeros(n + 1, np.int64)
        np.cumsum(qe - qs, out=s_off[1:])
        cig_cat, c_off = _cat_cigars(cig_parts)
        spans = (rec.tend[sel] - rec.tstart[sel]).astype(np.int64)
        total = int(spans.sum())
        out_sym = np.zeros(total, np.int8)
        out_qual = np.zeros(total, np.int8)
        k = lib.expand_cigars_packed(
            c(seqs_win), c(quals_win), c(s_off), c(cig_cat), c(c_off),
            np.int32(n), c(out_sym), c(out_qual), np.int64(total),
        )
        assert k == total, (k, total)
        sym_chunks.append(out_sym)
        qual_chunks.append(out_qual)
        rstarts.append(layout.offsets[tids] + rec.tstart[sel].astype(np.int64))
        rspans.append(spans.astype(np.int32))
        rbcs.append(
            np.zeros(n, np.int32) if barcodes is None
            else np.array([barcodes.get(r, 0) for r in rids], np.int32)
        )
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
    lib = native_mod._load()
    if lib is not None and hasattr(lib, "split_match_runs_wide_v2"):
        if not hasattr(lib, "_split_ready"):
            lib.split_match_runs_wide_v2.restype = ctypes.c_int64
            lib.split_match_runs_wide_v2.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib._split_ready = True
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
    lib = native_mod._load()
    if lib is not None and hasattr(lib, "split_match_runs_wide_v3"):
        if not hasattr(lib, "_split3_ready"):
            lib.split_match_runs_wide_v3.restype = ctypes.c_int64
            lib.split_match_runs_wide_v3.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64,
            ]
            lib._split3_ready = True
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
    sym, qual, rstart, rspan, rbc = build_packed_runs(layout, record_sets, barcodes)
    split = split_runs(layout, sym, qual, rstart, rspan, rbc, qt, len_b)
    padded = pad_split(split, floors)
    from ..models.convert import batch_from_numpy

    if rs is None:
        rs = (np.zeros(512, np.int32), np.zeros(512, np.int32), np.zeros(512, np.float32))
    fields = dict(rs_row=rs[0], rs_strand=rs[1], rs_w=rs[2], **padded)
    return fields if device is None else batch_from_numpy(fields, device)
