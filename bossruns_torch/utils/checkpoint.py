"""Checkpoints of the port, in the JAX package's on-disk format.

``save_checkpoint`` writes the state as NumPy in the JAX package's format
(``_save_np``: the npz/json pair, tmp file then rename), so a checkpoint
of either engine loads into the other; ``load_checkpoint`` reads the same
pair into the port's tensors. A sharded engine passes its gathered state
as a dict of NumPy arrays. The npz is the one ``np.savez_compressed``
writes, written by a parallel deflate (``write_npz``): each member's bytes
are deflated at level 6 in chunks on every core this process may use.
``MetricsWriter`` is the JAX package's per-batch JSONL writer.
"""
from __future__ import annotations

import io
import json
import logging
import os
import struct
import zipfile
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..models.convert import state_from_numpy, state_to_numpy
from ..models.runs import GenomeState
from . import spans

logger = logging.getLogger("boss_torch")


def save_checkpoint(out_dir: str | Path, state, host_state: dict,
                    tag: str = "state", extra_arrays: dict | None = None) -> Path:
    """Atomically persist the state (a GenomeState of tensors, or its
    fields as a dict of NumPy arrays) and a host dict."""
    arrays = state if isinstance(state, dict) else pull_state(state)
    return _save_np(out_dir, GenomeState(**arrays), host_state,
                    tag=tag, extra_arrays=extra_arrays)


def pull_state(state, to_numpy=state_to_numpy) -> dict[str, np.ndarray]:
    """``to_numpy(state)`` (the state's fields as NumPy) timed as a
    checkpoint's pull, its bytes counted as copied from the device."""
    with spans.span("checkpoint.pull"):
        arrays = to_numpy(state)
    spans.count("bytes.d2h", sum(a.nbytes for a in arrays.values()))
    return arrays


def load_checkpoint(out_dir: str | Path, device, tag: str = "state", *, numpy: bool = False,
                    dtype=torch.float32):
    """(GenomeState on device, host_state, extra arrays), or None if absent;
    read_starts come back in ``dtype`` (the engine's score dtype), whatever
    dtype wrote them. With ``numpy=True`` the state comes back as a dict of
    NumPy arrays (for an engine that places it itself, such as the sharded
    one)."""
    ckpt = Path(out_dir) / "checkpoint"
    final = ckpt / f"{tag}.npz"
    meta = ckpt / f"{tag}_meta.json"
    if not final.exists() or not meta.exists():
        return None
    with np.load(final) as z:
        fields = {k: z[k] for k in z}
    extra = {k[len("host__"):]: v for k, v in fields.items() if k.startswith("host__")}
    if numpy:
        state = {k: fields[k] for k in GenomeState._fields}
    else:
        state = state_from_numpy(fields, device, dtype)
    host_state = json.loads(meta.read_text())
    logger.info(f"restored checkpoint from {final}")
    return state, host_state, extra


def _save_np(out_dir: str | Path, state, host_state: dict, tag: str = "state",
             extra_arrays: dict | None = None) -> Path:
    """Atomically persist a GenomeState-like NamedTuple + host dict.

    extra_arrays: host-side numpy arrays (e.g. the read-length histogram),
    stored in the same npz under 'host__<name>'. The npz is the JAX
    package's (``np.savez_compressed``'s), written by ``write_npz``; the
    ``checkpoint.write`` span carries its ``workers`` and ``chunks``.
    """
    from ..parallel.distributed import fetch, is_primary

    ckpt = Path(out_dir) / "checkpoint"
    final = ckpt / f"{tag}.npz"
    # fetch is a collective in multi-host runs (genome-sharded arrays
    # all-gather): EVERY process must execute it, then only the primary writes
    arrays = {k: fetch(v) for k, v in state._asdict().items()}
    if not is_primary():
        return final
    tmp = ckpt / f"{tag}_tmp.npz"
    for k, v in (extra_arrays or {}).items():
        arrays[f"host__{k}"] = np.asarray(v)
    meta_tmp = ckpt / f"{tag}_meta_tmp.json"
    meta = ckpt / f"{tag}_meta.json"
    with spans.span("checkpoint.write") as sp:
        ckpt.mkdir(parents=True, exist_ok=True)
        workers, chunks = write_npz(tmp, arrays)
        sp.attr("workers", workers)
        sp.attr("chunks", chunks)
        tmp.rename(final)
        meta_tmp.write_text(json.dumps(host_state, default=_coerce))
        meta_tmp.rename(meta)
    spans.count_files(final, meta)
    return final


#: raw bytes of a member deflated as one piece; a piece after the first is
#: primed with the 32 KiB before it (deflate's whole window), so the pieces
#: join into one stream that compresses as a single stream does
CHUNK = 8 << 20
_WINDOW = 32 << 10
_LEVEL = 6   # np.savez_compressed's: zipfile's deflate at zlib's default level
_NO_SIZE = 0xFFFFFFFF   # a 32-bit field whose value is in the zip64 extra
# zipfile's records (its struct formats); every member as zipfile writes
# one that numpy opens with force_zip64=True: version 45, deflated, dated
# 1980-01-01 00:00, mode rw------- on unix
_LOCAL = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_END = struct.Struct("<4s4H2LH")
_END64 = struct.Struct("<4sQ2H2L4Q")
_LOCATOR64 = struct.Struct("<4sLQL")
_VERSION, _DOSDATE, _UNIX, _MODE = 45, (1 << 5) | 1, 3, 0o600 << 16


def write_npz(path: str | Path, arrays: dict) -> tuple[int, int]:
    """Write ``arrays`` to ``path`` as the npz ``np.savez_compressed`` writes:
    members ``<name>.npy`` in order, each the bytes ``np.save`` writes (the
    data in C order), deflated at level 6, with zip64 sizes in every local
    header, and zip64 end records where zipfile writes them.

    A member is deflated in ``CHUNK``-byte pieces on a pool of threads (zlib
    releases the interpreter lock), one for each core this process may use
    and at most one a piece; a member of one piece is deflated inline. The
    pieces are written in order as they finish, the raw bytes' CRC-32 taken
    in order meanwhile, and the member's local header patched afterwards,
    as zipfile does. Returns (the pool's size, the pieces deflated).
    """
    members = [(f"{k}.npy".encode("ascii"), *_npy(v)) for k, v in arrays.items()]
    most = max((-(-(len(h) + len(b)) // CHUNK) for _, h, b in members), default=1)
    workers = max(1, min(len(os.sched_getaffinity(0)), most))
    entries, chunks = [], 0
    with open(path, "wb") as fh, ThreadPoolExecutor(workers) as pool:
        for fname, head, body in members:
            offset = fh.tell()
            fh.write(_local(fname, 0, 0, 0))
            crc, size, csize, n = 0, len(head) + len(body), 0, 0
            pieces = _pieces(head, body)
            for raw, out in _deflated(pieces, pool if size > CHUNK else None, 2 * workers):
                crc = zlib.crc32(raw, crc)
                fh.write(out)
                csize += len(out)
                n += 1
            end = fh.tell()
            fh.seek(offset)
            fh.write(_local(fname, crc, size, csize))
            fh.seek(end)
            entries.append(_central(fname, crc, size, csize, offset))
            chunks += n
        start = fh.tell()
        fh.write(b"".join(entries))
        stop = fh.tell()
        count, cd_size = len(entries), stop - start
        if (count > zipfile.ZIP_FILECOUNT_LIMIT or start > zipfile.ZIP64_LIMIT
                or cd_size > zipfile.ZIP64_LIMIT):
            fh.write(_END64.pack(b"PK\x06\x06", _END64.size - 12, _VERSION, _VERSION, 0, 0,
                                 count, count, cd_size, start))
            fh.write(_LOCATOR64.pack(b"PK\x06\x07", 0, stop, 1))
        fh.write(_END.pack(b"PK\x05\x06", 0, 0, min(count, 0xFFFF), min(count, 0xFFFF),
                           min(cd_size, _NO_SIZE), min(start, _NO_SIZE), 0))
    return workers, chunks


def _npy(a) -> tuple[bytes, memoryview]:
    """The ``.npy`` header ``np.save`` writes for ``a``, and ``a``'s bytes
    in C order (a view where ``a`` is C-contiguous)."""
    a = np.asarray(a, order="C")
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(head, np.lib.format.header_data_from_array_1_0(a))
    return head.getvalue(), memoryview(a.reshape(-1).view(np.uint8))


def _pieces(head: bytes, body: memoryview):
    """(raw bytes, the 32 KiB before them or None, last) of each ``CHUNK``
    of the member ``head + body``."""
    h, size = len(head), len(head) + len(body)

    def raw(lo, hi):
        if lo >= h:
            return body[lo - h:hi - h]
        return head[lo:hi] + body[:max(hi - h, 0)].tobytes()

    for lo in range(0, size, CHUNK):
        hi = min(lo + CHUNK, size)
        yield raw(lo, hi), (raw(max(lo - _WINDOW, 0), lo) if lo else None), hi == size


def _deflate(raw, zdict, last: bool) -> bytes:
    """Raw deflate of one piece, primed with ``zdict``; ended by a sync
    flush (byte-aligned, the stream open), or by the final block."""
    c = (zlib.compressobj(_LEVEL, zlib.DEFLATED, -15, zdict=zdict) if zdict is not None
         else zlib.compressobj(_LEVEL, zlib.DEFLATED, -15))
    return c.compress(raw) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def _deflated(pieces, pool, depth: int):
    """(raw, deflated) of each piece in order: on ``pool``, at most ``depth``
    in flight, or inline without one."""
    if pool is None:
        for raw, zdict, last in pieces:
            yield raw, _deflate(raw, zdict, last)
        return
    pending = deque()
    for raw, zdict, last in pieces:
        pending.append((raw, pool.submit(_deflate, raw, zdict, last)))
        if len(pending) >= depth:
            raw0, fut = pending.popleft()
            yield raw0, fut.result()
    while pending:
        raw0, fut = pending.popleft()
        yield raw0, fut.result()


def _local(fname: bytes, crc: int, size: int, csize: int) -> bytes:
    """A member's local header with its zip64 sizes, as zipfile writes it
    under ``force_zip64``."""
    extra = struct.pack("<HHQQ", 1, 16, size, csize)
    return _LOCAL.pack(b"PK\x03\x04", _VERSION, 0, 0, zipfile.ZIP_DEFLATED, 0, _DOSDATE, crc,
                       _NO_SIZE, _NO_SIZE, len(fname), len(extra)) + fname + extra


def _central(fname: bytes, crc: int, size: int, csize: int, offset: int) -> bytes:
    """A member's central directory entry: a zip64 extra holds what passes
    zipfile's limit, as zipfile writes it."""
    big = []
    if size > zipfile.ZIP64_LIMIT or csize > zipfile.ZIP64_LIMIT:
        big += [size, csize]
        size = csize = _NO_SIZE
    if offset > zipfile.ZIP64_LIMIT:
        big.append(offset)
        offset = _NO_SIZE
    extra = struct.pack(f"<HH{len(big)}Q", 1, 8 * len(big), *big) if big else b""
    return _CENTRAL.pack(b"PK\x01\x02", _VERSION, _UNIX, _VERSION, 0, 0, zipfile.ZIP_DEFLATED, 0,
                         _DOSDATE, crc, csize, size, len(fname), len(extra), 0, 0, 0,
                         _MODE, offset) + fname + extra


def _coerce(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, set):
        return sorted(o)
    raise TypeError(type(o))


class MetricsWriter:
    """Per-batch JSONL metrics into out_<name>/metrics/ — the reference
    creates the directory but never writes to it (SURVEY.md §5)."""

    def __init__(self, out_dir: str | Path, name: str = "batches"):
        self.path = Path(out_dir) / "metrics" / f"{name}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, **fields) -> None:
        from ..parallel.distributed import is_primary

        if not is_primary():
            return
        line = json.dumps(fields, default=_coerce) + "\n"
        with open(self.path, "a") as fh:
            fh.write(line)
        spans.count("bytes.disk", len(line))
