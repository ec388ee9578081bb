"""The checkpoint's npz writer (``bossruns_torch.utils.checkpoint.write_npz``).

It writes the npz that ``np.savez_compressed`` writes, deflating each
member in ``CHUNK``-byte pieces on a pool of threads. Held against numpy's
own file for every kind of array a checkpoint holds:

* the same members in the same order, each the same ``.npy`` bytes, every
  CRC right, zip64 sizes in every local header, the central directory as
  zipfile writes it, the file within 1% of numpy's (byte for byte where
  every member is one piece), and ``np.load`` gives the arrays back;
* pieces of any size join into one stream, the header's piece too;
* past zipfile's zip64 limit both writers put the same zip64 records.
"""
import io
import math
import os
import struct
import zipfile
import zlib

import numpy as np
import pytest

from bossruns_torch.utils import checkpoint as ckpt


def _counts(rng, sites):
    """Coverage-like uint16 counts: small Poisson counts on a true symbol."""
    cov = np.zeros((1, 5, sites), np.uint16)
    cov[0, rng.integers(0, 4, sites), np.arange(sites)] = rng.poisson(4.5, sites)
    return cov


def _case(name: str) -> dict:
    rng = np.random.default_rng(7)
    return {
        # 26 MiB: four pieces, so the pool deflates them
        "counts": lambda: {"coverage": _counts(rng, 2_730_000)},
        "bool": lambda: {"zeroed": rng.random((1, 70_001)) < 0.1},
        "f32": lambda: {"read_starts": rng.integers(0, 5, (4_000, 2)).astype(np.float32)},
        "f64": lambda: {"x": rng.standard_normal((3, 1_000))},
        "0-d": lambda: {"scalar": np.float32(2.5), "flag": np.array(True)},
        "empty": lambda: {"none": np.zeros((0, 3)), "nothing": np.array([], np.uint16)},
        "U": lambda: {"host__processed": np.array(sorted(f"run_{i}.fastq" for i in range(40)),
                                                  dtype="U")},
        # the sim's checkpoint as a whole, in its order, host__ arrays last
        "state": lambda: {"coverage": _counts(rng, 2_730_000),
                          "zeroed": rng.random((1, 27_300)) < 0.1,
                          "bucket_on": rng.random((1, 8)) < 0.5,
                          "read_starts": rng.integers(0, 5, (546, 2)).astype(np.float32),
                          "strat": rng.random((1, 27_300, 2)) < 0.5,
                          "host__rl_hist": np.arange(1_000, dtype=np.int64),
                          "host__processed": np.array(["a.fastq", "bb.fastq"], dtype="U")},
    }[name]()


def _pieces(arrays) -> list:
    return [math.ceil(len(_npy_bytes(a)) / ckpt.CHUNK) for a in arrays.values()]


def _npy_bytes(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _local_zip64(path, info) -> tuple:
    """(32-bit sizes, zip64 extra's sizes) of a member's local header."""
    with open(path, "rb") as fh:
        fh.seek(info.header_offset)
        head = fh.read(30)
        n_name, n_extra = struct.unpack("<2H", head[26:30])
        fh.read(n_name)
        extra = fh.read(n_extra)
    tag, size = struct.unpack("<2H", extra[:4])
    assert (tag, size) == (1, 16)
    return struct.unpack("<2L", head[18:26]), struct.unpack("<2Q", extra[4:20])


def _structure(zf: zipfile.ZipFile) -> list:
    """What the central directory says of each member, but where its
    deflated bytes lie and how many there are."""
    return [(i.filename, i.CRC, i.file_size, i.compress_type, i.flag_bits, i.extract_version,
             i.create_version, i.create_system, i.external_attr, i.internal_attr, i.date_time)
            for i in zf.infolist()]


def _same_npz(tmp_path, arrays) -> tuple:
    """Write ``arrays`` by both writers; assert the members agree; return
    (ours, numpy's) paths and ``write_npz``'s result."""
    ours, theirs = tmp_path / "ours.npz", tmp_path / "numpy.npz"
    got = ckpt.write_npz(ours, arrays)
    np.savez_compressed(theirs, **arrays)
    with zipfile.ZipFile(ours) as zo, zipfile.ZipFile(theirs) as zt:
        assert zo.testzip() is None
        assert zo.namelist() == zt.namelist() == [f"{k}.npy" for k in arrays]
        assert _structure(zo) == _structure(zt)
        for io_, it in zip(zo.infolist(), zt.infolist()):
            assert zo.read(io_) == zt.read(it), io_.filename
            assert io_.compress_type == zipfile.ZIP_DEFLATED
            assert io_.CRC == zlib.crc32(zt.read(it))
            # zip64 sizes in the local header, as numpy's force_zip64
            assert _local_zip64(ours, io_) == ((0xFFFFFFFF,) * 2,
                                               (io_.file_size, io_.compress_size))
    with np.load(ours) as z:
        assert list(z.keys()) == list(arrays)
        for k, v in arrays.items():
            assert z[k].dtype == np.asarray(v).dtype and z[k].shape == np.shape(v), k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    return ours, theirs, got


@pytest.mark.parametrize("case", ["counts", "bool", "f32", "f64", "0-d", "empty", "U", "state"])
def test_writes_the_npz_numpy_writes(tmp_path, case):
    arrays = _case(case)
    ours, theirs, (workers, chunks) = _same_npz(tmp_path, arrays)
    with zipfile.ZipFile(ours) as zo:
        for k, v in arrays.items():
            assert zo.read(f"{k}.npy") == _npy_bytes(v), k
    assert os.path.getsize(ours) == pytest.approx(os.path.getsize(theirs), rel=0.01)
    pieces = _pieces(arrays)
    assert chunks == sum(pieces)
    assert workers == min(len(os.sched_getaffinity(0)), max(pieces))
    if max(pieces) == 1:   # every member deflated inline, as one stream
        assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("chunk", [100, 1_000, 40_000])
def test_pieces_join_at_any_chunk_size(tmp_path, monkeypatch, chunk):
    """Pieces shorter than the header, than the 32 KiB window, and longer."""
    monkeypatch.setattr(ckpt, "CHUNK", chunk)
    rng = np.random.default_rng(3)
    arrays = {"coverage": _counts(rng, 30_000), "strat": rng.random((1, 300, 2)) < 0.5}
    _, _, (_, chunks) = _same_npz(tmp_path, arrays)
    assert chunks == sum(_pieces(arrays)) > 2


def test_zip64_records_past_zipfile_limit(tmp_path, monkeypatch):
    """Past zipfile's limit (lowered to 0 for both writers) sizes and offsets
    move into zip64 extras and the end records into zip64 ones, as numpy's."""
    monkeypatch.setattr(zipfile, "ZIP64_LIMIT", 0)
    arrays = _case("state")
    ours, theirs, _ = _same_npz(tmp_path, arrays)
    with zipfile.ZipFile(ours) as zo, zipfile.ZipFile(theirs) as zt:
        assert [len(i.extra) for i in zo.infolist()] == [len(i.extra) for i in zt.infolist()]
        assert all(i.extra[:2] == b"\x01\x00" for i in zo.infolist())
    for path in (ours, theirs):
        tail = path.read_bytes()[-22 - 20 - 56:]
        assert tail[:4] == b"PK\x06\x06" and tail[56:60] == b"PK\x06\x07"
