"""Build and bind the hand-written CUDA kernels under ``bossruns_torch/csrc``.

Every ``.cu`` file there is compiled by ``nvcc`` for Hopper (sm_90a) into
an object of its own, all files at once in parallel processes, and the
objects are linked into one shared library with a plain C interface, at
first use, never when a module is imported:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c -o _build/<hash>/<name>.o csrc/<name>.cu   (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/libbosskernels_<hash>.so *.o

The library is keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses it. It is loaded with ctypes; every
pointer and the stream travel as ``c_void_p``. Each C entry point launches
on the caller's stream and returns its ``cudaError_t``; ``Kernel`` raises on
a nonzero return and counts launches, so a run can show that its main path
went through every kernel. There is no fallback: a missing ``nvcc`` or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


class RowArgs(ctypes.Structure):
    """Mirror of ``struct RowArgs`` in csrc/rows.cu (same field order)."""

    _fields_ = [
        *[(n, _I64) for n in ("nb", "G", "n_c1", "nw_pad", "nbk", "n_bits", "n_rs", "wf")],
        ("freeze_cov", ctypes.c_int32), ("gated", ctypes.c_int32),
        *[(n, ctypes.c_float) for n in
          ("dropout_mod", "dropout_min_mean", "bucket_threshold", "pad0")],
        *[(n, ctypes.c_double) for n in
          ("c_denom0", "c_bn0", "beta_denom", "p0_bit", "alpha", "on_target", "n_real_sites")],
        *[(n, _P) for n in (
            "covsum", "changed", "site_valid", "contig_id_ds", "contig_denom",
            "win_id_ds", "bucket_src", "bucket_valid", "rs_row", "rs_strand",
            "rs_w", "rs_read", "bits", "fhat_valid", "fhat_rows", "fhat_idx",
            "scores", "zeroed", "bucket_on", "read_starts",
            "scores_ds", "fhat_exp", "aux",
            "per_contig", "winsums", "total", "thr_c", "active_c", "fhat_w", "scale", "low",
            "tab", "slots",
        )],
        ("n_slots", _I64),
    ]


class StratArgs(ctypes.Structure):
    """Mirror of ``struct StratArgs`` in csrc/strategy.cu (same field order)."""

    _fields_ = [
        ("nb", _I64), ("Gd", _I64), ("nbk", _I64),
        ("mu_ds", ctypes.c_int32), ("quirks", ctypes.c_int32),
        ("win", ctypes.c_int32 * 10),
        ("weight", ctypes.c_double * 10),
        ("tc", ctypes.c_double),
        *[(n, _P) for n in (
            "scores_ds", "seg_start", "seg_end", "fhat_exp", "bucket_on",
            "bucket_idx", "strat_valid", "strat", "aux", "smu", "benefit",
            "threshold", "cs", "tile_sums", "norm_bits", "any_nz", "counts",
            "fsum", "ubar0",
        )],
        *[(n, _I64) for n in ("row0", "halo", "cs_stride", "n_tiles_g", "tile0")],
        ("ext", _P), ("tiles_g", _P),
    ]


class AeonsArgs(ctypes.Structure):
    """Mirror of ``struct AeonsArgs`` in csrc/aeons_strategy.cu (same field order)."""

    _fields_ = [
        ("n", _I64), ("C", _I64),
        ("win", ctypes.c_int32 * 11), ("pad0", ctypes.c_int32),
        ("weight", ctypes.c_double * 10),
        ("tc", ctypes.c_double), ("tbar0", ctypes.c_double),
        *[(n, _P) for n in (
            "cov", "ends", "flags", "table", "cs", "benefit", "smu_part", "norm_bits",
            "any_nz", "counts", "threshold", "mask",
        )],
    ]


class Kernel:
    """One C entry point of the kernel library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"kernel {self.name} failed: {error_string(err)}")
        self.launches += 1


KERNELS = {
    "coverage_update": Kernel(
        "coverage_update", "bk_coverage_update",
        [_P, _P, _P, _P, _I64] * 2 + [_P, _P, _P, _I64] * 2
        + [_P, _I64, _P, _P, _P, _P, _P, _I64, _I64, _P],
    ),
    "site_scores": Kernel(
        "site_scores", "bk_site_scores",
        [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _I64, _I64,
         ctypes.c_int, ctypes.c_float, _P, _P, _P],
    ),
    "row_stage": Kernel("row_stage", "bk_row_stage", [ctypes.POINTER(RowArgs), _P]),
    "benefit_strategy": Kernel(
        "benefit_strategy", "bk_benefit_strategy", [ctypes.POINTER(StratArgs), _P]
    ),
    "seed_topn": Kernel(
        "seed_topn", "bk_seed_topn",
        [_P, _I64, *[ctypes.c_int] * 5, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    ),
    "seed_candidates": Kernel(
        "seed_candidates", "bk_seed_candidates",
        [_P, _I64, *[ctypes.c_int] * 6, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
    ),
    "aeons_strategy": Kernel(
        "aeons_strategy", "bk_aeons_strategy", [ctypes.POINTER(AeonsArgs), _P]
    ),
    # H8: the sharded step's entry points into H1, H3 and H4 (one shard, one
    # phase per call; the collectives run between the calls)
    "shard_coverage": Kernel(
        "shard_coverage", "bk_shard_coverage",
        [_P, _P, _P, _I64, _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
    ),
    "shard_rows": Kernel(
        "shard_rows", "bk_shard_rows", [ctypes.POINTER(RowArgs), ctypes.c_int, _P]
    ),
    "shard_benefit": Kernel(
        "shard_benefit", "bk_shard_benefit", [ctypes.POINTER(StratArgs), ctypes.c_int, _P]
    ),
}


def launches() -> dict[str, int]:
    return {k: v.launches for k, v in KERNELS.items()}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


_lock = threading.Lock()
_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


#: where nvcc is looked for after $CUDA_HOME/bin and PATH
NVCC_FALLBACK = ("/usr/local/cuda/bin/nvcc",)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then NVCC_FALLBACK."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands += [Path(p) for p in NVCC_FALLBACK]
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of bossruns_torch are built only where the CUDA toolkit is "
        "installed; CPU tensors use the plain PyTorch versions instead"
    )


def build(build_dir: str | Path | None = None) -> Path:
    """Compile csrc/*.cu into a shared library (cached by source hash): one
    nvcc process per source, all started together, then one link.

    Raises RuntimeError when nvcc is absent or the build fails.
    """
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    so = out_dir / f"libbosskernels_{source_hash()}.so"
    if so.exists():
        return so
    nvcc = find_nvcc()
    tag = f"{so.stem}.tmp{os.getpid()}"
    obj_dir = out_dir / tag
    obj_dir.mkdir(parents=True, exist_ok=True)
    try:
        srcs = sorted(CSRC.glob("*.cu"))
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj_dir / f"{p.stem}.o"),
                                   str(p)], stderr=subprocess.PIPE, text=True) for p in srcs]
        errs = [proc.communicate()[1] for proc in procs]  # every nvcc ends before a raise
        for p, proc, err in zip(srcs, procs, errs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {p.name} ({proc.returncode}):\n{err[-4000:]}")
        tmp = out_dir / f"{tag}.so"
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *(str(obj_dir / f"{p.stem}.o") for p in srcs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        os.rename(tmp, so)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    return so


def load():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.bk_error_string.argtypes = [ctypes.c_int]
            lib.bk_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    if err == -1:
        return "unsupported shape"
    return f"{err} ({load().bk_error_string(err).decode()})"


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C functions take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None,
          device: torch.device | None = None) -> None:
    """Raise unless t is a contiguous CUDA tensor of the given dtype/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
