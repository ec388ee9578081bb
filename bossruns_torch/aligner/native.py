"""ctypes loader for the shared native host library (native/libbossnative.so).

The same C++ source and Makefile as ``bossruns_tpu.aligner.native``, with the
same stale check and atomic build, but importing no JAX: the JAX package
reaches its loader through ``bossruns_tpu/aligner/__init__.py``, which
imports the device seeding module and so JAX. Only the loader lives here;
the PAF parser and the CIGAR expansion bind their own symbols.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

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
