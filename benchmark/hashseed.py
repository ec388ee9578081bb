"""Python's string hashing fixed for a run whose program iterates over sets.

The AEONS code iterates over sets of sequence ids (as the upstream's and
the JAX package's do), so its assembly, and with it the work of each
batch, depends on ``PYTHONHASHSEED``. A driver of such a cell calls
``fix_hash_seed`` before it builds anything: under ``python -m
benchmark`` the process is replaced by the same command with the seed 0,
unless it is 0 already. The variable is read only at an interpreter's
start, so no later setting in the process would do.
"""
from __future__ import annotations

import os
import sys


def main_is_benchmark() -> bool:
    """Whether this process is ``python -m benchmark``."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    return spec is not None and spec.name == "benchmark.__main__"


def fix_hash_seed(argv: list[str]) -> None:
    """Replace this process by ``argv`` with ``PYTHONHASHSEED=0`` unless
    the variable is already 0."""
    if os.environ.get("PYTHONHASHSEED") == "0":
        return
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(argv[0], argv, dict(os.environ, PYTHONHASHSEED="0"))
