"""Shared host utilities: atomic strategy-mask writes, logging, ids."""
from __future__ import annotations

import logging
import random
import string
from pathlib import Path

import numpy as np

from . import spans


def init_logger(logfile: str | Path | None = None, level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger("boss_tpu")
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if logfile is not None:
        fh = logging.FileHandler(str(logfile))
        fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(fh)
    return logger


def write_strategy_npz(out_dir: str | Path, strat_dict: dict[str, np.ndarray], name: str = "boss") -> Path:
    """Atomically (tmp + rename) write the strategy mask file that the
    readfish side polls — the cross-process contract of the reference
    (runs/core.py:59-73). In a multi-host run only the primary process
    writes (all processes hold identical strategies — SPMD contract)."""
    from ..parallel.distributed import is_primary

    masks = Path(out_dir) / "masks"
    final = masks / f"{name}.npz"
    if not is_primary():
        return final
    tmp = masks / f"{name}_tmp.npz"
    with spans.span("mask.write"):
        masks.mkdir(parents=True, exist_ok=True)
        np.savez(tmp, **strat_dict)
        tmp.rename(final)
    spans.count_files(final)
    return final


def read_strategy_npz(path: str | Path) -> dict[str, np.ndarray]:
    with np.load(path) as container:
        return {k: container[k] for k in container}


def random_id(k: int = 20) -> str:
    return "".join(random.choices(string.ascii_letters + string.digits, k=k))


def make_output_dirs(name: str, base: str | Path = ".") -> Path:
    """Output directory tree of an experiment (core.py:35-55)."""
    out = Path(base) / f"out_{name}"
    for sub in ("masks", "fq", "logs", "contigs/prev", "contigs/init", "metrics", "tmp"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    return out
