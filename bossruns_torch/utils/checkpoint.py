"""Checkpoints of the port, in the JAX package's on-disk format.

Writing goes through the shared ``bossruns_tpu.utils.checkpoint.
save_checkpoint`` with the state as NumPy (it cannot convert CUDA tensors
itself), so a checkpoint of either engine loads into the other. The JAX
loader builds JAX arrays; ``load_checkpoint`` here reads the same npz/json
pair into the port's tensors.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from bossruns_tpu.utils.checkpoint import save_checkpoint as _save_np

from ..models.convert import state_from_numpy, state_to_numpy
from ..models.runs import GenomeState

logger = logging.getLogger("boss_torch")


def save_checkpoint(out_dir: str | Path, state: GenomeState, host_state: dict,
                    tag: str = "state", extra_arrays: dict | None = None) -> Path:
    """Atomically persist the state (as NumPy) and a host dict."""
    return _save_np(out_dir, GenomeState(**state_to_numpy(state)), host_state,
                    tag=tag, extra_arrays=extra_arrays)


def load_checkpoint(out_dir: str | Path, device, tag: str = "state"):
    """(GenomeState on device, host_state, extra arrays), or None if absent."""
    ckpt = Path(out_dir) / "checkpoint"
    final = ckpt / f"{tag}.npz"
    meta = ckpt / f"{tag}_meta.json"
    if not final.exists() or not meta.exists():
        return None
    with np.load(final) as z:
        fields = {k: z[k] for k in z}
    extra = {k[len("host__"):]: v for k, v in fields.items() if k.startswith("host__")}
    state = state_from_numpy(fields, device)
    host_state = json.loads(meta.read_text())
    logger.info(f"restored checkpoint from {final}")
    return state, host_state, extra
