"""Carry engine state and batches between NumPy (the JAX package's host
form) and the port's tensors.

BOSS-RUNS has no weights: what carries over between the two engines, and
into and out of checkpoints, is the GenomeState and the read batches. The
field names and dtypes are the JAX package's (uint16 coverage, uint32
positions), so a state taken from the JAX engine with ``np.asarray`` loads
here unchanged and the reverse.
"""
from __future__ import annotations

import numpy as np
import torch

from .runs import GenomeState, ReadBatch, normalize_state


def tensors_from_numpy(d: dict, device) -> dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on device}, dtypes kept. Always a
    copy, so an in-place step never writes into the caller's arrays."""
    out = {}
    for k, v in d.items():
        a = np.ascontiguousarray(v)
        # a read-only array (e.g. np.asarray of a JAX array) cannot back a tensor
        out[k] = torch.from_numpy(a if a.flags.writeable else a.copy()).to(device, copy=True)
    return out


def state_from_numpy(d: dict, device, dtype=torch.float32) -> GenomeState:
    """GenomeState fields as numpy (e.g. the JAX engine's state through
    np.asarray) -> the port's GenomeState on device, read_starts in
    ``dtype``, the engine's score dtype (the JAX engine keeps them in its
    ``dtype``, so an f64-score state carries across whole)."""
    t = tensors_from_numpy({k: d[k] for k in GenomeState._fields}, device)
    return normalize_state(GenomeState(**t), dtype)


def state_to_numpy(state: GenomeState) -> dict[str, np.ndarray]:
    """The port's GenomeState -> {field: numpy array}. Always a copy: the
    engine updates its state in place, and a view of a CPU tensor would
    change with it."""
    return {k: v.cpu().numpy().copy() for k, v in state._asdict().items()}


def batch_from_numpy(d: dict, device) -> ReadBatch:
    """ReadBatch fields as numpy (e.g. io.coo_native.pad_split + rs rows)
    -> the port's ReadBatch on device."""
    return ReadBatch(**tensors_from_numpy({k: d[k] for k in ReadBatch._fields}, device))
