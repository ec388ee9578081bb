"""Checkpoints of the port, in the JAX package's on-disk format.

``save_checkpoint`` writes the state as NumPy through the JAX package's
writer (copied here as ``_save_np``), so a checkpoint of either engine
loads into the other; ``load_checkpoint`` reads the same npz/json pair into
the port's tensors. A sharded engine passes its gathered state as a dict of
NumPy arrays. ``MetricsWriter`` is the JAX package's per-batch JSONL writer.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from ..models.convert import state_from_numpy, state_to_numpy
from ..models.runs import GenomeState

logger = logging.getLogger("boss_torch")


def save_checkpoint(out_dir: str | Path, state, host_state: dict,
                    tag: str = "state", extra_arrays: dict | None = None) -> Path:
    """Atomically persist the state (a GenomeState of tensors, or its
    fields as a dict of NumPy arrays) and a host dict."""
    arrays = state if isinstance(state, dict) else state_to_numpy(state)
    return _save_np(out_dir, GenomeState(**arrays), host_state,
                    tag=tag, extra_arrays=extra_arrays)


def load_checkpoint(out_dir: str | Path, device, tag: str = "state", *, numpy: bool = False):
    """(GenomeState on device, host_state, extra arrays), or None if absent.
    With ``numpy=True`` the state comes back as a dict of NumPy arrays (for
    an engine that places it itself, such as the sharded one)."""
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
        state = state_from_numpy(fields, device)
    host_state = json.loads(meta.read_text())
    logger.info(f"restored checkpoint from {final}")
    return state, host_state, extra


def _save_np(out_dir: str | Path, state, host_state: dict, tag: str = "state",
             extra_arrays: dict | None = None) -> Path:
    """Atomically persist a GenomeState-like NamedTuple + host dict.

    extra_arrays: host-side numpy arrays (e.g. the read-length histogram),
    stored in the same npz under 'host__<name>'.
    """
    from ..parallel.distributed import fetch, is_primary

    ckpt = Path(out_dir) / "checkpoint"
    final = ckpt / f"{tag}.npz"
    # fetch is a collective in multi-host runs (genome-sharded arrays
    # all-gather): EVERY process must execute it, then only the primary writes
    arrays = {k: fetch(v) for k, v in state._asdict().items()}
    if not is_primary():
        return final
    ckpt.mkdir(parents=True, exist_ok=True)
    tmp = ckpt / f"{tag}_tmp.npz"
    for k, v in (extra_arrays or {}).items():
        arrays[f"host__{k}"] = np.asarray(v)
    np.savez_compressed(tmp, **arrays)
    tmp.rename(final)
    meta_tmp = ckpt / f"{tag}_meta_tmp.json"
    meta = ckpt / f"{tag}_meta.json"
    meta_tmp.write_text(json.dumps(host_state, default=_coerce))
    meta_tmp.rename(meta)
    return final


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
        with open(self.path, "a") as fh:
            fh.write(json.dumps(fields, default=_coerce) + "\n")
