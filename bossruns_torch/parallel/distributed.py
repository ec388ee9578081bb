"""Multi-process runtime support on torch.distributed.

The counterpart of ``bossruns_tpu.parallel.distributed``: the process-level
plumbing that turns the sharded update step (``parallel/mesh.py``) into a
program of one process per rank.

  * ``init_from_env`` joins the process group from the same environment
    variables as the JAX package: ``BOSS_COORDINATOR=host:port``,
    ``BOSS_NUM_PROCESSES=N`` and ``BOSS_PROCESS_ID=i``. The group uses
    ``tcp://`` initialisation, NCCL when the process drives a CUDA device
    and gloo on the CPU. Unset means a single process, and it is a no-op.
  * every process runs the same host program (same config, same seed, same
    batch order: the SPMD contract); each holds the shard of its rank.
  * ``fetch`` is the one way host code reads a sharded tensor: it gathers
    the shards of every rank to every rank.
  * file outputs (masks npz, metrics, checkpoints) happen on the primary
    process only; ``is_primary`` gates them in the simulation and
    experiment classes.

This is a leaf module: it imports nothing else of the package.
"""
from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("boss_torch")

ENV_COORD = "BOSS_COORDINATOR"
ENV_NPROC = "BOSS_NUM_PROCESSES"
ENV_PID = "BOSS_PROCESS_ID"


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_from_env(device=None) -> bool:
    """Join the process group if BOSS_COORDINATOR/... are set.

    device: the device this process computes on; a CUDA device selects the
    NCCL backend (and becomes the current device), anything else gloo.
    Returns True when the run is multi-process."""
    coord = os.environ.get(ENV_COORD)
    if not coord:
        return False
    if is_initialized():
        return True
    import torch

    nproc = int(os.environ[ENV_NPROC])
    pid = int(os.environ[ENV_PID])
    dev = torch.device(device) if device is not None else torch.device("cpu")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _dist().init_process_group(backend, init_method=f"tcp://{coord}", world_size=nproc,
                               rank=pid)
    logger.info(f"process group up: rank {pid}/{nproc}, backend {backend}")
    return True


def close() -> None:
    """Leave the process group (every rank, after its last collective)."""
    _dist().destroy_process_group()


def rank_device(spec=None):
    """The device this process computes on: ``spec`` (default "cuda");
    a CUDA device without an index is card ``rank`` when BOSS_COORDINATOR
    is set, one rank per card, and card 0 otherwise. More ranks than cards
    raise: NCCL refuses two ranks on one card."""
    import torch

    dev = torch.device(spec if spec is not None else "cuda")
    if dev.type == "cuda" and dev.index is None:
        rank = 0
        if ENV_COORD in os.environ:
            nproc, cards = int(os.environ[ENV_NPROC]), torch.cuda.device_count()
            if nproc > cards:
                raise RuntimeError(f"{ENV_NPROC}={nproc} ranks on {cards} CUDA device(s): "
                                   "NCCL takes one rank per card")
            rank = int(os.environ[ENV_PID])
        dev = torch.device("cuda", rank)
    return dev


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns shared-filesystem writes (masks npz,
    metrics, checkpoints, read dumps)."""
    if ENV_COORD in os.environ:
        return int(os.environ.get(ENV_PID, "0")) == 0
    return process_index() == 0


def gather(x, group=None) -> list[np.ndarray]:
    """Every rank's ``x`` (same shape and dtype on each), in rank order, as
    NumPy on every rank; bool and uint16 tensors travel as uint8 and
    int16, which every backend gathers."""
    import torch

    dist = _dist()
    dtype = x.dtype
    y = x.to(torch.uint8) if dtype == torch.bool else x
    y = (y.view(torch.int16) if dtype == torch.uint16 else y).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    out = [t.cpu().numpy() for t in parts]
    if dtype == torch.bool:
        return [a.astype(bool) for a in out]
    if dtype == torch.uint16:
        return [a.view(np.uint16) for a in out]
    return out


def fetch(x, dim: int | None = None, group=None) -> np.ndarray:
    """A tensor or array -> host numpy, whatever the process topology.

    With ``dim`` set in a multi-process run, x is this rank's shard of a
    tensor split along ``dim`` over ``group`` (the world by default); the
    shards of every rank, in rank order, are gathered to every rank. Callers
    gate file writes on is_primary, not on who holds the data."""
    import torch

    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if dim is None or not is_initialized():
        return x.detach().cpu().numpy()
    return np.concatenate(gather(x, group), axis=dim)
