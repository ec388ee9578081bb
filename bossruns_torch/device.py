"""Device selection for the port: the main path runs on a CUDA card."""
from __future__ import annotations

import torch


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when no GPU is present.

    There is deliberately no CPU fallback here: a run that asked for the
    card and silently got the CPU would report CPU numbers as device ones.
    CPU execution is chosen explicitly by passing ``device="cpu"``.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available (torch.cuda.is_available() is False)")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"CUDA device {index} requested, {torch.cuda.device_count()} present")
    return torch.device("cuda", index)


def as_device(device: str | torch.device) -> torch.device:
    """Normalise a device argument; a CUDA device is checked with require_cuda."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return require_cuda(dev.index or 0)
    return dev
