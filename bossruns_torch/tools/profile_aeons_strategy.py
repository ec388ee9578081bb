"""The AEONS contig strategy by backend, at metagenome pool sizes.

    python -m bossruns_torch.tools.profile_aeons_strategy

``aeons.benefit.contig_strategies`` with backend "device" (H7 on the card)
and "host" (the f64 host path), beside the reference-equivalent f64 NumPy
pipeline (``bench._aeons_strategy_numpy``), on pools of 40 and 200 contigs
of 200 kb (8 and 40 Mb; coverage 0-29): host-clock medians.
"""
from __future__ import annotations

import time

import numpy as np

from ..bench import CCL
from ..device import device_name, require_cuda

LAM = 6000.0


def measure(n_contigs: int, label: str, dev) -> dict:
    from ..aeons.benefit import contig_strategies
    from ..bench import _aeons_strategy_numpy, strategy_pool

    pool = strategy_pool(n_contigs, np.random.default_rng(5))
    out = {}
    for backend in ("device", "host"):
        contig_strategies(pool, ccl=CCL, lam=LAM, backend=backend, device=dev)  # warm
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            contig_strategies(pool, ccl=CCL, lam=LAM, backend=backend, device=dev)
            ts.append(time.perf_counter() - t0)
        out[backend] = float(np.median(ts)) * 1e3
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        _aeons_strategy_numpy(pool, CCL, LAM)
        ts.append(time.perf_counter() - t0)
    out["cpu_f64_baseline"] = float(np.median(ts)) * 1e3
    print(f"{label}: " + "  ".join(f"{k}={v:.1f}ms" for k, v in out.items()), flush=True)
    return out


def main() -> dict:
    dev = require_cuda()
    out = {"8mb": measure(40, " 8 Mb (40 contigs)", dev),
           "40mb": measure(200, "40 Mb (200 contigs)", dev)}
    print(f"# {device_name(dev)}", flush=True)
    return out


if __name__ == "__main__":
    main()
