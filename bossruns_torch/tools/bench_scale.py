"""Step latency against genome size on one card.

    python -m bossruns_torch.tools.bench_scale [sizes_mb ...]   # default 8 33 67 134

Builds successively larger random layouts (haploid, one barcode), runs the
update step (``RunsEngine.step`` + the aux pull) with a 4000-read batch,
and prints the warm p50 of each size (one JSON line a size) until the
card's memory runs out, which prints ``scale_probe_failed`` and stops. The
largest size that passes is the single-card anchor for chromosome scale;
the sharded engine (``parallel.mesh``) carries anything larger.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..bench import CCL, N_READS, TIME_COST
from ..device import as_device, device_name, require_cuda


def one_size(total_mb: float, device=None, n_reads: int = N_READS) -> dict:
    """The ``strategy_update_p50_latency_scaled`` record of one genome size
    (two contigs of half the size each; reads of 3000 bases anywhere in the
    padded genome, 5% random symbols)."""
    from ..io.coo_native import pad_split, split_runs
    from ..models.convert import batch_from_numpy
    from ..models.layout import build_layout
    from ..models.runs import RunsEngine

    dev = require_cuda() if device is None else as_device(device)
    rng = np.random.default_rng(13)
    total = int(total_mb * 1e6)
    contigs = {"cA": rng.integers(0, 4, total // 2).astype(np.uint8),
               "cB": rng.integers(0, 4, total - total // 2).astype(np.uint8)}
    layout = build_layout(contigs)
    eng = RunsEngine(layout, device=dev)
    state = eng.init_state()
    if dev.type == "cuda":  # (before the first allocation it raises "Invalid device argument")
        torch.cuda.reset_peak_memory_stats(dev)

    rl = 3000
    rstart = rng.integers(0, layout.G_pad - rl, n_reads).astype(np.int64)
    pos = (rstart[:, None] + np.arange(rl)[None, :]).ravel()
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(sym.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    padded = pad_split(split_runs(layout, sym, np.full(sym.shape[0], 40, np.int8), rstart,
                                  np.full(n_reads, rl, np.int32), np.zeros(n_reads, np.int32)))
    batch = batch_from_numpy(dict(rs_row=rng.integers(0, layout.n_fhat, n_reads).astype(np.int32),
                                  rs_strand=rng.integers(0, 2, n_reads).astype(np.int32),
                                  rs_w=np.ones(n_reads, np.float32), **padded), dev)
    params = eng.make_params(CCL, TIME_COST)
    state, aux = eng.step(state, batch, params)
    eng.pull_aux(aux)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, aux = eng.step(state, batch, params)
        eng.pull_aux(aux)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    return {
        "metric": "strategy_update_p50_latency_scaled",
        "value": round(float(np.median(times)) * 1000.0, 1),
        "unit": "ms",
        "vs_baseline": None,
        "detail": {"genome_sites": total, "reads_per_batch": n_reads,
                   "peak_device_gib": None if peak is None else round(peak, 3),
                   "device": device_name(dev)},
    }


def main(sizes_mb, device=None) -> list[dict]:
    out = []
    for mb in sizes_mb:
        try:
            out.append(one_size(mb, device))
        except torch.cuda.OutOfMemoryError as e:
            out.append({"metric": "scale_probe_failed", "value": mb, "unit": "Mb",
                        "vs_baseline": None, "detail": {"error": repr(e)[:200]}})
            print(json.dumps(out[-1]), flush=True)
            break
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main([float(a) for a in sys.argv[1:]] or [8, 33, 67, 134])
