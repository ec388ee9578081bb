"""Decision parity on the card: update steps of the engine against the
port's f64 NumPy oracle, strategy masks compared bit for bit.

    python -m bossruns_torch.tools.check_decision_parity [n_batches] [score_dtype]

Drives ``n_batches`` steps (default 5) of the scoreboard's 8.05 Mb genome
and 4000-read batch and runs ``oracle.full_update`` on the same state and
batch, given the engine's own scores (the contract of ``chip_smoke.py``
phase 16: the decisions match bit for bit, so every count printed is 0).
Prints the strategy disagreements and both thresholds a batch, then the
total and the warm step p50.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..device import as_device, device_name, require_cuda


def main(n_batches: int = 5, score_dtype: str = "float32", device=None,
         genome: dict | None = None, n_reads: int | None = None) -> list[int]:
    """Disagreements a batch (printed, and returned)."""
    from .. import bench, oracle
    from ..models.convert import batch_from_numpy, state_to_numpy
    from ..models.runs import RunsConfig, RunsEngine

    dev = require_cuda() if device is None else as_device(device)
    layout, batch_np = bench.build_inputs(np.random.default_rng(11), genome or bench.GENOME,
                                          n_reads or bench.N_READS)
    eng = RunsEngine(layout, config=RunsConfig(dtype=score_dtype, debug_aux=True), device=dev)
    state = eng.init_state()
    batch = batch_from_numpy(batch_np, dev)
    params = eng.make_params(bench.CCL, bench.TIME_COST)
    st_np = state_to_numpy(state)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    dis, times = [], []
    for b in range(n_batches):
        t0 = time.perf_counter()
        state, aux = eng.step(state, batch, params)
        eng.pull_aux(aux)
        times.append(time.perf_counter() - t0)
        st_np, aux_np = oracle.full_update(eng, st_np, batch_np, bench.CCL, bench.TIME_COST,
                                           scores_override=aux.scores.cpu().numpy())
        strat = state.strat.cpu().numpy()
        dis.append(int((strat != st_np["strat"]).sum()))
        print(f"batch {b}: strat disagreements {dis[-1]} / {st_np['strat'].size}, "
              f"thr engine {float(aux.threshold):.17g} oracle {aux_np['threshold']:.17g}",
              flush=True)
    print(f"TOTAL disagreements over {n_batches} batches: {sum(dis)} (score_dtype="
          f"{score_dtype}, warm step p50 {1000 * float(np.median(times[1:] or times)):.1f} ms; "
          f"{device_name(dev)})", flush=True)
    return dis


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5,
         sys.argv[2] if len(sys.argv) > 2 else "float32")
