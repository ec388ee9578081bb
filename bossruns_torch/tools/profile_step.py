"""Where the headline step's time goes on the card, launch by launch.

    python -m bossruns_torch.tools.profile_step

On the scoreboard's 8.05 Mb genome and 4000-read batch: the step's
host-clock p50 (step + aux pull), its device time (calls queued on the
card, ``utils.profiling.queued_ms``) and that time split by launch
(``utils.profiling.device_split``, torch.profiler), for the f64 decision
path and the f32 one; then the aux pull alone (one device-to-host copy).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import device_name, require_cuda
from ..utils.profiling import device_split, queued_ms


def main() -> dict:
    from .. import bench
    from ..models.convert import batch_from_numpy
    from ..models.runs import RunsConfig, RunsEngine

    dev = require_cuda()
    layout, batch_np = bench.build_inputs(np.random.default_rng(11))
    batch = batch_from_numpy(batch_np, dev)
    out = {}
    for name, cfg in (("f64 decisions", RunsConfig()),
                      ("f32 decisions", RunsConfig(benefit_dtype="float32"))):
        eng = RunsEngine(layout, config=cfg, device=dev)
        params = eng.make_params(bench.CCL, bench.TIME_COST)
        state = eng.init_state()
        p50, state = bench._step_p50_ms(eng, state, batch, params, 7)
        step = lambda: eng.step(state, batch, params)  # noqa: E731 - updates state in place
        ms = queued_ms(step)
        split = device_split(step, band=(0.25 * ms, 1.1 * ms + 0.002))
        out[name] = dict(p50_ms=p50, device_ms=ms, split=split)
        print(f"{'full step (' + name + ')':34s} {p50:8.3f} ms host p50, {ms:8.4f} ms device",
              flush=True)
        for k, v in (split or {}).items():
            if k != "dropped":
                print(f"  {k:32s} {v:8.4f} ms", flush=True)
        if split and split.get("dropped"):
            print(f"  (partial, dropped: {', '.join(split['dropped'])})", flush=True)
    aux = eng.step(state, batch, params)[1]
    torch.cuda.synchronize()
    ts = []
    for _ in range(7):
        t0 = time.perf_counter()
        eng.pull_aux(aux)
        ts.append(time.perf_counter() - t0)
    out["aux_pull_ms"] = float(np.median(ts)) * 1000.0
    print(f"{'aux pull (4 scalars)':34s} {out['aux_pull_ms']:8.3f} ms", flush=True)
    print(f"# {device_name(dev)}", flush=True)
    return out


if __name__ == "__main__":
    main()
