"""The seeding kernel H5 at the aligner's shapes, launch by launch.

    python -m bossruns_torch.tools.profile_seed

k13/w5 on an 8.05 Mb random genome, a 4096-read batch of 400-base
prefixes padded to L=512 (the mu=400 decision pass): H5's wrapper time
(CUDA events), its device time (queued calls) and the split of that time
by launch (torch.profiler), beside the plain version's time on the card.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import device_name, require_cuda
from ..utils.profiling import device_split, queued_ms, time_ms


def main() -> dict:
    from ..aligner import encode
    from ..aligner import seed as S
    from ..aligner.index import build_index
    from ..utils.datagen import random_genome

    dev = require_cuda()
    rng = np.random.default_rng(2)
    k, w = 13, 5
    genome = random_genome(rng, {"c1": 4_050_000, "c2": 2_000_000, "c3": 2_000_000})
    seq_int = np.concatenate([encode(s) for s in genome.values()])
    t0 = time.perf_counter()
    idx = build_index(seq_int, np.ones(seq_int.shape[0], bool), k=k, w=w)
    di = S.DeviceIndex(idx, dev)
    print(f"index: keys {idx.keys.shape[0]}, positions {idx.n_minimizers}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    L, R = 512, 4096
    mat = np.full((R, L), 4, np.int8)
    for r in range(R):
        st = rng.integers(0, seq_int.shape[0] - 500)
        mat[r, :400] = seq_int[st: st + 400]
    x = torch.from_numpy(mat).to(dev)
    budget = S.anchor_budget(L, w)
    print(f"budget {budget}", flush=True)

    kern = lambda: S.seed_topn(x, di, k, w, budget, L)  # noqa: E731
    out = dict(ms=time_ms(kern), device_ms=queued_ms(kern),
               plain_ms=time_ms(lambda: S.seed_topn_plain(x, di, k, w, budget, L), reps=3))
    ms = out["device_ms"]
    out["split"] = device_split(kern, band=(0.25 * ms, 1.1 * ms + 0.002))
    print(f"{'H5 seed_topn':32s} {out['ms']:8.4f} ms (device {out['device_ms']:.4f} ms)",
          flush=True)
    for name, v in (out["split"] or {}).items():
        if name != "dropped":
            print(f"  {name:30s} {v:8.4f} ms", flush=True)
    print(f"{'plain version':32s} {out['plain_ms']:8.3f} ms", flush=True)
    print(f"# {device_name(dev)}", flush=True)
    return out


if __name__ == "__main__":
    main()
