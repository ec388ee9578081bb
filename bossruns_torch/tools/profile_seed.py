"""The seeding link and kernel H5 at the aligner's shapes, stage by stage.

    python -m bossruns_torch.tools.profile_seed

k13/w5 on an 8.05 Mb random genome, a 4096-read batch of 400-base
prefixes padded to L=512 (the mu=400 decision pass), timed stage by stage
as scripts/profile_seed.py times the JAX kernel's: the 4-bit pack into
pinned staging by the kernel library's host loop (beside NumPy's rows and
pack_reads; host clock, median of 10), the payload's upload from
staging (CUDA events around the non-blocking copy, beside the int8
matrix's pageable copy), then H5 on the packed payload: its wrapper time
(CUDA events), its device time (queued calls) and the split of that time
by launch (torch.profiler), beside the plain version's time on the card.
"""
from __future__ import annotations

import statistics
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
    budget = S.anchor_budget(L, w)
    print(f"budget {budget}", flush=True)

    rows = (mat.reshape(-1), np.arange(R) * L, np.full(R, L), L)

    def pack(compiled: bool):
        out = di.staging.take(R * L // 8).reshape(R, L // 8)
        return S.pack_rows(*rows, out, compiled=compiled)

    pack_ms = {True: [], False: []}
    for _ in range(12):
        for compiled in pack_ms:
            t0 = time.perf_counter()
            pack(compiled)
            pack_ms[compiled].append(1000 * (time.perf_counter() - t0))
    staged = pack(True)
    x = S.put_packed(staged, di)
    out = dict(pack_ms=statistics.median(pack_ms[True][2:]),
               numpy_pack_ms=statistics.median(pack_ms[False][2:]),
               upload_ms=time_ms(lambda: S.put_packed(staged, di)),
               pageable_int8_ms=time_ms(lambda: torch.from_numpy(mat).to(dev)))
    kern = lambda: S.seed_topn(x, di, k, w, budget, L)  # noqa: E731
    out.update(ms=time_ms(kern), device_ms=queued_ms(kern),
               plain_ms=time_ms(lambda: S.seed_topn_plain(x, di, k, w, budget, L), reps=3))
    ms = out["device_ms"]
    out["split"] = device_split(kern, band=(0.25 * ms, 1.1 * ms + 0.002))
    print(f"{'pack into staging (host)':32s} {out['pack_ms']:8.4f} ms ({staged.nbytes} B "
          f"from {mat.nbytes} B; NumPy, rows + pack_reads {out['numpy_pack_ms']:.4f} ms)",
          flush=True)
    print(f"{'upload from staging':32s} {out['upload_ms']:8.4f} ms (the int8 matrix's pageable "
          f"copy {out['pageable_int8_ms']:.4f} ms)", flush=True)
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
