"""Dry run of the sharded update step:

    python -m bossruns_torch.parallel dryrun [N] [--device cuda|cpu] [--out DIR]

The twin of the JAX package's ``__graft_entry__.dryrun_multichip``: the
full sharded step over an N-shard mesh (barcode axis split in two when N is
even and at least 4) on the demo genome of ``mesh.demo_sharded_step``,
checked for switched-on buckets and a non-trivial mask, and the same
summary line. One process holds all N shards on one device (the card by
default), unless BOSS_COORDINATOR / BOSS_NUM_PROCESSES / BOSS_PROCESS_ID are
set: then each of N processes is one rank of a ``torch.distributed`` group
and holds one shard (NCCL on a card, one per rank; gloo on the CPU).
``--out`` writes the strategies to DIR/strat.npz (the primary process).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..device import as_device
from . import distributed
from .mesh import demo_sharded_step, make_mesh, process_group_mesh


def dryrun_multichip(n_devices: int, device, out: str | None = None) -> None:
    barcode_shards = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if distributed.init_from_env(device):
        if distributed.process_count() != n_devices:
            raise ValueError(f"dryrun {n_devices} needs {n_devices} processes, "
                             f"{distributed.process_count()} joined")
        mesh = process_group_mesh(barcode_shards, n_devices // barcode_shards, device)
    else:
        mesh = make_mesh([device] * n_devices, barcode_shards=barcode_shards)
    eng, state, aux = demo_sharded_step(mesh=mesh)
    ah = eng.pull_aux(aux)
    cov = sum(int(c.to(torch.int64).sum()) for c in state.coverage)
    if distributed.is_initialized():
        t = torch.tensor([cov], dtype=torch.int64, device=device)
        torch.distributed.all_reduce(t)
        cov = int(t.item())
    if cov <= 0:
        raise AssertionError("no coverage in the dry run")
    # the demo batch carries enough coverage that the LAST step flips bucket
    # switches and runs the real threshold scan
    if not ah.any_on:
        raise AssertionError("bucket switches never flipped in the dry run")
    strat = eng.strat_dict(state)
    total = sum(int(m.size) for m in strat.values())
    n_on = sum(int(m.sum()) for m in strat.values())
    frac_on = n_on / max(total, 1)
    if not 0.0 < frac_on < 1.0:
        raise AssertionError(f"trivial mask (frac_on={frac_on})")
    if out is not None and distributed.is_primary():
        Path(out).mkdir(parents=True, exist_ok=True)
        np.savez(Path(out) / "strat.npz", **strat)
    print(
        f"dryrun_multichip OK: mesh {eng.mesh.shape}, "
        f"G_pad={eng.layout.G_pad}, any_on={ah.any_on}, "
        f"accepted_frac={frac_on:.3f}, rejected_frac={1.0 - frac_on:.3f}",
        flush=True,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bossruns_torch.parallel")
    parser.add_argument("command", choices=["dryrun"])
    parser.add_argument("n", nargs="?", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="torch device: cuda (default, needs a card) or cpu")
    parser.add_argument("--out", default=None, help="directory for strat.npz")
    ns = parser.parse_args(argv)
    dev = as_device(distributed.rank_device(ns.device))
    dryrun_multichip(ns.n, dev, ns.out)
    if distributed.is_initialized():
        distributed.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
