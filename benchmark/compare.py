"""The comparison that decides ``correct``: what the program published and
left in its state, against the reference's, as numbers with limits.

* ``state_mismatch``: entries of the coverage counts, the sticky dropout
  zeros, the bucket switches and the read-start counts that differ. All
  are integer arithmetic in both, so the limit is 0.
* ``strat_mismatch_share``: the share of published strategy rows (row,
  strand, barcode) whose accept bit differs, the worst over the updates
  compared. Float32 scores against float64 move a benefit by about 1e-7
  of itself, so a row within that of the threshold may flip.
* ``threshold_rel_gap``: |program - reference| / reference of the accept
  threshold, the worst over the updates compared (the program reports it
  rounded to float32).
* ``decision_mismatch_share`` (simulation): reads whose accept/reject
  decision differs from the reference's lookup in its own strategy.
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def strat_rows_differ(prog: dict, ref: dict) -> tuple[int, int]:
    """(rows that differ, rows) over the reference's contigs; a contig the
    program did not publish, or published at another shape, differs whole."""
    bad = total = 0
    for name, r in ref.items():
        p = prog.get(name)
        total += r.size
        if p is None or p.shape != r.shape:
            bad += r.size
        else:
            bad += int(np.count_nonzero(p != r))
    return bad, total


def rel_gap(value: float, ref: float) -> float:
    if value == ref:
        return 0.0
    return abs(value - ref) / max(abs(ref), 1e-300)


def state_mismatch(prog: dict, ref: dict, n_buckets: int, n_fhat: int) -> int:
    """Entries that differ between the program's state (NumPy, as
    ``engine.state_numpy`` gives it) and the reference's (tensors), with
    each field's count on standard error."""
    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    pairs = {
        "coverage": (prog["coverage"].astype(np.int64), host(ref["coverage"]).astype(np.int64)),
        "zeroed": (prog["zeroed"], host(ref["zeroed"])),
        "bucket_on": (prog["bucket_on"][:, :n_buckets], host(ref["bucket_on"])),
        "read_starts": (prog["read_starts"][:n_fhat].astype(np.float64),
                        host(ref["read_starts"])),
    }
    by_field = {k: int(np.count_nonzero(p != r)) if p.shape == r.shape else r.size
                for k, (p, r) in pairs.items()}
    print(f"state entries that differ: {by_field}", file=sys.stderr)
    return sum(by_field.values())
