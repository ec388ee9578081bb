"""Aligner reads/s: TorchAligner on the card against the host-seeded
baseline, both passes.

    python -m bossruns_torch.tools.bench_aligner [n_reads]   # default 2000

Builds the scoreboard's genome (8.05 Mb, 3 contigs), simulates noisy reads
(3% substitutions, 2% insertions, 2% deletions) and times the two passes
the live-alignment simulation makes a batch: full-length mapping and the
mu=400 truncated-prefix mapping (the decision path), with the k13/w5
profile the sim uses. ``vs_baseline`` on each line = reads/s over the
baseline's, where the baseline (``aligner.cpu_baseline.CpuAligner``) is
the stand-in for mappy: host seeding over the SAME minimizer index and the
SAME native banded DP, 4 worker threads like the reference's mapper pool.
Both emit byte-identical records, so the ratio isolates where the seeding
runs. One JSON line a record.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..device import as_device, device_name, require_cuda


def _time_pair(base, subj, seqs, kw, trials):
    """Median seconds of (baseline, subject), the trials interleaved so that
    host load falls on both sides of the ratio alike."""
    base.map_sequences(seqs, **kw)  # warm
    rec = subj.map_sequences(seqs, **kw)
    tb, ts = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        base.map_sequences(seqs, **kw)
        tb.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        rec = subj.map_sequences(seqs, **kw)
        ts.append(time.perf_counter() - t0)
    return float(np.median(tb)), float(np.median(ts)), rec


def main(n_reads: int = 2000, trials: int = 3, device=None,
         lengths: tuple = (4_050_000, 2_000_000, 2_000_000)) -> list[dict]:
    """The three aligner records (printed, and returned)."""
    from ..aligner import TorchAligner, make_aligner
    from ..aligner.cpu_baseline import CpuAligner
    from ..models.layout import build_layout
    from ..utils.datagen import simulate_reads

    dev = require_cuda() if device is None else as_device(device)
    rng = np.random.default_rng(5)
    contigs_i = {f"c{i}": rng.integers(0, 4, L).astype(np.uint8) for i, L in enumerate(lengths)}
    bases = np.array(list("ACGT"))
    genome = {n: "".join(bases[v]) for n, v in contigs_i.items()}
    lay = build_layout(contigs_i)
    sim = simulate_reads(rng, genome, n_reads, mean_len=3500.0, sd_len=2000.0)
    seqs = {r.rid: r.seq for r in sim}
    truth = {r.rid: (r.tname, r.tstart, r.rev) for r in sim}

    cpu = CpuAligner(lay, k=13, w=5, min_votes=3, threads=4)
    dev_al = TorchAligner(lay, k=13, w=5, min_votes=3, device=dev)
    # what the port's call sites run: make_aligner's "auto" backend
    prod = make_aligner(lay, k=13, w=5, min_votes=3, device=dev)
    out = []
    cpu_sec, prod_sec, prec = _time_pair(cpu, prod, seqs, dict(trunc=True), trials)
    out.append({
        "metric": "aligner_production_trunc_reads_per_s",
        "value": round(n_reads / prod_sec, 1),
        "unit": "reads/s",
        "vs_baseline": round(cpu_sec / prod_sec, 2),
        "detail": {"seconds": round(prod_sec, 2),
                   "backend": type(prod).__name__,
                   "cpu_baseline_reads_per_s": round(n_reads / cpu_sec, 1),
                   "records": len(prec.qname),
                   "device": device_name(dev)},
    })
    print(json.dumps(out[-1]), flush=True)
    for label, kw in (("trunc", dict(trunc=True)), ("full", dict())):
        cpu_sec, dev_sec, rec = _time_pair(cpu, dev_al, seqs, kw, trials)
        correct = sum(1 for i in range(len(rec.qname))
                      if rec.tname[i] == truth[rec.qname[i]][0])
        out.append({
            "metric": f"aligner_{label}_reads_per_s",
            "value": round(n_reads / dev_sec, 1),
            "unit": "reads/s",
            "vs_baseline": round(cpu_sec / dev_sec, 2),
            "detail": {"seconds": round(dev_sec, 2),
                       "cpu_baseline_reads_per_s": round(n_reads / cpu_sec, 1),
                       "cpu_baseline_threads": 4,
                       "mapped_frac": round(len(set(rec.qname)) / n_reads, 4),
                       "right_contig": correct,
                       "records": len(rec.qname),
                       "production_backend": f"{type(prod).__name__} (make_aligner auto)",
                       "device": device_name(dev)},
        })
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2000)
