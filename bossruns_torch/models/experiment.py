"""Live-experiment pieces of the port.

Only ``AbundanceTracker`` for now (bossruns_tpu/models/experiment.py:33-50),
because the JAX module imports its engine, and so JAX, at its top. The live
``BossRuns`` experiment is a later slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import logging

from bossruns_tpu.io.paf import PafRecords

logger = logging.getLogger("boss_torch")


class AbundanceTracker:
    """Per-contig observed-read counts/proportions, logged each batch
    (runs/abundance_tracker.py)."""

    def __init__(self, names: list[str]):
        self.total_reads = 0
        self.read_counts = dict.fromkeys(names, 0)

    def update(self, n: int, rec: PafRecords, best_rows: dict[str, int]) -> None:
        self.total_reads += n
        for i in best_rows.values():
            t = rec.tname[i]
            if t in self.read_counts:
                self.read_counts[t] += 1
        if self.total_reads:
            logger.info("Counts and rel. proportions of observed reads:")
            for t, c in self.read_counts.items():
                logger.info(f"{t}: {c} {round(c / self.total_reads, 3)}")
