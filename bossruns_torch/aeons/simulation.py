"""BOSS-AEONS simulation on PyTorch: sampled batches + decisions against
live contigs.

The port of ``bossruns_tpu.aeons.simulation``: binit initial batches feed a
first assembly; each batch then maps its reads' first mu bases against the
*current* contigs with a freshly indexed aligner (the port's
``make_aligner`` on the sim's device, seeding kernel H5 on CUDA), looks
decisions up in the current strategy (fail-open: no strategy or unknown
contig => accept), truncates rejected reads, advances pseudotime, and runs
the shared AEONS update pipeline (overlaps through H6, strategies through
H7).
"""
from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np

from ..aligner import make_aligner
from ..io.paf import best_per_query
from ..io.sampler import Sampler
from ..models.layout import build_layout
from ..models.runs_sim import MU, ReadCache
from ..utils import spans
from .assembly import initial_assembly
from .core import BossAeons

logger = logging.getLogger("boss_torch")


class BossAeonsSim(BossAeons):
    """Simulation experiment on ``device`` ("cuda" or "cpu")."""

    def __init__(self, args, out_base: str | Path = ".", *, device):
        super().__init__(args, out_base=out_base, device=device)
        sim = args.simulation
        assert sim.fq is not None
        self.sampler = Sampler(sim.fq, batchsize=sim.batchsize, maxbatch=sim.maxb + sim.binit)
        self.read_cache = ReadCache(sim.batchsize, sim.dumptime, out_base=out_base)
        self.maxb = sim.maxb
        data = None
        if getattr(args.optional, "resume", False):
            data = self.load_checkpoint()
        if data is None:
            self._initial_asm()
        else:
            # crash-resume: restore pseudotime and skip consumed batches so
            # the sampler continues from where the killed run stopped
            self.read_cache.time_boss = int(data.get("time_boss", 0))
            self.read_cache.time_control = int(data.get("time_control", 0))
            self.sampler.fq_stream.offsets = self.sampler.fq_stream.offsets[self.batch:]

    def _checkpoint_extra(self) -> dict:
        return {
            "time_boss": self.read_cache.time_boss,
            "time_control": self.read_cache.time_control,
        }

    def _initial_asm(self) -> None:
        init_reads: dict[str, str] = {}
        for _ in range(self.args.simulation.binit):
            seqs, *_ = self.sampler.sample()
            init_reads.update(seqs)
        logger.info(f"initial pool: {sum(map(len, init_reads.values()))} bases")
        self._update_times(init_reads, init_reads)
        if self.args.optional.filter_repeats:
            from .repeats import RepeatFilter

            self.repeat_filter = RepeatFilter(init_reads, device=self.device)
        contigs = initial_assembly(init_reads, min_seq_len=self.args.optional.min_seq_len,
                                   device=self.device)
        self.pool = contigs
        if not self.pool.has_min_one_contig(self.args.optional.min_contig_len):
            raise ValueError(
                "No contigs of sufficient length; restart simulation with more data (binit)"
            )
        self.batch = self.args.simulation.binit

    # ------------------------------------------------------------ decide ----

    def make_decisions(self, read_sequences: dict[str, str], mu: int = MU) -> dict[str, str]:
        """Map mu-prefixes to current contigs, apply the strategy. Unmapped
        or unknown => accept."""
        contigs = self.pool.declare_contigs(self.args.optional.min_contig_len)
        self.reject_count = self.accept_count = self.unmapped_count = 0
        if contigs.is_empty() or not self.strat:
            self.unmapped_count = len(read_sequences)
            return dict(read_sequences)
        # rebuild the decision index only when the contig set changed: pool
        # sequences are immutable (trims/unitig merges mint new ids), so
        # (name, length) identifies the set
        key = tuple(sorted((n, len(s)) for n, s in contigs.seqdict().items()))
        if key != getattr(self, "_decide_key", None):
            layout = build_layout(contigs.seqdict(), min_len=500)
            # noisy-vs-noisy mapping needs denser seeds: the reference's
            # AEONS sim mapper uses k=13, w=5
            self._decide_aligner = make_aligner(layout, device=self.device, k=13, w=5,
                                                min_votes=2)
            self._decide_key = key
        aligner = self._decide_aligner
        rec = aligner.map_sequences(read_sequences, trunc=True)
        best = best_per_query(rec)
        decisions = dict(read_sequences)
        for rid, i in best.items():
            rev = int(rec.rev[i])
            start = int(rec.tend[i]) - 1 if rev else int(rec.tstart[i])
            try:
                accept = bool(self.strat[rec.tname[i]][start // 100, rev])
            except (KeyError, IndexError):
                accept = True
            if accept:
                self.accept_count += 1
            else:
                decisions[rid] = read_sequences[rid][:mu]
                self.reject_count += 1
        self.unmapped_count = len(read_sequences) - len(best)
        logger.info(
            f"decisions - rejecting: {self.reject_count} "
            f"accepting: {self.accept_count} unmapped: {self.unmapped_count}"
        )
        return decisions

    def _update_times(self, read_sequences, reads_decision) -> None:
        """Pseudotime for AEONS (the reference's batch.py)."""
        total = sum(len(s) for s in read_sequences.values())
        decided_lengths = np.array([len(s) for s in reads_decision.values()])
        n_reject = int((decided_lengths == self.read_cache.mu).sum())
        acquisition = self.read_cache.batchsize * self.read_cache.alpha
        self.read_cache.time_control += total + acquisition
        self.read_cache.time_boss += (int(decided_lengths.sum()) + acquisition
                                      + n_reject * self.read_cache.rho)

    # ------------------------------------------------------------- batch ----

    def process_batch(self) -> None:
        """One batch: ``aeons.batch``, the parent of ``aeons.draw`` (the
        sampler), ``aeons.decide`` (the decisions, their pseudotime and the
        read-length distribution), the read cache's fill under
        ``aeons.write``, the update's stage spans (``BossAeons``) and, every
        tenth batch, ``aeons.checkpoint``."""
        with spans.span("aeons.batch"):
            t0 = time.perf_counter()
            with spans.span("aeons.draw"):
                seqs, *_ = self.sampler.sample()
            t1 = time.perf_counter()
            with spans.span("aeons.decide"):
                decisions = self.make_decisions(seqs)
                t2 = time.perf_counter()
                self.rl_dist.update(np.array([len(s) for s in seqs.values()]))
                self._update_times(seqs, decisions)
            with spans.span("aeons.write"):
                self.read_cache.fill(seqs, decisions)
            self.update_wrapper(new_reads=decisions)
            # prepend the sim-only stages to the update stages (update_wrapper)
            self.stage_times = {
                "sample": round(t1 - t0, 4),
                "decide": round(t2 - t1, 4),
                **self.stage_times,
            }
            self.batch += 1
            # after the increment: persisted counter == consumed batches (resume
            # slices the sampler offsets by it)
            if self.checkpoint_every and self.batch % self.checkpoint_every == 0:
                self.save_checkpoint()

    def run(self, maxb: int | None = None) -> None:
        # self.batch counts binit initial batches too; on resume, run only
        # the remainder up to binit + maxb total batches
        end = self.args.simulation.binit + (maxb or self.maxb)
        while self.batch < end:
            self.process_batch()
        self.read_cache.flush()
