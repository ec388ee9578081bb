"""BOSS-RUNS simulation mode on PyTorch: sampled batches + in-silico ReadUntil.

The port of ``bossruns_tpu.models.runs_sim``. Reads and their precomputed
full/truncated mappings are sampled from big files, each read's mu-sized
mapping is looked up in the current strategy mask (accept -> full read and
alignment, reject -> truncated to mu bases), pseudo-sequencing time
advances for a BOSS and a control half of the flowcell, and cumulative read
dumps are written at dump intervals. The update step runs in the port's
RunsEngine on an explicit device.

``ReadCache``, ``SimOutcome`` and ``load_reference_contigs`` are ported
here because the JAX module imports its engine, and so JAX, at its top.
The live aligner (``paf_full``/``paf_trunc`` None) and mesh sharding are
later slices and raise NotImplementedError.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bossruns_tpu.io import coo as coo_mod
from bossruns_tpu.io.coo import _pad_len
from bossruns_tpu.io.fastq import read_fastx
from bossruns_tpu.io.sampler import Sampler
from bossruns_tpu.ops.model import make_model
from bossruns_tpu.parallel.distributed import is_primary
from bossruns_tpu.utils.checkpoint import MetricsWriter
from bossruns_tpu.utils.readlen import ReadLengthDist

from ..device import as_device
from ..io.coo_native import EX_PAD, build_packed_runs, pack_batch, split_runs_rows
from ..io.paf import PafRecords, best_per_query, parse_paf
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.misc import make_output_dirs, random_id, write_strategy_npz
from .convert import tensors_from_numpy
from .experiment import AbundanceTracker
from .layout import DS, FHAT_WINDOW, GenomeLayout, build_layout
from .runs import RunsConfig, RunsEngine

logger = logging.getLogger("boss_torch")

MU = 400
ALPHA = 300
RHO = 300


class ReadCache:
    """Pseudotime bookkeeping + cumulative read dumps (batch.py:123-281)."""

    def __init__(self, batchsize: int, dumptime: int, out_base: str | Path = ".",
                 alpha: int = ALPHA, rho: int = RHO, mu: int = MU):
        self.alpha, self.rho, self.mu = alpha, rho, mu
        self.batchsize = batchsize
        self.dumptime = dumptime
        self.time_boss = 0
        self.time_control = 0
        self.cache_control: dict[str, str] = {}
        self.cache_boss: dict[str, str] = {}
        self.dump_n_control = 1
        self.dump_n_boss = 1
        self.out = Path(out_base) / "00_reads"
        self.out.mkdir(parents=True, exist_ok=True)
        for cond in ("control", "boss"):
            (self.out / f"{cond}_0.fa").write_text("")

    def update_times(self, total_bases: int, decided_bases: int, n_reject: int) -> None:
        self.time_control += total_bases + self.batchsize * self.alpha
        self.time_boss += decided_bases + n_reject * self.rho + self.batchsize * self.alpha
        logger.info(f"time control: {self.time_control}")
        logger.info(f"time boss: {self.time_boss}")

    def fill(self, read_sequences: dict[str, str], reads_decision: dict[str, str],
             barcodes: dict[str, int] | None = None) -> None:
        def key(rid):
            if barcodes is None:
                return rid
            return f"{rid}.barcode=barcode{str(barcodes[rid]).zfill(2)}"

        for rid, seq in read_sequences.items():
            self.cache_control[key(rid)] = seq
        for rid, seq in reads_decision.items():
            self.cache_boss[key(rid)] = seq
        for cond in ("control", "boss"):
            if getattr(self, f"time_{cond}") > self.dumptime * getattr(self, f"dump_n_{cond}"):
                self.dump(cond)

    def dump(self, cond: str) -> None:
        n = getattr(self, f"dump_n_{cond}")
        cache = getattr(self, f"cache_{cond}")
        logger.info(f"dump {cond} #{n}: {len(cache)} reads")
        if is_primary():
            with open(self.out / f"{cond}_{n}.fa", "w") as fh:
                for rid, seq in cache.items():
                    fh.write(f">{rid}.{random_id()}\n{seq}\n")
        setattr(self, f"dump_n_{cond}", n + 1)
        setattr(self, f"cache_{cond}", {})

    def flush(self) -> None:
        for cond in ("control", "boss"):
            if getattr(self, f"cache_{cond}"):
                self.dump(cond)


@dataclass
class SimOutcome:
    n_mapped: int = 0
    n_unmapped: int = 0
    n_accepted: int = 0
    n_rejected: int = 0
    reads_decision: dict = field(default_factory=dict)
    cov_rows: list = field(default_factory=list)     # (records, row) for coverage
    acc_rows: list = field(default_factory=list)     # rows of accepted full recs
    accepted_lengths: list = field(default_factory=list)


def load_reference_contigs(fasta: str | Path) -> dict[str, str]:
    return {name: seq for name, _c, seq, _q in read_fastx(fasta)}


PHASES = ("sample", "align", "decide", "coo", "overlap", "device", "write")


class BossRunsSim:
    """Simulation experiment on ``device`` ("cuda" or "cpu")."""

    def __init__(
        self,
        ref: str,
        fq: str,
        paf_full: str | None = None,
        paf_trunc: str | None = None,
        name: str = "boss",
        batchsize: int = 4000,
        maxb: int = 400,
        dumptime: int = 200_000_000,
        barcodes: list[str] | None = None,
        reject_refs: str | None = None,
        ploidy: int = 1,
        accept_unmapped: bool = False,
        out_base: str | Path = ".",
        seed: int = 1,
        config: RunsConfig | None = None,
        min_contig_len: int = 100_000,
        resume: bool = False,
        mesh_shards: tuple[int, int] = (1, 1),
        reference_quirks: bool = False,
        gated: bool | None = None,
        *,
        device,
    ):
        """reference_quirks: bug-compatible mode (docs/PARITY.md) — quirk Q1
        on the engine (ubar0 from benefit) and Q2 on the data plane
        (rejected reverse-strand reads contribute coverage from the read's
        LAST mu bases, as the reference does)."""
        if tuple(mesh_shards) != (1, 1):
            raise NotImplementedError(
                "mesh_shards: the multi-GPU engine is ROADMAP Queue 1 item 11")
        if not (paf_full and paf_trunc):
            raise NotImplementedError(
                "live alignment (no precomputed PAFs) is ROADMAP Queue 1 item 9")
        self.device = as_device(device)
        self.name = name
        self.out_dir = make_output_dirs(name, out_base)
        self.mu = MU
        self.accept_unmapped = accept_unmapped
        self.batchsize = batchsize
        self.maxb = maxb
        if not barcodes:
            self.barcodes_index = {"": 0}
        else:
            self.barcodes_index = {int(b.split("barcode")[1]): i for i, b in enumerate(barcodes)}
        nb = len(self.barcodes_index)

        self.reference_quirks = reference_quirks
        contigs = load_reference_contigs(ref)
        rejects = set(reject_refs.split(",")) if reject_refs else set()
        self.layout: GenomeLayout = build_layout(
            contigs, n_barcodes=nb, reject_refs=rejects, min_len=min_contig_len,
        )
        cfg = config or RunsConfig(reference_quirks=reference_quirks)
        self.engine = RunsEngine(self.layout, make_model(ploidy=ploidy), cfg, device=self.device)
        self.state = self.engine.init_state()
        self.rl_dist = ReadLengthDist()
        self.sampler = Sampler(
            fq, paf_full, paf_trunc, batchsize=batchsize, maxbatch=maxb, seed=seed
        )
        self.read_cache = ReadCache(batchsize, dumptime, out_base=out_base)
        self.tracker = AbundanceTracker(self.layout.names)
        self.batch = 0
        self.metrics = MetricsWriter(self.out_dir)
        self.checkpoint_every = 10
        if resume:
            restored = load_checkpoint(self.out_dir, self.device)
            if restored is not None:
                self.state, host, extra = restored
                self.batch = int(host.get("batch", 0))
                self.read_cache.time_boss = int(host.get("time_boss", 0))
                self.read_cache.time_control = int(host.get("time_control", 0))
                self.rl_dist.hist = extra.get("rl_hist", self.rl_dist.hist)
                self.rl_dist.update([])  # refresh lambda / ccl from histogram
                self.sampler.fq_stream.offsets = self.sampler.fq_stream.offsets[self.batch:]
                logger.info(f"resumed at batch {self.batch}")
        self.strat_host = self.engine.strat_dict(self.state)
        write_strategy_npz(self.out_dir, self.strat_host)
        self._phase_log: list[dict] = []
        self._prefetch_pool: ThreadPoolExecutor | None = None
        self._prefetched = None
        # gated flow: both coverage sets upload during prefetch; only the
        # decision bits are uploaded on the critical path
        self._gated = True if gated is None else bool(gated)

    def phase_p50_ms(self, last: int = 5) -> dict[str, float]:
        """Median per-phase wall time (ms) over the last N batches."""
        log = self._phase_log[-last:]
        if not log:
            return {}
        return {
            k: round(1000.0 * float(np.median([d.get(k, 0.0) for d in log])), 1)
            for k in log[-1]
        }

    # ------------------------------------------------------------ decisions --

    def _trunc_decisions(self, trunc: PafRecords, barcodes: dict[str, int]) -> dict[str, bool]:
        """Per-read accept/reject from the mu-sized truncated mapping alone
        (runs/simulation.py:68-86)."""
        best_trunc = best_per_query(trunc)
        decisions: dict[str, bool] = {}
        for rid, i in best_trunc.items():
            rev = int(trunc.rev[i])
            start_pos = int(trunc.tend[i]) - 1 if rev else int(trunc.tstart[i])
            bc = barcodes.get(rid, 0)
            try:
                strat = self.strat_host[trunc.tname[i]]
                decisions[rid] = bool(strat[start_pos // DS, rev, bc])
            except (KeyError, IndexError):
                decisions[rid] = False  # fail-closed like simulation.py:82-86
        return decisions

    def make_decisions(self, seqs: dict[str, str], full: PafRecords, trunc: PafRecords,
                       barcodes: dict[str, int]) -> tuple[PafRecords, PafRecords, SimOutcome]:
        """In-silico ReadUntil (runs/simulation.py:37-120): accepted reads
        contribute their full-length alignment, rejected reads their
        mu-sized truncated alignment."""
        best_full = best_per_query(full)
        best_trunc = best_per_query(trunc)
        decisions = self._trunc_decisions(trunc, barcodes)

        out = SimOutcome()
        out.reads_decision = dict(seqs)
        mapped = set(decisions)
        for rid, decision in decisions.items():
            if decision and rid in best_full:
                j = best_full[rid]
                out.cov_rows.append(("full", j))
                out.acc_rows.append(j)
                out.accepted_lengths.append(int(full.qlen[j]))
                out.n_accepted += 1
            elif decision:
                out.n_accepted += 1
            else:
                out.cov_rows.append(("trunc", best_trunc[rid]))
                out.reads_decision[rid] = seqs[rid][: self.mu]
                out.n_rejected += 1
        for rid, seq in seqs.items():
            if rid in mapped:
                continue
            if self.accept_unmapped:
                if rid in best_full:
                    j = best_full[rid]
                    out.cov_rows.append(("full", j))
                    out.acc_rows.append(j)
                    out.accepted_lengths.append(int(full.qlen[j]))
                out.n_accepted += 1
            else:
                out.reads_decision[rid] = seq[: self.mu]
                out.n_rejected += 1
        out.n_mapped = len(mapped)
        out.n_unmapped = len(seqs) - len(mapped)
        return full, trunc, out

    # ------------------------------------------------------ gated batch ------

    def _prefetch_gated(self) -> dict:
        """Sample + parse + build + upload both candidate coverage sets.

        All of it is strategy-independent, so it runs on the prefetch worker
        while the previous batch's step runs. The upload is a plain
        synchronous copy on the worker's current (default) stream, the
        stream the step also runs on."""
        seqs, quals, bc_names, paf_f, paf_t = self.sampler.sample()
        full = parse_paf(paf_f)
        trunc = parse_paf(paf_t)
        rid_list = list(seqs)
        rid_idx = {r: i for i, r in enumerate(rid_list)}
        read_bc = {rid: self.barcodes_index.get(bc, 0) for rid, bc in bc_names.items()}
        best_full = best_per_query(full)
        best_trunc = best_per_query(trunc)
        known = set(self.layout.names)
        len_b = self.engine.model.len_b

        def one_set(rec, rows, sset, qset):
            packed = build_packed_runs(self.layout, [(rec, rows, sset, qset)], read_bc)
            kept = [i for i in rows if rec.tname[i] in known]
            rrow = np.array([rid_idx[rec.qname[i]] for i in kept], np.int32)
            return split_runs_rows(
                self.layout, packed[0], packed[1], packed[2], packed[3],
                packed[4], rrow, 0, len_b,
            )

        f_split = one_set(full, list(best_full.values()), seqs, quals)
        t_rows = list(best_trunc.values())
        t_seqs = {r: s[: self.mu] for r, s in seqs.items()}
        t_quals = {r: quals[r][: len(t_seqs[r])] for r in seqs}
        if self.reference_quirks:
            # Q2: a reverse trunc record's coverage expands from the read's
            # LAST mu bases; active only when the read is rejected
            for i in t_rows:
                if trunc.rev[i]:
                    rid = trunc.qname[i]
                    t_seqs[rid] = seqs[rid][-self.mu:]
                    t_quals[rid] = quals[rid][-self.mu:]
        t_split = one_set(trunc, t_rows, t_seqs, t_quals)

        # read-start rows for every best full record (io/coo.
        # build_read_start_rows incl. right-edge inclusion); active on
        # device iff the read's bit is set
        tid_of = {n: i for i, n in enumerate(self.layout.names)}
        rs_row, rs_strand, rs_read = [], [], []
        for rid, i in best_full.items():
            tid = tid_of.get(full.tname[i])
            if tid is None:
                continue
            wf = int(self.layout.lengths[tid]) // FHAT_WINDOW
            if wf == 0:
                continue
            start = int(full.tend[i]) if full.rev[i] else int(full.tstart[i])
            if start > FHAT_WINDOW * wf:
                continue
            rs_row.append(int(self.layout.fhat_offsets[tid]) + min(start // FHAT_WINDOW, wf - 1))
            rs_strand.append(int(full.rev[i]))
            rs_read.append(rid_idx[rid])

        floors = getattr(self, "_gated_floors", {})

        def pad_arr(a, name, fill=0):
            m = max(_pad_len(a.shape[0]), floors.get(name, 0), 4)
            floors[name] = m
            out = np.full(m, fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        d = {
            "f_mr_bc": pad_arr(f_split[0], "f_mr"),
            "f_mr_g": pad_arr(f_split[1], "f_mr"),
            "f_mr_len": pad_arr(f_split[2], "f_mr"),
            "f_mr_read": pad_arr(f_split[3], "f_mr"),
            "f_ex_bcsym": pad_arr(f_split[4], "f_ex"),
            "f_ex_g": pad_arr(f_split[5], "f_ex", fill=EX_PAD),
            "f_ex_read": pad_arr(f_split[6], "f_ex"),
            "t_mr_bc": pad_arr(t_split[0], "t_mr"),
            "t_mr_g": pad_arr(t_split[1], "t_mr"),
            "t_mr_len": pad_arr(t_split[2], "t_mr"),
            "t_mr_read": pad_arr(t_split[3], "t_mr"),
            "t_ex_bcsym": pad_arr(t_split[4], "t_ex"),
            "t_ex_g": pad_arr(t_split[5], "t_ex", fill=EX_PAD),
            "t_ex_read": pad_arr(t_split[6], "t_ex"),
            "rs_row": pad_arr(np.array(rs_row, np.int32), "rs"),
            "rs_strand": pad_arr(np.array(rs_strand, np.int32), "rs"),
            "rs_read": pad_arr(np.array(rs_read, np.int32), "rs", fill=-1),
        }
        self._gated_floors = floors
        return dict(
            seqs=seqs, quals=quals, bc_names=bc_names, full=full, trunc=trunc,
            best_full=best_full, best_trunc=best_trunc, rid_list=rid_list,
            rid_idx=rid_idx, read_bc=read_bc, gated=tensors_from_numpy(d, self.device),
        )

    def _submit_prefetch(self, fn) -> None:
        if self._prefetch_pool is None:
            self._prefetch_pool = ThreadPoolExecutor(max_workers=1)
        self._prefetched = self._prefetch_pool.submit(fn)

    def _take_prefetched(self, fn):
        pre = self._prefetched
        self._prefetched = None
        return pre.result() if pre is not None else fn()

    def _process_batch_gated(self) -> None:
        t = {"start": time.perf_counter()}
        pre = self._take_prefetched(self._prefetch_gated)
        t["sample"] = time.perf_counter()
        t["align"] = t["sample"]
        seqs = pre["seqs"]
        decisions = self._trunc_decisions(pre["trunc"], pre["read_bc"])
        bits = np.zeros(self.batchsize, np.uint8)
        best_full = pre["best_full"]
        rid_idx = pre["rid_idx"]
        reads_decision = dict(seqs)
        accepted_lengths = []
        n_accepted = n_rejected = 0
        acc_rows = []
        for rid, acc in decisions.items():
            if acc:
                bits[rid_idx[rid]] = 1
                n_accepted += 1
                if rid in best_full:
                    j = best_full[rid]
                    acc_rows.append(j)
                    accepted_lengths.append(int(pre["full"].qlen[j]))
            else:
                reads_decision[rid] = seqs[rid][: self.mu]
                n_rejected += 1
        for rid in seqs:
            if rid in decisions:
                continue
            if self.accept_unmapped:
                bits[rid_idx[rid]] = 1
                n_accepted += 1
                if rid in best_full:
                    j = best_full[rid]
                    acc_rows.append(j)
                    accepted_lengths.append(int(pre["full"].qlen[j]))
            else:
                reads_decision[rid] = seqs[rid][: self.mu]
                n_rejected += 1
        self._last_decisions = reads_decision
        t["decide"] = time.perf_counter()
        n_mapped = len(decisions)
        logger.info(f"mapped {n_mapped}, unmapped {len(seqs) - n_mapped}")
        logger.info(f"accepted {n_accepted}, rejected {n_rejected}")
        self.rl_dist.update(np.array(accepted_lengths, dtype=np.int64))
        self.tracker.update(
            n_accepted, pre["full"], {pre["full"].qname[i]: i for i in acc_rows}
        )
        t["coo"] = time.perf_counter()
        params = self.engine.make_params(self.rl_dist.approx_ccl, self.rl_dist.time_cost)
        bits_dev = torch.from_numpy(bits).to(self.device)
        self.state, aux = self.engine.step_gated(self.state, pre["gated"], bits_dev, params)
        decided_bases = sum(len(s) for s in reads_decision.values())
        self.read_cache.update_times(
            total_bases=self.sampler.fq_stream.total_bases,
            decided_bases=decided_bases,
            n_reject=n_rejected,
        )
        self.read_cache.fill(
            seqs, reads_decision,
            pre["bc_names"] if len(self.barcodes_index) > 1 else None,
        )
        if self.sampler.fq_stream.offsets.shape[0] > 0:
            self._submit_prefetch(self._prefetch_gated)
        t["overlap"] = time.perf_counter()
        self._finish_batch(aux, t, n_mapped, n_accepted, n_rejected)

    # ------------------------------------------------------------ batch ------

    def _sample_parsed(self):
        """One sampled batch + parsed PAF records (strategy-independent)."""
        seqs, quals, bc_names, paf_f, paf_t = self.sampler.sample()
        return seqs, quals, bc_names, parse_paf(paf_f), parse_paf(paf_t)

    def process_batch(self) -> None:
        if self._gated:
            return self._process_batch_gated()
        return self._process_batch_classic()

    def _process_batch_classic(self) -> None:
        t = {"start": time.perf_counter()}
        seqs, quals, bc_names, full_rec, trunc_rec = self._take_prefetched(self._sample_parsed)
        t["sample"] = time.perf_counter()
        read_bc = {rid: self.barcodes_index.get(bc, 0) for rid, bc in bc_names.items()}
        t["align"] = time.perf_counter()
        full, trunc, outc = self.make_decisions(seqs, full_rec, trunc_rec, read_bc)
        self._last_decisions = outc.reads_decision
        t["decide"] = time.perf_counter()
        logger.info(f"mapped {outc.n_mapped}, unmapped {outc.n_unmapped}")
        logger.info(f"accepted {outc.n_accepted}, rejected {outc.n_rejected}")
        self.rl_dist.update(np.array(outc.accepted_lengths, dtype=np.int64))

        decided_quals = {
            rid: quals[rid][: len(seq)] for rid, seq in outc.reads_decision.items()
        }
        full_rows = [i for kind, i in outc.cov_rows if kind == "full"]
        trunc_rows = [i for kind, i in outc.cov_rows if kind == "trunc"]
        trunc_seqs, trunc_quals = outc.reads_decision, decided_quals
        if self.reference_quirks:
            # Q2: rejected reverse reads' coverage comes from the read's LAST
            # mu bases (the reference's wrong-bases expansion)
            trunc_seqs = dict(outc.reads_decision)
            trunc_quals = dict(decided_quals)
            for i in trunc_rows:
                if trunc.rev[i]:
                    rid = trunc.qname[i]
                    trunc_seqs[rid] = seqs[rid][-self.mu:]
                    trunc_quals[rid] = quals[rid][-self.mu:]
        rs_row, rs_strand, rs_w = coo_mod.build_read_start_rows(
            self.layout, full, outc.acc_rows, floor=getattr(self, "_rs_floor", 512)
        )
        self._rs_floor = max(getattr(self, "_rs_floor", 512), rs_row.shape[0])
        self.tracker.update(
            outc.n_accepted, full, {full.qname[i]: i for i in outc.acc_rows}
        )
        batch = pack_batch(
            self.layout,
            [(full, full_rows, seqs, quals), (trunc, trunc_rows, trunc_seqs, trunc_quals)],
            device=self.device,
            barcodes=read_bc,
            rs=(rs_row, rs_strand, rs_w),
            floors=getattr(self, "_batch_floors", (0, 0)),
            len_b=self.engine.model.len_b,
        )
        self._batch_floors = (batch.mr_g.shape[0], batch.ex_g.shape[0])
        t["coo"] = time.perf_counter()
        params = self.engine.make_params(self.rl_dist.approx_ccl, self.rl_dist.time_cost)
        # the step is queued on the device; the host overlaps it with the
        # pseudotime bookkeeping and the next batch's sample + parse
        self.state, aux = self.engine.step(self.state, batch, params)
        decided_bases = sum(len(s) for s in outc.reads_decision.values())
        self.read_cache.update_times(
            total_bases=self.sampler.fq_stream.total_bases,
            decided_bases=decided_bases,
            n_reject=outc.n_rejected,
        )
        self.read_cache.fill(
            seqs, outc.reads_decision, bc_names if len(self.barcodes_index) > 1 else None
        )
        if self.sampler.fq_stream.offsets.shape[0] > 0:
            self._submit_prefetch(self._sample_parsed)
        t["overlap"] = time.perf_counter()
        self._finish_batch(aux, t, outc.n_mapped, outc.n_accepted, outc.n_rejected)

    def _finish_batch(self, aux, t: dict, n_mapped: int, n_accepted: int,
                      n_rejected: int) -> None:
        """Wait for the step (one copy of its scalars), publish the strategy,
        log phases and metrics, checkpoint."""
        ah = self.engine.pull_aux(aux)
        t["device"] = time.perf_counter()
        if ah.updated:
            self.strat_host = self.engine.strat_dict(self.state)
            write_strategy_npz(self.out_dir, self.strat_host)
            logger.info(f"strategy updated, threshold {ah.threshold:.3g}")
        self.batch += 1
        t["write"] = time.perf_counter()
        phases = {
            k: round(t[k] - t[prev], 3) for k, prev in zip(PHASES, ("start",) + PHASES[:-1])
        }
        self._phase_log.append(phases)
        self.metrics.write(
            batch=self.batch, phases=phases, n_mapped=n_mapped,
            n_accepted=n_accepted, n_rejected=n_rejected,
            updated=ah.updated, threshold=ah.threshold,
            mean_coverage=ah.mean_coverage,
            time_boss=self.read_cache.time_boss,
            time_control=self.read_cache.time_control,
            lam=self.rl_dist.lam,
        )
        if self.checkpoint_every and self.batch % self.checkpoint_every == 0:
            save_checkpoint(
                self.out_dir, self.state,
                dict(batch=self.batch,
                     time_boss=self.read_cache.time_boss,
                     time_control=self.read_cache.time_control),
                extra_arrays={"rl_hist": self.rl_dist.hist},
            )

    def run(self, maxb: int | None = None) -> None:
        for _ in range(maxb or self.maxb):
            self.process_batch()
        self.cleanup()

    def cleanup(self) -> None:
        """Flush the read dumps and stop the prefetch worker."""
        self.read_cache.flush()
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=True)
            self._prefetch_pool = None
            self._prefetched = None
