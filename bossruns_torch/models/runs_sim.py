"""BOSS-RUNS simulation mode on PyTorch: sampled batches + in-silico ReadUntil.

The port of ``bossruns_tpu.models.runs_sim``. Reads and their precomputed
full/truncated mappings are sampled from big files, each read's mu-sized
mapping is looked up in the current strategy mask (accept -> full read and
alignment, reject -> truncated to mu bases), pseudo-sequencing time
advances for a BOSS and a control half of the flowcell, and cumulative read
dumps are written at dump intervals. The update step runs in the port's
RunsEngine on an explicit device.

Without precomputed PAFs (``paf_full``/``paf_trunc`` None) the reads are
aligned live by the port's aligner (``aligner.make_aligner`` on the sim's
device: seeding kernel H5 on CUDA) in two phases per batch: the mu-sized
prefix pass decides, and only accepted reads get a full-length pass.

With ``mesh_shards=(b, g)`` other than (1, 1) the update step runs in
``parallel.mesh.ShardedRunsEngine`` (the classic flow only; ``gated=True``
raises), on an in-process mesh or, after ``parallel.distributed.
init_from_env``, one shard per process.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..aligner import make_aligner
from ..device import as_device
from ..io import coo as coo_mod
from ..io.coo import _pad_len
from ..io.coo_native import EX_PAD, coverage_rows, pack_batch
from ..io.fastq import read_fastx
from ..io.paf import PafRecords, best_per_query, parse_paf
from ..io.sampler import Sampler
from ..ops.model import make_model
from ..parallel.distributed import is_primary
from ..utils import spans
from ..utils.checkpoint import MetricsWriter, load_checkpoint, pull_state, save_checkpoint
from ..utils.misc import make_output_dirs, random_id, write_strategy_npz
from ..utils.readlen import ReadLengthDist
from .convert import batch_from_numpy
from .experiment import AbundanceTracker
from .layout import DS, FHAT_WINDOW, GenomeLayout, build_layout
from .runs import RunsConfig, RunsEngine

logger = logging.getLogger("boss_torch")

MU = 400
ALPHA = 300
RHO = 300


#: bases of read dumps gathered before a write
DUMP_CHUNK = 1 << 22


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
            path = self.out / f"{cond}_{n}.fa"
            # every read's 20-character id from one draw (the characters a
            # draw per read gives, in order); the records written about
            # DUMP_CHUNK bases at a time, not one write per read
            ids = random_id(20 * len(cache))
            with open(path, "w") as fh:
                parts, size = [], 0
                for i, (rid, seq) in enumerate(cache.items()):
                    parts.append(f">{rid}.{ids[20 * i:20 * i + 20]}\n{seq}\n")
                    size += len(seq)
                    if size >= DUMP_CHUNK:
                        fh.write("".join(parts))
                        parts, size = [], 0
                fh.write("".join(parts))
            spans.count_files(path)
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
    accepted: list = field(default_factory=list)     # ids of the accepted reads


def decision_tally(seqs: dict[str, str], decisions: dict[str, bool], best_full: dict,
                   best_trunc: dict, full: PafRecords, mu: int,
                   accept_unmapped: bool) -> SimOutcome:
    """A batch's accept/reject bookkeeping (runs/simulation.py:88-120), for
    both flows: the mapped reads in ``decisions`` order, then the unmapped
    ones in ``seqs`` order, each accepted as ``decisions`` or
    ``accept_unmapped`` says. An accepted read adds its best full record's
    row and length where it has one; a rejected mapped read its best
    truncated row; a rejected read its ``mu``-base prefix as its decided
    sequence."""
    out = SimOutcome(reads_decision=dict(seqs), n_mapped=len(decisions),
                     n_unmapped=len(seqs) - len(decisions))
    unmapped = ((rid, accept_unmapped) for rid in seqs if rid not in decisions)
    for rid, acc in (*decisions.items(), *unmapped):
        if acc:
            out.accepted.append(rid)
            j = best_full.get(rid)
            if j is not None:
                out.cov_rows.append(("full", j))
                out.acc_rows.append(j)
                out.accepted_lengths.append(int(full.qlen[j]))
        else:
            if rid in decisions:
                out.cov_rows.append(("trunc", best_trunc[rid]))
            out.reads_decision[rid] = seqs[rid][:mu]
            out.n_rejected += 1
    out.n_accepted = len(out.accepted)
    return out


def load_reference_contigs(fasta: str | Path) -> dict[str, str]:
    return {name: seq for name, _c, seq, _q in read_fastx(fasta)}


#: a batch's phases, each the wall time (s) from the end of the one before
#: (``metrics/batches.jsonl``): sample (the wait for the prefetched batch,
#: or its host work inline), align (live alignment; 0 over precomputed PAFs),
#: decide, coo (the classic flow: read-length update, read-start rows and the
#: batch's coverage rows; the gated flow, whose rows were built in the
#: prefetch: the read-length and abundance bookkeeping), overlap (queueing
#: the step, pseudotime, the read cache, the next prefetch), device (the wait
#: for the step's scalars) and write (the strategy's publication)
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
        LAST mu bases, as the reference does).

        gated: the gated batch flow (default: on with precomputed PAFs, off
        when aligning live or sharded; the gated flow needs both PAF record
        sets before the decision and cannot take live alignments).

        mesh_shards: (barcode_shards, genome_shards); other than (1, 1) the
        update step runs in ``parallel.mesh.ShardedRunsEngine``: one shard
        per rank when ``parallel.distributed.init_from_env`` joined a process
        group, else all shards in this process on ``device``. Checkpoints
        are written from the gathered state, by the primary rank."""
        live_align = not (paf_full and paf_trunc)
        bshards, gshards = (int(x) for x in mesh_shards)
        sharded = (bshards, gshards) != (1, 1)
        if gated and live_align:
            raise ValueError("gated=True needs precomputed PAFs (paf_full and paf_trunc)")
        if gated and sharded:
            raise ValueError("gated=True: the sharded step runs the classic flow only")
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
            align_chunks=gshards,
        )
        cfg = config or RunsConfig(reference_quirks=reference_quirks)
        if sharded:
            from ..parallel import mesh as mesh_mod
            from ..parallel.distributed import is_initialized

            if is_initialized():
                mesh = mesh_mod.process_group_mesh(bshards, gshards, self.device)
            else:
                mesh = mesh_mod.make_mesh([self.device] * (bshards * gshards), bshards)
            self.engine = mesh_mod.ShardedRunsEngine(self.layout, mesh, make_model(ploidy=ploidy),
                                                     cfg)
        else:
            self.engine = RunsEngine(self.layout, make_model(ploidy=ploidy), cfg,
                                     device=self.device)
        self.state = self.engine.init_state()
        self.rl_dist = ReadLengthDist()
        self.sampler = Sampler(
            fq, paf_full, paf_trunc, batchsize=batchsize, maxbatch=maxb, seed=seed
        )
        # without precomputed PAFs, align live. Noisy 400-base prefixes drive
        # the decisions: the dense k13/w5 profile (the reference's own
        # sim-mapper non-defaults) keeps short, noisy reads mappable.
        self.aligner = None
        if live_align:
            self.aligner = make_aligner(self.layout, device=self.device, k=13, w=5,
                                        min_votes=3, source=ref)
        self.read_cache = ReadCache(batchsize, dumptime, out_base=out_base)
        self.tracker = AbundanceTracker(self.layout.names)
        self.batch = 0
        self.metrics = MetricsWriter(self.out_dir)
        self.checkpoint_every = 10
        if resume:
            restored = load_checkpoint(self.out_dir, self.device, numpy=True)
            if restored is not None:
                fields, host, extra = restored
                self.state = self.engine.state_from_numpy(fields)
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
        self._gated = (not live_align and not sharded) if gated is None else bool(gated)

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
        decisions = self._trunc_decisions(trunc, barcodes)
        out = decision_tally(seqs, decisions, best_per_query(full), best_per_query(trunc), full,
                             self.mu, self.accept_unmapped)
        return full, trunc, out

    # ------------------------------------------------------ gated batch ------

    def _prefetch_gated(self) -> dict:
        """Sample + parse + build + upload both candidate coverage sets.

        All of it is strategy-independent, so it runs on the prefetch worker
        while the previous batch's step runs. The sets ship as one gated
        wire buffer (RunsEngine.pack_gated), packed into a pinned staging
        buffer and uploaded by one async copy into the tier's static device
        wire, on the worker's current (default) stream, the stream the step
        also runs on: queued after the step before it, which reads the
        same buffer when the tier repeats."""
        with spans.span("sim.draw"):
            seqs, quals, bc_names, paf_f, paf_t = self.sampler.sample()
        with spans.span("sim.paf"):
            full = parse_paf(paf_f)
            trunc = parse_paf(paf_t)
        with spans.span("sim.coo"):
            rid_list = list(seqs)
            rid_idx = {r: i for i, r in enumerate(rid_list)}
            read_bc = {rid: self.barcodes_index.get(bc, 0) for rid, bc in bc_names.items()}
            best_full = best_per_query(full)
            best_trunc = best_per_query(trunc)
            len_b = self.engine.model.len_b

            def one_set(rec, rows, sset, qset):
                return coverage_rows(self.layout, [(rec, rows, sset, qset)], read_bc,
                                     read_rows=rid_idx, len_b=len_b)

            f_rows = list(best_full.values())
            f_split = one_set(full, f_rows, seqs, quals)
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
            lay = self.layout
            tid_of = {n: i for i, n in enumerate(lay.names)}
            rows = np.array(f_rows, np.int64)
            tid = np.array([tid_of.get(t, -1) for t in full.tname[rows].tolist()], np.int64)
            read = np.array([rid_idx[r] for r in best_full], np.int64)
            known = tid >= 0
            rows, tid, read = rows[known], tid[known], read[known]
            wf = lay.lengths[tid] // FHAT_WINDOW
            rev = full.rev[rows].astype(np.int64)
            start = np.where(rev != 0, full.tend[rows], full.tstart[rows]).astype(np.int64)
            keep = (wf > 0) & (start <= FHAT_WINDOW * wf)
            rs_row = lay.fhat_offsets[tid] + np.minimum(start // FHAT_WINDOW, wf - 1)
            rs_row, rs_strand, rs_read = rs_row[keep], rev[keep], read[keep]

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
                "rs_row": pad_arr(rs_row.astype(np.int32), "rs"),
                "rs_strand": pad_arr(rs_strand.astype(np.int32), "rs"),
                "rs_read": pad_arr(rs_read.astype(np.int32), "rs", fill=-1),
            }
            self._gated_floors = floors
        wire, spec = self.engine.pack_gated(d, out=self.engine.stage)
        return dict(
            seqs=seqs, quals=quals, bc_names=bc_names, full=full, trunc=trunc,
            best_full=best_full, best_trunc=best_trunc, rid_list=rid_list,
            rid_idx=rid_idx, read_bc=read_bc, wire=self.engine.upload_wire(wire, spec), spec=spec,
        )

    @staticmethod
    def _prefetch(fn):
        """One batch's strategy-independent host work, ``fn()``."""
        with spans.span("sim.prefetch"):
            return fn()

    def _submit_prefetch(self, fn) -> None:
        if self._prefetch_pool is None:
            self._prefetch_pool = ThreadPoolExecutor(max_workers=1)
        # the worker's spans name the batch that submitted it as their parent
        self._prefetched = self._prefetch_pool.submit(spans.carry(self._prefetch), fn)

    def _take_prefetched(self, fn):
        pre = self._prefetched
        self._prefetched = None
        return pre.result() if pre is not None else self._prefetch(fn)

    def _process_batch_gated(self) -> None:
        t = {"start": time.perf_counter()}
        pre = self._take_prefetched(self._prefetch_gated)
        t["sample"] = time.perf_counter()
        t["align"] = t["sample"]  # the PAFs hold the alignments: always 0
        seqs = pre["seqs"]
        decisions = self._trunc_decisions(pre["trunc"], pre["read_bc"])
        outc = decision_tally(seqs, decisions, pre["best_full"], pre["best_trunc"], pre["full"],
                              self.mu, self.accept_unmapped)
        bits = np.zeros(self.batchsize, np.uint8)
        for rid in outc.accepted:
            bits[pre["rid_idx"][rid]] = 1
        self._last_decisions = outc.reads_decision
        t["decide"] = time.perf_counter()
        logger.info(f"mapped {outc.n_mapped}, unmapped {outc.n_unmapped}")
        logger.info(f"accepted {outc.n_accepted}, rejected {outc.n_rejected}")
        # the coverage rows came with the prefetch: the "coo" phase here is
        # the read-length and abundance bookkeeping
        self.rl_dist.update(np.array(outc.accepted_lengths, dtype=np.int64))
        self.tracker.update(
            outc.n_accepted, pre["full"], {pre["full"].qname[i]: i for i in outc.acc_rows}
        )
        t["coo"] = time.perf_counter()
        params = self.engine.make_params(self.rl_dist.approx_ccl, self.rl_dist.time_cost)
        bits_dev = torch.from_numpy(bits).to(self.device)
        gated = self.engine.unpack_gated(pre["wire"], pre["spec"])
        self.state, aux = self.engine.step_gated(self.state, gated, bits_dev, params)
        decided_bases = sum(len(s) for s in outc.reads_decision.values())
        self.read_cache.update_times(
            total_bases=self.sampler.fq_stream.total_bases,
            decided_bases=decided_bases,
            n_reject=outc.n_rejected,
        )
        self.read_cache.fill(
            seqs, outc.reads_decision,
            pre["bc_names"] if len(self.barcodes_index) > 1 else None,
        )
        if self.sampler.fq_stream.offsets.shape[0] > 0:
            self._submit_prefetch(self._prefetch_gated)
        t["overlap"] = time.perf_counter()
        self._finish_batch(aux, t, outc.n_mapped, outc.n_accepted, outc.n_rejected)

    # ------------------------------------------------------------ batch ------

    def _sample_parsed(self):
        """One sampled batch + parsed PAF records (strategy-independent);
        no records when aligning live."""
        with spans.span("sim.draw"):
            seqs, quals, bc_names, paf_f, paf_t = self.sampler.sample()
        if self.aligner is not None:
            return seqs, quals, bc_names, None, None
        with spans.span("sim.paf"):
            return seqs, quals, bc_names, parse_paf(paf_f), parse_paf(paf_t)

    def process_batch(self) -> None:
        with spans.span("sim.batch"):
            if self._gated:
                return self._process_batch_gated()
            return self._process_batch_classic()

    def _process_batch_classic(self) -> None:
        t = {"start": time.perf_counter()}
        seqs, quals, bc_names, full_rec, trunc_rec = self._take_prefetched(self._sample_parsed)
        t["sample"] = time.perf_counter()
        read_bc = {rid: self.barcodes_index.get(bc, 0) for rid, bc in bc_names.items()}
        if self.aligner is not None:
            # two-phase live alignment: the mu-sized prefix mapping alone
            # decides (what the sequencer knows at decision time), so the
            # full-length extension runs only for reads that are accepted —
            # rejected reads contribute only their truncated alignment
            with spans.span("sim.align"):
                trunc_rec = self.aligner.map_sequences(seqs, trunc=True)
                decisions = self._trunc_decisions(trunc_rec, read_bc)
                need_full = [rid for rid, acc in decisions.items() if acc]
                if self.accept_unmapped:
                    need_full += [rid for rid in seqs if rid not in decisions]
                full_rec = self.aligner.map_sequences({r: seqs[r] for r in need_full})
        t["align"] = time.perf_counter()
        with spans.span("sim.decide"):
            full, trunc, outc = self.make_decisions(seqs, full_rec, trunc_rec, read_bc)
        self._last_decisions = outc.reads_decision
        t["decide"] = time.perf_counter()
        logger.info(f"mapped {outc.n_mapped}, unmapped {outc.n_unmapped}")
        logger.info(f"accepted {outc.n_accepted}, rejected {outc.n_rejected}")
        with spans.span("sim.coo"):
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
                device=None,
                barcodes=read_bc,
                rs=(rs_row, rs_strand, rs_w),
                floors=getattr(self, "_batch_floors", (0, 0)),
                len_b=self.engine.model.len_b,
            )
            self._batch_floors = (batch["mr_g"].shape[0], batch["ex_g"].shape[0])
        t["coo"] = time.perf_counter()
        params = self.engine.make_params(self.rl_dist.approx_ccl, self.rl_dist.time_cost)
        # the step is queued on the device; the host overlaps it with the
        # pseudotime bookkeeping and the next batch's sample + parse
        # a wire-capable engine takes the host batch as one buffer, as the
        # JAX package's does; the sharded engine places a ReadBatch itself
        if self.engine.wire_capable:
            self.state, aux = self.engine.step_from_numpy(self.state, batch, params)
        else:
            self.state, aux = self.engine.step(self.state, batch_from_numpy(batch, self.device),
                                               params)
        decided_bases = sum(len(s) for s in outc.reads_decision.values())
        self.read_cache.update_times(
            total_bases=self.sampler.fq_stream.total_bases,
            decided_bases=decided_bases,
            n_reject=outc.n_rejected,
        )
        self.read_cache.fill(
            seqs, outc.reads_decision, bc_names if len(self.barcodes_index) > 1 else None
        )
        # the next batch's sample + parse on the prefetch worker; only with
        # precomputed PAFs, as in bossruns_tpu's sim
        if self.aligner is None and self.sampler.fq_stream.offsets.shape[0] > 0:
            self._submit_prefetch(self._sample_parsed)
        t["overlap"] = time.perf_counter()
        self._finish_batch(aux, t, outc.n_mapped, outc.n_accepted, outc.n_rejected)

    def _finish_batch(self, aux, t: dict, n_mapped: int, n_accepted: int,
                      n_rejected: int) -> None:
        """Wait for the step (one copy of its scalars), publish the strategy,
        log phases and metrics, checkpoint. The strategy's copy to the host
        starts before the wait, behind the step on the stream, so
        ``strat_dict`` finds it landed (the JAX sims' copy_to_host_async)."""
        self.engine.strat_to_host_async(self.state)
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
                self.out_dir, pull_state(self.state, self.engine.state_numpy),
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
