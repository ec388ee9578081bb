"""BOSS-AEONS orchestration on PyTorch: reference-free adaptive sampling.

The port of ``bossruns_tpu.aeons.core``: maintain a persistent pool of
reads/contigs with an all-vs-all overlap store; each batch ingests new
reads, propagates containment coverage, trims near-miss overlaps, extends
the assembly by walking unambiguous unitig paths, and regenerates
accept/reject strategies over the current contigs. The overlap search
(``ava``, kernel H6) and the strategies (``benefit``, kernel H7) run on the
experiment's device; the pool, the overlap store, the fastq batches, the
live sequencer, the read-length distribution and the metrics writer are the
port's copies of the JAX package's host classes. The checkpoint pickles
them under the JAX package's module paths and the loader maps those paths
to the copies, so a checkpoint resumes in either package and loading one
imports nothing of the JAX package.
"""
from __future__ import annotations

import logging
import pickle
import pkgutil
import shutil
import time
from pathlib import Path

import numpy as np

from ..device import as_device
from ..io.fastq import FastqBatch
from ..live.sequencer import LiveRun
from ..utils.checkpoint import MetricsWriter
from ..utils.misc import make_output_dirs, write_strategy_npz
from ..utils.readlen import ReadLengthDist
from .assembly import initial_assembly, walk_unitigs
from .ava import PoolIndex, find_overlaps, rows_to_records
from .benefit import contig_strategies
from .pool import LinkStore, SequencePool

logger = logging.getLogger("boss_torch")

#: modules of host classes that a checkpoint pickles; the port keeps copies
#: of the JAX package's at the same paths
_SHARED_MODULES = ("aeons.pool", "aeons.classify", "aeons.kmer", "io.paf", "io.fastq",
                   "utils.readlen")


def _shared(module: str, package: str) -> str | None:
    """The path of ``module`` inside the package beside ``package``, if it
    is one of the shared host modules."""
    prefix = package + "."
    if module.startswith(prefix) and module[len(prefix):] in _SHARED_MODULES:
        return module[len(prefix):]
    return None


class _PackagePickler(pickle.Pickler):
    """Pickles the shared host classes as ``pkgutil.resolve_name`` of their
    JAX-package path, so a plain ``pickle.load`` in the JAX package loads
    the port's checkpoints as its own."""

    def reducer_override(self, obj):
        if isinstance(obj, type):
            sub = _shared(obj.__module__, "bossruns_torch")
            if sub is not None:
                return pkgutil.resolve_name, (f"bossruns_tpu.{sub}:{obj.__qualname__}",)
        return NotImplemented


def _resolve_port(name: str):
    """``pkgutil.resolve_name`` with the JAX package's shared module paths
    mapped to the port's copies."""
    module, _, qual = name.partition(":")
    sub = _shared(module, "bossruns_tpu")
    return pkgutil.resolve_name(f"bossruns_torch.{sub}:{qual}" if sub else name)


class _PortUnpickler(pickle.Unpickler):
    """Loads a checkpoint of either package: the shared host classes resolve
    to the port's copies, so nothing of the JAX package is imported."""

    def find_class(self, module, name):
        if (module, name) == ("pkgutil", "resolve_name"):
            return _resolve_port
        sub = _shared(module, "bossruns_tpu")
        return super().find_class(f"bossruns_torch.{sub}" if sub else module, name)


class BossAeons:
    """Live reference-free experiment on ``device`` ("cuda" or "cpu")."""

    def __init__(self, args, out_base: str | Path = ".", *, device):
        self.device = as_device(device)
        self.args = args
        self.name = args.general.name
        self.out_dir = make_output_dirs(self.name, out_base)
        self.batch = 0
        self.processed_files: set[str] = set()
        self.rl_dist = ReadLengthDist()
        self.strat: dict[str, np.ndarray] = {}
        self.pool = SequencePool(min_len=args.optional.min_seq_len)
        self.store = LinkStore(
            min_map_len=args.optional.min_map_len,
            min_s1=args.optional.min_s1,
            min_seq_len=args.optional.min_seq_len,
            tetra=args.optional.tetra,
        )
        self.repeat_filter = None
        self.stage_times: dict[str, float] = {}
        self.metrics = MetricsWriter(self.out_dir)
        self.checkpoint_every = 10

    def _pool_index(self, seqs: dict[str, str]) -> PoolIndex:
        return PoolIndex(seqs, device=self.device)

    # --------------------------------------------------------- live init ----

    def launch_live_components(self) -> None:
        from ..live.sequencer import Sequencer

        if self.args.live.device:
            LiveRun.launch_readfish(
                toml=self.args.general.toml_readfish,
                device=self.args.live.device,
                name=self.name,
            )
        if not self.args.live.device or self.args.live.device == "TEST":
            sequencer = Sequencer()
        else:
            sequencer = LiveRun.connect_sequencer(
                device=self.args.live.device, host=self.args.live.host, port=self.args.live.port
            )
            sequencer.grab_channels(run_name=self.name)
        self.fq_dir = f"{sequencer.out_path}/fastq_pass"
        self.channels = sequencer.channels

    def first_live_asm(self) -> None:
        """Wait for data_wait Mb, then assemble until >= 1 contig exists."""
        while True:
            new_fastq = LiveRun.scan_dir(self.fq_dir, set())
            fq = FastqBatch(new_fastq, channels=self.channels)
            if fq.total_bases / 1e6 < self.args.live.data_wait:
                logger.info(f"waiting for {self.args.live.data_wait} Mb of data")
                time.sleep(30)
                continue
            contigs = initial_assembly(
                fq.read_sequences, min_seq_len=self.args.optional.min_seq_len,
                device=self.device,
            )
            if not contigs.has_min_one_contig(self.args.optional.min_contig_len):
                logger.info("initial assembly yielded no contigs, waiting")
                time.sleep(30)
                continue
            self.pool = contigs
            if self.args.optional.filter_repeats:
                from .repeats import RepeatFilter

                self.repeat_filter = RepeatFilter(fq.read_sequences, device=self.device)
            self.processed_files.update(new_fastq)
            logger.info("initial assembly complete")
            return

    # ------------------------------------------------------------ update ----

    def add_new_sequences(self, new_pool: SequencePool, increment: bool = True) -> None:
        """Overlap new sequences against themselves + the pool, load the
        classified records, propagate containments."""
        if new_pool.is_empty():
            return
        target = dict(self.pool.seqdict(), **new_pool.seqdict())
        self.pool.ingest(new_pool)
        if len(target) < 2:
            return
        pidx = self._pool_index(target)
        rec = rows_to_records(find_overlaps(new_pool.seqdict(), pidx, merge=True))
        containments, overlappers = self.store.load_records(rec, self.pool)
        if increment:
            contained = self.pool.increment(containments)
        else:
            contained = {s for (s, _t) in containments}
        self.remove_seqs(contained)
        self.pool.reset_temperature(overlappers, t=self.args.optional.temperature)

    def overlap_pool(self) -> None:
        """AVA among current contigs."""
        contigs = self.pool.declare_contigs(self.args.optional.min_contig_len)
        if len(contigs.sequences) < 2:
            return
        pidx = self._pool_index(contigs.seqdict())
        rec = rows_to_records(find_overlaps(contigs.seqdict(), pidx, merge=True))
        containments, overlappers = self.store.load_records(rec, self.pool)
        contained = self.pool.increment(containments)
        if contained:
            self.remove_seqs(contained)
        self.pool.reset_temperature(overlappers)

    def trim_sequences(self) -> None:
        """Trim class-6 overhangs and re-overlap the products."""
        trim_dict = self.store.to_be_trimmed()
        if not trim_dict:
            return
        trimmed = self.pool.trim_sequences(trim_dict)
        if len(trimmed) >= 2:
            pidx = self._pool_index(self.pool.seqdict())
            rec = rows_to_records(find_overlaps(trimmed, pidx, merge=True))
            containments, _ = self.store.load_records(rec, self.pool)
            self.pool.increment(containments)
        to_remove = self.store.trim_success(trim_dict)
        self.remove_seqs(to_remove)

    def remove_seqs(self, sids: set[str]) -> None:
        if not sids:
            return
        self.store.remove_links(sids)
        self.pool.remove_sequences(sids)

    def assemble(self) -> SequencePool:
        """Walk unitigs, replace members with merged sequences, return
        current contigs."""
        unitigs, used = walk_unitigs(
            self.pool, self.store, min_seq_len=self.args.optional.min_seq_len
        )
        if used:
            self.remove_seqs(used)
            self.add_new_sequences(unitigs, increment=False)
        return self.pool.declare_contigs(self.args.optional.min_contig_len)

    def write_contigs(self, contigs: SequencePool) -> None:
        """Atomic contig fasta for the readfish index reload."""
        tmp = Path(self.out_dir) / "contigs" / "aeons_tmp.fa"
        with open(tmp, "w") as fh:
            for sid, seqo in contigs.sequences.items():
                fh.write(f">{sid}\n{seqo.seq}\n")
        final = Path(self.out_dir) / "contigs" / "aeons.fa"
        tmp.rename(final)
        if self.batch % 10 == 0:
            shutil.copy(final, Path(self.out_dir) / "contigs" / "prev" / f"aeons_{self.batch}.fa")

    def update_wrapper(self, new_reads: dict[str, str]) -> None:
        """Per-batch AEONS pipeline. Per-stage wall times land in
        ``self.stage_times`` and in the metrics JSONL."""
        t0 = time.perf_counter()
        st = self.stage_times = {}

        def mark(stage: str) -> None:
            nonlocal t0
            t1 = time.perf_counter()
            st[stage] = round(t1 - t0, 4)
            t0 = t1

        if self.repeat_filter is not None:
            new_reads = self.repeat_filter.filter_batch(new_reads)
        mark("repeat_filter")
        new_pool = SequencePool(min_len=self.args.optional.min_seq_len)
        new_pool.ingest(new_reads)
        self.add_new_sequences(new_pool)
        mark("ingest_ava")
        self.overlap_pool()
        mark("pool_ava")
        self.trim_sequences()
        mark("trim")
        contigs = self.assemble()
        frozen = self.pool.decrease_temperature(lim=self.args.optional.min_contig_len)
        self.remove_seqs(frozen)
        mark("assemble")
        if contigs.is_empty():
            logger.info("no contigs yet; strategy stays accept-all")
            return
        self.strat, threshold = contig_strategies(
            contigs.sequences,
            ccl=self.rl_dist.approx_ccl,
            lam=self.rl_dist.lam,
            lowcov=self.args.optional.lowcov,
            device=self.device,
        )
        mark("strategy")
        write_strategy_npz(self.out_dir, self.strat)
        self.write_contigs(contigs)
        mark("write")
        logger.info(
            f"batch {self.batch}: {len(contigs.sequences)} contigs "
            f"({contigs.total_bases()} bases), threshold {threshold:.3g}"
        )
        lens = sorted((len(s.seq) for s in contigs.sequences.values()), reverse=True)
        self.metrics.write(
            batch=self.batch,
            n_contigs=len(contigs.sequences),
            contig_bases=contigs.total_bases(),
            longest=lens[:5],
            pool_size=len(self.pool.sequences),
            threshold=threshold,
            stages=self.stage_times,
        )

    def _checkpoint_extra(self) -> dict:
        """Subclass hook: extra host state to persist (sim pseudotime etc.)."""
        return {}

    def save_checkpoint(self) -> None:
        """Persist the host pool + overlap store + strategy atomically (the
        AEONS state is host-resident), in the JAX package's format."""
        ckpt = Path(self.out_dir) / "checkpoint"
        ckpt.mkdir(parents=True, exist_ok=True)
        tmp = ckpt / "pool_tmp.pkl"
        data = {
            "pool": self.pool, "strat": self.strat, "batch": self.batch,
            "rl_hist": self.rl_dist.hist,
            "store": self.store,
            "processed_files": self.processed_files,
            **self._checkpoint_extra(),
        }
        if self.repeat_filter is not None:
            data["repeat_lib"] = (
                self.repeat_filter.repeats,
                self.repeat_filter.lim,
                self.repeat_filter.min_votes,
            )
        with open(tmp, "wb") as fh:
            _PackagePickler(fh).dump(data)
        tmp.rename(ckpt / "pool.pkl")

    def load_checkpoint(self) -> dict | None:
        """Restore the pool/store/strategy; returns the raw checkpoint dict
        (for subclass extras) or None if absent."""
        path = Path(self.out_dir) / "checkpoint" / "pool.pkl"
        if not path.exists():
            return None
        with open(path, "rb") as fh:
            data = _PortUnpickler(fh).load()
        self.pool = data["pool"]
        self.strat = data["strat"]
        self.batch = data["batch"]
        self.rl_dist.hist = data["rl_hist"]
        self.rl_dist.update([])
        self.store = data.get("store", self.store)
        self.processed_files = data.get("processed_files", self.processed_files)
        if "repeat_lib" in data:
            from .repeats import RepeatFilter

            reps, lim, mv = data["repeat_lib"]
            self.repeat_filter = RepeatFilter.from_library(reps, lim, mv, device=self.device)
        logger.info(f"restored AEONS checkpoint at batch {self.batch}")
        return data

    # ------------------------------------------------------------- live -----

    def process_batch(self) -> int:
        tic = time.time()
        new_fastq = LiveRun.scan_dir(self.fq_dir, self.processed_files)
        if not new_fastq:
            return self.args.general.wait
        self.processed_files.update(new_fastq)
        fq = FastqBatch(new_fastq, channels=self.channels)
        if not fq.read_sequences:
            return self.args.general.wait
        self.rl_dist.update(np.fromiter(fq.read_lengths.values(), dtype=np.int64))
        self.update_wrapper(fq.read_sequences)
        self.batch += 1
        # save AFTER the increment: the persisted counter must equal the number
        # of consumed batches so a resume does not re-process the last one
        if self.checkpoint_every and self.batch % self.checkpoint_every == 0:
            self.save_checkpoint()
        return int(self.args.general.wait - (time.time() - tic))

    def run(self) -> None:
        self.launch_live_components()
        resumed = False
        if getattr(self.args.optional, "resume", False):
            resumed = self.load_checkpoint() is not None
        if not resumed:
            self.first_live_asm()
        while True:
            wait = self.process_batch()
            if wait > 0:
                time.sleep(wait)
