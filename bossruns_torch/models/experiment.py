"""Live BOSS-RUNS experiment on PyTorch: fastq-directory ingestion + updates.

The port of ``bossruns_tpu.models.experiment``: scan the sequencer's
fastq_pass directory for new files, align the new reads, update the
GenomeState on the experiment's device, and republish the strategy npz for
the readfish process. Alignment is pluggable: any object with
``map_sequences({rid: seq}) -> PafRecords`` works; the default is the
port's aligner from ``aligner.make_aligner`` on the same device (seeding
kernel H5 on CUDA).
"""
from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np

from ..aligner import make_aligner
from ..device import as_device
from ..io import coo as coo_mod
from ..io.coo_native import pack_batch
from ..io.fastq import FastqBatch
from ..io.paf import PafRecords, best_per_query
from ..live.sequencer import LiveRun, Sequencer
from ..ops.model import make_model
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.misc import make_output_dirs, write_strategy_npz
from ..utils.readlen import ReadLengthDist
from .convert import batch_from_numpy
from .layout import build_layout
from .runs import RunsConfig, RunsEngine

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


class BossRuns:
    """Live reference-based experiment on ``device`` ("cuda" or "cpu")."""

    def __init__(self, args, mapper=None, out_base: str | Path = ".", *, device):
        from .runs_sim import load_reference_contigs  # runs_sim imports this module

        self.device = as_device(device)
        self.args = args
        self.name = args.general.name
        self.out_dir = make_output_dirs(self.name, out_base)
        self.processed_files: set[str] = set()
        self.batch = 0
        if not args.general.barcodes:
            self.barcodes_index = {"": 0}
        else:
            self.barcodes_index = {
                int(b.split("barcode")[1]): i for i, b in enumerate(args.general.barcodes)
            }
        contigs = load_reference_contigs(args.general.ref)
        rejects = set(args.optional.reject_refs.split(",")) if args.optional.reject_refs else set()
        self.layout = build_layout(
            contigs, n_barcodes=len(self.barcodes_index), reject_refs=rejects
        )
        self.engine = RunsEngine(
            self.layout,
            make_model(ploidy=args.optional.ploidy),
            RunsConfig(bucket_threshold=float(args.optional.bucket_threshold)),
            device=self.device,
        )
        self.state = self.engine.init_state()
        self.rl_dist = ReadLengthDist()
        self.tracker = AbundanceTracker(self.layout.names)
        if mapper is None:
            mapper = make_aligner(self.layout, device=self.device, source=args.general.ref)
        self.mapper = mapper
        # live checkpoint/resume: state, batch counter, rl histogram and the
        # processed-files set
        self.checkpoint_every = 10
        if getattr(args.optional, "resume", False):
            restored = load_checkpoint(self.out_dir, self.device, dtype=self.engine.dtype)
            if restored is not None:
                self.state, host, extra = restored
                self.batch = int(host.get("batch", 0))
                self.rl_dist.hist = extra.get("rl_hist", self.rl_dist.hist)
                self.rl_dist.update([])
                self.processed_files = set(
                    np.asarray(extra.get("processed", np.zeros(0, "U1"))).tolist()
                )
                logger.info(
                    f"resumed live run at batch {self.batch} "
                    f"({len(self.processed_files)} files already processed)"
                )
        write_strategy_npz(self.out_dir, self.engine.strat_dict(self.state))

    # ------------------------------------------------------------- live -----

    def launch_live_components(self) -> None:
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

    # ------------------------------------------------------------- batch ----

    def process_batch(self) -> int:
        tic = time.time()
        new_fastq = LiveRun.scan_dir(self.fq_dir, self.processed_files)
        if not new_fastq:
            logger.info("no new files, deferring update")
            return self.args.general.wait
        self.processed_files.update(new_fastq)
        fq = FastqBatch(new_fastq, channels=self.channels)
        if not fq.read_sequences:
            return self.args.general.wait
        self.rl_dist.update(np.fromiter(fq.read_lengths.values(), dtype=np.int64))
        self.process_reads(fq.read_sequences, fq.read_qualities, fq.read_barcodes)
        wait = int(self.args.general.wait - (time.time() - tic))
        self.batch += 1
        if self.checkpoint_every and self.batch % self.checkpoint_every == 0:
            save_checkpoint(
                self.out_dir,
                self.state,
                dict(batch=self.batch),
                extra_arrays={
                    "rl_hist": self.rl_dist.hist,
                    "processed": np.array(sorted(self.processed_files), dtype="U"),
                },
            )
        logger.info(f"batch took {time.time() - tic:.2f}s; waiting {wait}s")
        return wait

    def process_reads(self, seqs: dict[str, str], quals: dict[str, str],
                      barcodes: dict[str, int] | None = None) -> None:
        rec = self.mapper.map_sequences(seqs)
        best = best_per_query(rec)
        read_bc = {
            rid: self.barcodes_index.get(bc, 0) for rid, bc in (barcodes or {}).items()
        }
        rows = list(best.values())
        rs = coo_mod.build_read_start_rows(
            self.layout, rec, rows, floor=getattr(self, "_rs_floor", 512)
        )
        self._rs_floor = max(getattr(self, "_rs_floor", 512), rs[0].shape[0])
        batch = pack_batch(
            self.layout, [(rec, rows, seqs, quals)], device=None, barcodes=read_bc, rs=rs, floors=getattr(self, "_batch_floors", (0, 0)),
            len_b=self.engine.model.len_b,
        )
        self._batch_floors = (batch["mr_g"].shape[0], batch["ex_g"].shape[0])
        params = self.engine.make_params(self.rl_dist.approx_ccl, self.rl_dist.time_cost)
        # a wire-capable engine takes the host batch as one buffer, as the
        # JAX package's does; the sharded engine places a ReadBatch itself
        if self.engine.wire_capable:
            self.state, aux = self.engine.step_from_numpy(self.state, batch, params)
        else:
            self.state, aux = self.engine.step(self.state, batch_from_numpy(batch, self.device),
                                               params)
        ah = self.engine.pull_aux(aux)
        self.tracker.update(len(seqs), rec, best)
        if ah.updated:
            write_strategy_npz(self.out_dir, self.engine.strat_dict(self.state))
            logger.info(f"strategy updated, threshold {ah.threshold:.4g}")

    def run(self) -> None:
        self.launch_live_components()
        while True:
            wait = self.process_batch()
            if wait > 0:
                time.sleep(wait)
