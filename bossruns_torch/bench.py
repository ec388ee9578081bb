"""The port's scoreboard: the hot paths of bossruns_torch on the card.

    python -m bossruns_torch.bench        # every section; needs a CUDA card

The sections, records and shapes of the JAX package's ``bench.py``, so a
record of one sits beside the other's (one JSON line each, in order):
  1. strategy_update_p50_latency, the headline: the BOSS-RUNS update step
     (``RunsEngine.step`` + the aux pull, host clock) on an 8.05 Mb genome
     (3 contigs) with a 4000-read batch, f64 decision path, and the f32
     decision path's p50 as ``f32_ms``; ``vs_baseline`` = the port's f64
     NumPy oracle (``oracle.full_update(..., fast_scores=True)``, the
     stand-in for CPU BOSS-RUNS) over the step p50. Printed first, and
     again last.
  2. aligner_production_trunc_reads_per_s, aligner_{trunc,full}_reads_per_s:
     ``TorchAligner`` against the 4-thread host-seeded ``CpuAligner``
     (``python -m bossruns_torch.tools.bench_aligner``).
  3. sim_batch_p50_latency: one ``BossRunsSim`` batch over precomputed PAFs.
  4. conformance_mask_agreement, conformance_dataplane: the engine in quirk
     mode against the bug-compatible oracle on the 12.6 Mb zymo-like
     corpus, with injected observations and through the sim's data plane.
  5. aeons_batch_p50_latency: one ``BossAeonsSim`` batch, and the contig
     strategy (H7) against the reference's f64 NumPy pipeline.
  6. strategy_update_p50_latency_scaled: the step on a 134 Mb genome
     (``python -m bossruns_torch.tools.bench_scale``).

The kernels are built once before anything is timed. The headline runs in
this process; every other section runs in a subprocess under a hard
timeout sized from the remaining budget (``BENCH_BUDGET_S`` seconds,
default 1250), and a ``bench_summary`` record follows each section. A
section that raises prints ``<name>_error``, one that overruns
``<name>_timeout``, one the budget cannot hold ``<name>_skipped``; then
the run exits nonzero. ``BENCH_ONLY=step`` runs only the headline. The
entry point runs on the card and never on the CPU; the section functions
take ``device`` (the tests pass "cpu") and their sizes, with the
scoreboard's values as defaults.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .device import as_device, device_name, require_cuda

N_READS = 4000
MEAN_LEN = 3500
GENOME = {"chr1": 4_050_000, "chr2": 2_000_000, "chr3": 2_000_000}
CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
TIME_COST = 5300.0

ROOT = Path(__file__).resolve().parents[1]
#: the sim and AEONS corpora, made from fixed seeds, kept for later runs
CACHE = ROOT / ".bench_torch_cache"
#: a record whose metric ends so says that its section did not complete
FAILED = ("_error", "_timeout", "_skipped")


def _device(device) -> torch.device:
    return require_cuda() if device is None else as_device(device)


def emit(obj: dict) -> dict:
    print(json.dumps(obj), flush=True)
    return obj


def build_inputs(rng, genome: dict = GENOME, n_reads: int = N_READS,
                 mean_len: float = MEAN_LEN):
    """(layout, batch_np): random contigs of ``genome``'s lengths and a batch
    of ``n_reads`` reads (normal lengths around ``mean_len``, sd 2000, in
    400-20000) with 5% random symbols, as match runs and explicit
    observations; the JAX bench's ``build_inputs`` draw for draw."""
    from .io.coo_native import pad_split, split_runs
    from .models.layout import build_layout

    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in genome.items()}
    layout = build_layout(contigs)
    lens = np.array(list(genome.values()))
    cid = rng.choice(len(lens), n_reads, p=lens / lens.sum())
    rlen = np.clip(rng.normal(mean_len, 2000, n_reads), 400, 20000).astype(np.int64)
    starts = (rng.random(n_reads) * (lens[cid] - rlen)).astype(np.int64)
    goff = np.array([layout.offsets[i] for i in range(len(lens))])
    rstart = (goff[cid] + starts).astype(np.int32)
    pos = np.concatenate([s0 + np.arange(n) for s0, n in zip(rstart, rlen)]).astype(np.int64)
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    qual = np.full(sym.shape[0], 40, np.int8)
    split = split_runs(layout, sym, qual, rstart.astype(np.int64), rlen.astype(np.int32),
                       np.zeros(n_reads, np.int32))
    batch_np = dict(
        pad_split(split),
        rs_row=rng.integers(0, layout.n_fhat, n_reads).astype(np.int32),
        rs_strand=rng.integers(0, 2, n_reads).astype(np.int32),
        rs_w=np.ones(n_reads, np.float32),
    )
    print(f"# match runs {split[0].shape[0]}, explicit {split[4].shape[0]}, "
          f"bases {pos.shape[0]}", flush=True)
    return layout, batch_np


def _step_p50_ms(eng, state, batch, params, n: int) -> tuple[float, object]:
    """Median host-clock ms of ``n`` steps, each ending in the aux pull
    (one device-to-host copy, which waits for the step), after two first
    steps (on the card the tier's eager warm-up and its capture, so only
    replays are timed); returns (p50, state)."""
    for _ in range(2):
        state, aux = eng.step(state, batch, params)
        eng.pull_aux(aux)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, aux = eng.step(state, batch, params)
        eng.pull_aux(aux)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1000.0, state


def section_headline(device=None, genome: dict = GENOME, n_reads: int = N_READS,
                     n_steps: int = 7, n_f32_steps: int = 5, n_oracle: int = 2) -> dict:
    """The strategy-update step on the card (f64 decisions, then f32) against
    the host's f64 oracle of the same step. The record is printed as soon
    as the f64 number exists; ``f32_ms`` fills in the record returned
    (which ``main`` prints last). The oracle's time moves between runs on
    a shared host: every sample is kept beside the min."""
    from . import oracle
    from .models.convert import batch_from_numpy
    from .models.runs import RunsConfig, RunsEngine

    dev = _device(device)
    layout, batch_np = build_inputs(np.random.default_rng(11), genome, n_reads)
    batch = batch_from_numpy(batch_np, dev)
    eng = RunsEngine(layout, device=dev)
    params = eng.make_params(CCL, TIME_COST)
    p50, _ = _step_p50_ms(eng, eng.init_state(), batch, params, n_steps)

    st_np = {
        "coverage": np.zeros((1, 5, layout.G_pad), np.int32),
        "zeroed": np.zeros((1, layout.G_pad), bool),
        "bucket_on": np.zeros((1, layout.NBk_pad), bool),
        "read_starts": np.zeros((layout.Wf_pad, 2)),
        "strat": np.ones((1, layout.Gd_pad, 2), bool),
    }
    cpu = []
    for _ in range(n_oracle):
        t0 = time.perf_counter()
        oracle.full_update(eng, st_np, batch_np, CCL, TIME_COST, fast_scores=True)
        cpu.append((time.perf_counter() - t0) * 1000.0)
    cpu_ms = min(cpu)
    total_bases = int(batch_np["mr_len"].sum(dtype=np.int64)) + int(
        (batch_np["ex_g"] != 0xFFFFFFFF).sum())
    record = {
        "metric": "strategy_update_p50_latency",
        "value": round(p50, 3),
        "unit": "ms",
        "vs_baseline": round(cpu_ms / p50, 2),
        "detail": {
            "genome_sites": int(sum(genome.values())),
            "reads_per_batch": n_reads,
            "bases_per_batch": total_bases,
            "reads_per_s": round(n_reads / (p50 / 1000.0), 1),
            "cpu_baseline_ms": round(cpu_ms, 1),
            "cpu_baseline_samples_ms": [round(t, 1) for t in cpu],
            "f64_ms": round(p50, 3),
            "n_samples": n_steps,
            "f32_ms": None,
            "device": device_name(dev),
        },
    }
    emit(record)
    eng32 = RunsEngine(layout, config=RunsConfig(benefit_dtype="float32"), device=dev)
    p32, _ = _step_p50_ms(eng32, eng32.init_state(), batch,
                          eng32.make_params(CCL, TIME_COST), n_f32_steps)
    record["detail"]["f32_ms"] = round(p32, 3)
    # replayed and eager steps of each engine (models/graphs.py; none on the CPU)
    record["detail"]["graphs"] = {k: e.graphs.stats() if e.graphs is not None else None
                                  for k, e in (("f64", eng), ("f32", eng32))}
    return record


def section_aligner(device=None, n_reads: int = N_READS, trials: int = 3,
                    lengths: tuple = tuple(GENOME.values())) -> list[dict]:
    """TorchAligner reads/s against the 4-thread host-seeded baseline, at the
    sim's batch size (``tools.bench_aligner``)."""
    from .tools import bench_aligner

    return bench_aligner.main(n_reads, trials, device=_device(device), lengths=lengths)


def _cached_corpus(cache: Path, dirname: str, **kw) -> dict:
    """write_corpus under ``cache``, reused when complete (the corpora are
    made from fixed seeds)."""
    from .utils.datagen import write_corpus

    out = cache / dirname
    done = out / ".complete"
    paths = {"ref": str(out / "ref.fa"), "fq": str(out / "reads.fq"),
             "paf_full": str(out / "full.paf"), "paf_trunc": str(out / "trunc.paf")}
    if done.exists() and all(Path(p).exists() for p in paths.values()):
        return paths
    paths = write_corpus(out, **kw)
    done.write_text("ok")
    return paths


def section_sim(device=None, genome: dict = GENOME, n_reads: int = N_READS,
                n_warm: int = 2, n_timed: int = 7, cache: Path = CACHE) -> dict:
    """One BossRunsSim batch over precomputed PAFs (sample -> decide -> pack
    -> step -> mask), on a corpus of 10 batches."""
    from .models.runs_sim import BossRunsSim

    dev = _device(device)
    paths = _cached_corpus(cache, "sim_corpus", rng=np.random.default_rng(3),
                           contig_lengths=genome, n_reads=n_reads * 10,
                           mean_len=float(MEAN_LEN))
    out = cache / "sim_out"
    shutil.rmtree(out, ignore_errors=True)
    sim = BossRunsSim(ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
                      paf_trunc=paths["paf_trunc"], name="bench", batchsize=n_reads,
                      maxb=n_warm + n_timed, out_base=out, device=dev)
    for _ in range(n_warm):
        sim.process_batch()
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        sim.process_batch()
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    return emit({
        "metric": "sim_batch_p50_latency",
        "value": round(p50 * 1000.0, 1),
        "unit": "ms",
        "vs_baseline": None,
        "detail": {"reads_per_batch": n_reads,
                   "reads_per_s": round(n_reads / p50, 1),
                   "floor_ms": round(float(np.min(times)) * 1000.0, 1),
                   "n_samples": len(times),
                   "phase_p50_ms": sim.phase_p50_ms(last=len(times)),
                   "device": device_name(dev)},
    })


def _aeons_strategy_numpy(contigs, ccl, lam, lowcov=10.0, mu=400):
    """CPU stand-in for the AEONS strategy stage: the reference's per-contig
    bn.move_sum pipeline (22 window sums a contig) in f64 NumPy
    (boss/aeons/sequences.py:1554-1678); the JAX bench's baseline for the
    contig strategy kernel, line for line."""
    from .oracle import move_sum_fwd, move_sum_rev

    weights = np.arange(0.1, 1.1, 0.1)[::-1]
    ccl_ds = np.maximum(np.asarray(ccl) // 100, 1)
    bens = []
    for s in contigs.values():
        cc = np.add.reduceat(s.cov, np.arange(0, len(s.cov), 100))
        scores = 1.0 / (np.exp(np.minimum(np.floor(cc / 100), 100.0) - lowcov) + 1.0)
        smu = np.stack([move_sum_fwd(scores, mu // 100), move_sum_rev(scores, mu // 100)], 1)
        eb = np.zeros_like(smu)
        for i in range(10):
            w = int(ccl_ds[i])
            eb[:, 0] += weights[i] * move_sum_fwd(scores, w)
            eb[:, 1] += weights[i] * move_sum_rev(scores, w)
        bens.append(np.maximum(eb - smu, 0.0))
    b = np.concatenate(bens).ravel()
    nz = b[b > 0]
    if nz.size == 0:
        return 0.0
    _m, e = np.frexp(nz / nz.max())
    counts = np.bincount(np.abs(e))
    used = np.flatnonzero(counts)
    bbin = np.power(2.0, -used.astype(np.float64)) * nz.max()
    tc = max((lam - mu - 300) // 100, 1.0)
    cs_u = np.cumsum(bbin * counts[used])
    cs_t = np.cumsum(tc * counts[used]) + 9
    return float(bbin[min(int(np.argmax(cs_u / cs_t)) + 1, used.size - 1)])


class PoolContig:
    """A contig of a synthetic strategy pool: n bases, coverage 0-29."""

    def __init__(self, n: int, rng):
        self.seq = "A" * n
        self.cov = rng.integers(0, 30, n).astype(np.float32)
        self.cap_l = self.cap_r = False


def strategy_pool(n_contigs: int, rng, contig_len: int = 200_000) -> dict:
    return {f"u{j}": PoolContig(contig_len, rng) for j in range(n_contigs)}


def section_aeons(device=None, genome_len: int = 300_000, n_reads: int = 4000,
                  batchsize: int = 500, n_timed: int = 3, pools: tuple = (40, 200),
                  contig_len: int = 200_000, cache: Path = CACHE) -> dict:
    """One BossAeonsSim batch (all-vs-all overlaps, assembly, contig
    strategies), warm, with per-stage medians; and the strategy stage at
    ``pools`` contigs of ``contig_len`` (8 and 40 Mb): H7 ("device"; also
    the production path, "auto") against the reference's f64 NumPy
    pipeline. A twin sim runs the same batches first, so the timed run
    finds the allocator, the kernel library and the first launches warm;
    the minimizer-scan memo is then dropped, so the timed run scans its
    reads anew. Results depend on PYTHONHASHSEED (ROADMAP F8): ``main``
    fixes it in this section's process."""
    from .aeons.benefit import contig_strategies
    from .aeons.simulation import BossAeonsSim
    from .aligner.index import _SEQ_SCAN_CACHE
    from .config import BossConfig

    dev = _device(device)
    paths = _cached_corpus(cache, "aeons_corpus", rng=np.random.default_rng(21),
                           contig_lengths={"gA": genome_len}, n_reads=n_reads, mean_len=5000.0)
    n_batches = n_timed + 1

    def make_args(name):
        args = BossConfig()
        args.general.name = name
        args.simulation.fq = paths["fq"]
        args.simulation.batchsize = batchsize
        args.simulation.maxb = n_batches
        args.simulation.binit = 2
        args.optional.min_seq_len = 2500
        args.optional.min_contig_len = 10_000
        return args

    shutil.rmtree(cache / "aeons_warm", ignore_errors=True)
    warm = BossAeonsSim(make_args("aeons_warm"), out_base=cache / "aeons_warm", device=dev)
    for _ in range(n_batches):
        warm.process_batch()
    _SEQ_SCAN_CACHE.clear()
    shutil.rmtree(cache / "aeons_out", ignore_errors=True)
    sim = BossAeonsSim(make_args("aeons_bench"), out_base=cache / "aeons_out", device=dev)
    sim.process_batch()
    times, stages = [], []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        sim.process_batch()
        times.append(time.perf_counter() - t0)
        stages.append(dict(sim.stage_times))
    p50 = float(np.median(times))
    stage_p50 = {k: round(float(np.median([s.get(k, 0.0) for s in stages])) * 1000.0, 1)
                 for k in stages[-1]}

    rng = np.random.default_rng(5)
    ccl, lam = sim.rl_dist.approx_ccl, sim.rl_dist.lam

    def strat_triple(n_contigs):
        pool = strategy_pool(n_contigs, rng, contig_len)
        out = {}
        for backend in ("auto", "device"):
            contig_strategies(pool, ccl=ccl, lam=lam, backend=backend, device=dev)  # warm
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                contig_strategies(pool, ccl=ccl, lam=lam, backend=backend, device=dev)
                ts.append(time.perf_counter() - t0)
            out[backend] = float(np.median(ts)) * 1000.0
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            _aeons_strategy_numpy(pool, ccl, lam)
            ts.append(time.perf_counter() - t0)
        out["cpu"] = float(np.median(ts)) * 1000.0
        return out

    s8, s40 = (strat_triple(n) for n in pools)
    return emit({
        "metric": "aeons_batch_p50_latency",
        "value": round(p50 * 1000.0, 1),
        "unit": "ms",
        "vs_baseline": round(s40["cpu"] / s40["auto"], 2),
        "detail": {"reads_per_batch": batchsize,
                   "n_contigs": len(sim.strat),
                   "shape_warmed": True,
                   "stage_p50_ms": stage_p50,
                   "strategy_8mb_production_ms": round(s8["auto"], 1),
                   "strategy_8mb_cpu_ms": round(s8["cpu"], 1),
                   "strategy_8mb_device_ms": round(s8["device"], 1),
                   "strategy_40mb_production_ms": round(s40["auto"], 1),
                   "strategy_40mb_cpu_ms": round(s40["cpu"], 1),
                   "strategy_40mb_device_ms": round(s40["device"], 1),
                   "dispatch": "device (contig_strategies backend 'auto' launches H7 "
                               "on a CUDA device)",
                   # the reference's AEONS batch shells out to minimap2,
                   # miniasm and gfatools, which are not installed: the only
                   # stage with a same-machine reference implementation is
                   # the strategy
                   "e2e_baseline": "none runnable (reference uses external"
                                   " C subprocesses); vs_baseline ="
                                   " strategy stage only",
                   "device": device_name(dev)},
    })


def section_scale(device=None, size_mb: float = 134.0) -> dict:
    """The step on a chromosome-scale genome (``tools.bench_scale``)."""
    from .tools import bench_scale

    return emit(bench_scale.one_size(size_mb, device=_device(device)))


def section_conformance(device=None, n_batches: int = 2, reads_per_batch: int = 12_000,
                        dp_reads_per_batch: int = 8000, lengths: dict | None = None,
                        cache: Path = CACHE) -> list[dict]:
    """The engine in quirk mode against the bug-compatible oracle on the
    zymo-like corpus (9 contigs, 12.6 Mb), as a mask-agreement fraction;
    then the data-plane drive (BossRunsSim's sample -> decide -> CIGAR ->
    coverage -> mask against the oracle fed the same PAF records), whose
    coverage comparison is exact."""
    from .conformance import drive_dataplane_conformance, drive_zymo_conformance

    dev = _device(device)
    out = drive_zymo_conformance(n_batches=n_batches, reads_per_batch=reads_per_batch,
                                 lengths=lengths, device=dev)
    zymo = emit({
        "metric": "conformance_mask_agreement",
        "value": round(out["min_agreement"], 6),
        "unit": "fraction",
        "vs_baseline": None,
        "detail": {"per_batch": [round(a, 6) for a in out["per_batch"]],
                   "exact_vs_drift_free_oracle": out["exact_vs_drift_free"],
                   "n_contigs": out["n_contigs"],
                   "n_sites": out["n_sites"],
                   "any_on": out["any_on"],
                   "residual_unexplained": out["residual_unexplained"],
                   "residual_precision": out["residual_precision"],
                   "residual_observed": out["residual_observed"],
                   "device": device_name(dev)},
    })
    dp = drive_dataplane_conformance(n_batches=n_batches, reads_per_batch=dp_reads_per_batch,
                                     lengths=lengths, work_dir=cache / "dpc", device=dev)
    return [zymo, emit({
        "metric": "conformance_dataplane",
        "value": round(dp["min_agreement"], 6),
        "unit": "fraction",
        "vs_baseline": None,
        "detail": {"coverage_exact": dp["coverage_exact"],
                   "per_batch": [round(a, 6) for a in dp["per_batch"]],
                   "n_sites": dp["n_sites"],
                   "any_on": dp["any_on"],
                   "residual_unexplained": dp["residual_unexplained"],
                   "residual_precision": dp["residual_precision"],
                   "residual_observed": dp["residual_observed"],
                   "device": device_name(dev)},
    })]


SECTIONS = {
    "aligner": section_aligner,
    "sim_batch": section_sim,
    "aeons_batch": section_aeons,
    "scale": section_scale,
    "conformance": section_conformance,
}
#: the order ``main`` runs them in: conformance before the last perf
#: sections, so that decision parity survives a budget that runs dry
ORDER = ("aligner", "sim_batch", "conformance", "aeons_batch", "scale")
#: each section's wall-clock estimate in seconds on one H100 (process
#: start included): it is skipped when the budget left cannot hold it, and
#: killed after twice as long
SECTION_EST = {"aligner": 120, "sim_batch": 120, "conformance": 240, "aeons_batch": 180,
               "scale": 60}
#: seconds kept at the end for the summary and the headline's second print
RESERVE = 20


def _run_section(name: str, timeout_s: float, env: dict) -> tuple[list[dict], int]:
    """Run one section in ``python -m bossruns_torch.bench --section name``,
    passing its output through line by line and collecting its JSON
    records; kills it (that process only) after ``timeout_s``. Returns
    (records, exit code; None when killed)."""
    import select
    import subprocess

    records = []
    proc = subprocess.Popen([sys.executable, "-m", "bossruns_torch.bench", "--section", name],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            if ready:
                line = proc.stdout.readline()
                if not line:
                    break
                print(line, end="", flush=True)
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "metric" in rec:
                    records.append(rec)
            if time.monotonic() > deadline:
                proc.kill()
                records.append(emit({"metric": f"{name}_timeout", "value": None, "unit": None,
                                     "vs_baseline": None, "detail": {"timeout_s": timeout_s}}))
                proc.wait()
                return records, None
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()
    return records, proc.returncode


def _error(name: str, e: BaseException) -> dict:
    return emit({"metric": f"{name}_error", "value": None, "unit": None,
                 "vs_baseline": None, "detail": {"error": repr(e)[:300]}})


def _summary(records: list[dict]) -> dict:
    return emit({"metric": "bench_summary", "value": len(records), "unit": "records",
                 "vs_baseline": None,
                 "detail": {"records": [{k: r.get(k) for k in ("metric", "value", "unit",
                                                               "vs_baseline")}
                                        for r in records]}})


def main(argv: list[str]) -> int:
    """The scoreboard (no arguments), or one section in this process
    (``--section NAME``, the subprocesses ``main`` starts). Exit code 0 only when
    every section printed its records."""
    if argv[:1] == ["--section"]:
        name = argv[1]
        try:
            SECTIONS[name](device=require_cuda())
        except Exception as e:  # noqa: BLE001 - the record tells main, then exit 1
            _error(name, e)
            return 1
        return 0
    dev = require_cuda()

    from .ops import kernels

    budget = float(os.environ.get("BENCH_BUDGET_S", 1250))
    t_start = time.monotonic()

    def remaining() -> float:
        return budget - (time.monotonic() - t_start)

    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s: {so.name}; "
          f"{device_name(dev)}", flush=True)
    records, failed = [], False
    headline = None
    try:
        headline = section_headline(device=dev)
    except Exception as e:  # noqa: BLE001
        records.append(_error("strategy_update", e))
        failed = True
    if os.environ.get("BENCH_ONLY", "") != "step":
        root = str(ROOT)
        for name in ORDER:
            est = SECTION_EST[name]
            if remaining() - RESERVE < est:
                records.append(emit({"metric": f"{name}_skipped", "value": None, "unit": None,
                                     "vs_baseline": None,
                                     "detail": {"reason": f"{remaining():.0f}s budget left < "
                                                          f"estimated {est}s"}}))
                failed = True
                continue
            env = dict(os.environ, BENCH_BUDGET_S=str(max(60.0, remaining() - RESERVE)),
                       PYTHONPATH=os.pathsep.join(
                           p for p in (root, os.environ.get("PYTHONPATH")) if p))
            if name == "aeons_batch":
                env["PYTHONHASHSEED"] = "0"
            t0 = time.monotonic()
            recs, rc = _run_section(name, max(60.0, min(remaining() - RESERVE, 2.0 * est)), env)
            print(f"# section {name}: {time.monotonic() - t0:.1f} s wall, exit code {rc}",
                  flush=True)
            records += recs
            if rc != 0 or not recs:
                failed = True
            _summary(([headline] if headline else []) + records)
    failed |= any(r["metric"].endswith(FAILED) for r in records)
    _summary(([headline] if headline else []) + records)
    if headline is not None:
        emit(headline)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
