"""On-card smoke run of the PyTorch/CUDA port (bossruns_torch) on one GPU.

    python3 chip_smoke.py                      # every phase (the on-card proof)
    python3 chip_smoke.py --phases 3,13,14     # a timing run of some phases

Phases, each printed on its own line; any failure raises and exits nonzero:
  1. the card: torch version, nvidia-smi name, power limit and highest SM
     clock;
  2. build the CUDA kernels from bossruns_torch/csrc (one nvcc per source,
     in parallel, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     8.05 Mb slice shape with a 4000-read batch (mean length 3500), with
     median times of both;
  4. the slice: a synthetic 8.05 Mb corpus through the port's gated
     BossRunsSim (4000-read batches), checked for strategy activation,
     rejections, enrichment, mask shapes, kernel launch counts and a
     checkpoint; the classic flow on the same corpus must agree exactly;
  5. the seeding kernel H5 against its plain version on that corpus, at
     k13/w5 and k15/w10: the 4000 reads' 400-base prefixes (L=512) and
     the largest full-length bucket group, all 24 rows exact, with times;
  6. the aligner on the card against the host-seeded aligner: records
     byte-identical for 4000 reads (truncated and full passes), reads/s of
     both, and the truncated records' loci against the corpus's own PAF;
  7. the simulation with live alignment (no PAFs, classic flow): 6
     batches of 4000 reads through H5 and H1-H4, with the same checks as 4;
  8. the live experiment (BossRuns) over two 4000-read fastq files;
  9. the all-vs-all seeding kernel H6 against its plain version on a
     metagenome-sized working pool (2000 reads of 5 kb, ~10 Mb): 500-read
     query batches at L=8192 and L=32768, all 48 entries of every row
     exact, with times, and find_overlaps on the card against host seeding
     (identical rows, times of both);
 10. the contig strategy kernel H7 against its plain version on bench.py's
     strat_triple pools (40 and 200 contigs of 200 kb, coverage 0-21 and
     0-29): threshold, mask and benefit exact, with times of H7, the plain
     version and the f64 host path;
 11. the AEONS simulation at bench.py's section_aeons shape (300 kb genome,
     4000 reads of mean 5 kb, batch 500, binit 2, 4 batches): masks and
     contigs written, time_boss <= time_control, decisions engaged, H5, H6
     and H7 launched, per-stage p50 times, and H7 exact against its plain
     version and the host path on the sim's final contigs;
 12. one live BossAeons.process_batch over two fastq files after an initial
     assembly;
 13. the sharded step's kernel H8 (the shard entry points of H1, H3 and
     H4) against its plain versions, phase by phase, on shard (b 1, g 1)
     of a (2, 4) in-process mesh over a human-chr1-sized genome
     (248,956,422 sites, ploidy 2, two barcodes), with times of both; H2
     timed on that shard as the step leaves it (sparse) and with dense
     coverage (covsum 1-29 at every site), held against its plain version
     on the dense shard's first 8M sites;
 14. the sharded engine on a (1, 4) mesh, all shards on the card, against
     the single-device engine on that genome with one barcode: 4 steps of
     4000-read batches, bit-identical state, aux and threshold, the step
     p50 and peak memory of each, H8's launches in the sharded run
     (whose shards have phase 13's shapes), and then each step's device
     time by launch;
 15. a (2, 2) mesh with two barcodes on the 8.05 Mb genome against the
     single engine, and BossRunsSim(mesh_shards=(1, 4)) over the corpus
     of phase 4 against the unsharded sims (6 batches, every bit).
Each driven path (4, 7, 8, 11, 12, the sharded run of 14, 15) runs with the
launch counts set to 0 just before it and read just after. H2's bound is
the larger of its byte bound and
the arithmetic (FMAs and special functions) of the sites these inputs need
contracted. Every kernel
time comes in two forms: ``ms``, CUDA events around one wrapper call (host
work in the wrapper included when the card waits for it), and
``device_ms``, the card's own time per call (``queued_ms``), with its split
by launch from torch.profiler (``device_split``) where a whole trace was
recorded (a split that left launches out lists them under "dropped"). The last three
lines are the kernel table (with each kernel's bound from the bytes it
must move), the card and
{"ok": true, "device": ...}. Nothing here imports JAX or the JAX package,
and the run checks that neither was loaded.
The port's decisions are held against the f64 NumPy oracle by
tests/test_torch_engine.py (CPU) and tests/test_torch_cuda.py (on a card).
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_READS = 4000
MEAN_LEN = 3500
GENOME = {"chr1": 4_050_000, "chr2": 2_000_000, "chr3": 2_000_000}
CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
TIME_COST = 5300.0
N_BATCHES = 6
N_LIVE_BATCHES = 6
UPDATE_KERNELS = ("coverage_update", "site_scores", "row_stage", "benefit_strategy")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 15, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def short_name(name: str) -> str:
    """A device event's name without namespace, template and argument list
    ("(anonymous namespace)::row_sums(RowArgs)" -> "row_sums")."""
    n = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return n.split("(")[0].split("<")[0].strip() or name


def queued_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Device time of one fn() call: the median over ``reps`` calls of CUDA
    events around each, with all calls queued behind a sleeping kernel, so
    the card runs them one after another without waiting for the host
    (launch gaps on the card included, host time not). fn must not
    synchronise."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    torch.cuda._sleep(50_000_000)  # ~30 ms, longer than the host takes to queue the calls
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def device_split(fn, reps: int = 10, warm: int = 2, band: tuple | None = None):
    """Device time of one fn() call by launch, in ms: torch.profiler (CPU
    and CUDA activities) over ``reps`` back-to-back calls, each device
    event's duration summed under its short name and divided by ``reps``.
    A memset is named after the kernel that follows it ("memset>row_sums"),
    so the memsets of one entry point stay apart from another's. A trace
    holds the device work of every thread (a sim's prefetch thread adds
    its copies), and on the card's machine a trace now and then lacks some
    of fn's events; so a launch name counts only when it occurs a multiple
    of ``reps`` times, and the trace only when the split's sum falls in
    ``band`` (lowest, highest ms; highest None for no ceiling), e.g. around
    the queued time of the same calls. A split that left launch names out
    is partial and lists them under "dropped". After three traces that
    fail, the split is None (not measured)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        names = [short_name(e.name) for e in evs]
        for i, n in enumerate(names):
            if n.lower().startswith("memset"):
                nxt = next((m for m in names[i + 1:] if not m.lower().startswith("memset")), "end")
                names[i] = f"memset>{nxt}"
        whole = {n for n, c in Counter(names).items() if c % reps == 0}
        split: dict[str, float] = {}
        for e, n in zip(evs, names):
            if n in whole:
                split[n] = split.get(n, 0.0) + e.time_range.elapsed_us() / 1000.0 / reps
        total = sum(split.values())
        if split and (band is None or (band[0] <= total and (band[1] is None or total <= band[1]))):
            dropped = sorted(set(names) - whole)
            if dropped:
                split["dropped"] = dropped
            return split
    log("# torch.profiler: three traces in a row failed the checks; split not measured")
    return None


def device(fn, reps: int = 10, warm: int = 2) -> dict:
    """``device_ms`` of one fn() call from ``queued_ms`` and its split by
    launch from ``device_split``, whose sum must lie within 70-110% of the
    queued time (the queued time also holds the gaps between launches)."""
    ms = queued_ms(fn, reps, warm)
    split = device_split(fn, reps, 0, band=(0.7 * ms, 1.1 * ms + 0.002))
    return dict(device_ms=ms, split=split or {})


def synced_device(fn, kernel: str, reps: int = 10) -> dict:
    """``device`` for a call that synchronises (it reads a result back), so
    its calls cannot queue: CUDA events recorded just around the C entry
    point ``kernel`` inside fn, each call behind a short sleeping kernel so
    the entry point's launches queue (median over ``reps`` calls)."""
    from bossruns_torch.ops import kernels

    kern = kernels.KERNELS[kernel]
    fn()
    real, pairs = kern._fn, []

    def timed(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        err = real(*args)
        e.record()
        pairs.append((s, e))
        return err

    kern._fn = timed
    try:
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)  # ~1 ms, longer than the entry point takes to launch
            fn()
    finally:
        kern._fn = real
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in pairs)
    # the split also holds the wrapper's own PyTorch kernels: no ceiling
    split = device_split(fn, reps, 0, band=(0.7 * ms, None))
    return dict(device_ms=ms, split=split or {})


def split_ms(split: dict) -> float:
    """The summed launch times of a split (its "dropped" names left out)."""
    return sum(v for k, v in split.items() if k != "dropped")


def fmt_split(split: dict) -> str:
    if not split:
        return "split not measured"
    out = ", ".join(f"{k} {v:.4f}" for k, v in split.items() if k != "dropped")
    if split.get("dropped"):
        out += f"; partial, dropped: {', '.join(split['dropped'])}"
    return out


def clone(d: dict) -> dict:
    """Deep-copy the tensors of a stage's arguments (stages update in place)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.clone()
        elif hasattr(v, "_fields") and not isinstance(v, type):
            out[k] = type(v)(*[x.clone() if isinstance(x, torch.Tensor) else x for x in v])
        else:
            out[k] = v
    return out


def differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Where a and b differ (two NaNs, as in never-written scratch, agree)."""
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    d = a != b
    if a.is_floating_point():
        d &= ~(torch.isnan(a) & torch.isnan(b))
    return d


def exact(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or bool(differ(a, b).any()):
        n = int(differ(a, b).sum()) if a.shape == b.shape else -1
        raise AssertionError(f"{name}: kernel and plain differ ({n} elements)")


def max_abs_err(*pairs) -> float:
    """Largest |a - b| over pairs of same-shape tensors, in f64."""
    worst = 0.0
    for a, b in pairs:
        d = differ(a, b)
        if not bool(d.any()):
            continue
        if a.dtype == torch.uint16:
            a, b = (x.view(torch.int16).to(torch.int32) & 0xFFFF for x in (a, b))
        worst = max(worst, float((a.to(torch.float64) - b.to(torch.float64))[d].abs().max()))
    return worst


def nbytes(*objs) -> int:
    """Bytes of the distinct tensors in objs (nested tuples, lists, dicts
    and objects' attributes): each counted once."""
    seen, total = set(), 0

    def walk(o):
        nonlocal total
        if isinstance(o, torch.Tensor):
            key = (o.data_ptr(), o.numel(), o.dtype)
            if key not in seen:
                seen.add(key)
                total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif hasattr(o, "__dict__") and not isinstance(o, type):
            walk(vars(o))

    for o in objs:
        walk(o)
    return total


#: HBM rate of one H100 SXM (NVIDIA's data sheet, 700 W)
HBM_BYTES_PER_MS = 3.35e12 / 1e3


def bound(bytes_moved: int) -> dict:
    """The least time the card could take to move the bytes a function
    must read and write once, from the HBM rate. Every kernel here does a
    few operations per byte (integer adds, compares, f64 adds), far below
    the card's operations-per-byte line, so bytes bound them."""
    return dict(bytes=int(bytes_moved), bound_ms=bytes_moved / HBM_BYTES_PER_MS, bound_by="bytes")


#: f32 rate outside the tensor cores (an FMA is two operations) and the
#: special-function units of one H100 SXM: 16 results per SM and clock
#: (NVIDIA's H100 data sheet and the CUDA arithmetic-throughput tables, 700 W)
F32_FLOP_PER_MS = 67e12 / 1e3
SFU_PER_SM_CLOCK = 16
N_SMS = 132
#: the card's highest SM clock in MHz (nvidia-smi clocks.max.sm), set by main()
SM_CLOCK_MHZ = 1980.0


def coverage_bound(rows, seq, changed, before, after) -> dict:
    """The coverage stage's bound for this run's data: its rows and seq read
    once, changed written once, and each coverage entry the step changed
    read and written once (2 B each way); entries it leaves alone it need
    not touch."""
    n = int(differ(before, after).sum())
    return dict(bound(nbytes(rows, seq, changed) + 4 * n), entries_changed=n)


def score_bound(args: dict, scores, covsum) -> dict:
    """H2's bound for these inputs: the larger of the byte bound (each input
    read once, scores and covsum written once) and the arithmetic of the
    sites that need the contraction (a nonzero count among the model's
    symbols, unfrozen, valid): 2 LB LG + LG + LB FMAs (the two contractions,
    the k and q log q sums) and LG + LB + 2 special-function operations
    (an exponential per genotype for the log-sum-exp, a log per symbol, the
    log of the sum and its reciprocal) per such site. The posterior can
    come from the log-sum-exp's own terms (e_j / se), so the kernel's second
    exponential pass, exp(lp - lse), which it keeps to round as the plain
    version does, is not counted. Every other site's score is one of four
    constants and costs no arithmetic."""
    t = args["tables"]
    LB, LG = t.len_b, t.len_g
    cov = args["coverage"]
    nz = (cov[:, :LB].view(torch.int16) != 0).any(dim=1)
    need = nz & (covsum < args["freeze_cov"]) & args["site_valid"][None, :]
    n = int(need.sum())
    by = bound(nbytes(args) + nbytes(scores, covsum))
    fma_ms = 2 * (2 * LB * LG + LG + LB) * n / F32_FLOP_PER_MS
    sfu_ms = (LG + LB + 2) * n / (N_SMS * SFU_PER_SM_CLOCK * SM_CLOCK_MHZ * 1e3)
    ops_ms = max(fma_ms, sfu_ms)
    out = dict(by, n_contract=n, sites=int(need.numel()), byte_ms=by["bound_ms"],
               fma_ms=fma_ms, sfu_ms=sfu_ms)
    if ops_ms > by["bound_ms"]:
        out.update(bound_ms=ops_ms, bound_by="operations")
    return out


def fmt_score_bound(b: dict) -> str:
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes {b['byte_ms']:.4f} ms for "
            f"{b['bytes']} B; {b['n_contract']} of {b['sites']} sites contracted: FMAs "
            f"{b['fma_ms']:.4f} ms, special functions {b['sfu_ms']:.4f} ms at "
            f"{SM_CLOCK_MHZ:.0f} MHz)")


def deep_clone(o):
    """Copies of every tensor in o (dicts, lists, tuples, NamedTuples)."""
    if isinstance(o, torch.Tensor):
        return o.clone()
    if isinstance(o, dict):
        return {k: deep_clone(v) for k, v in o.items()}
    if isinstance(o, tuple) and hasattr(o, "_fields"):
        return type(o)(*[deep_clone(v) for v in o])
    if isinstance(o, (list, tuple)):
        return type(o)(deep_clone(v) for v in o)
    return o


SHARD_KERNELS = ("shard_coverage", "shard_rows", "shard_benefit")
#: in-place keyword tensors of H8's phased entry points, besides their
#: workspace (shard_coverage writes its positional coverage and returns changed)
SHARD_WRITES = {"shard_rows": ("scores", "zeroed", "bucket_on", "read_starts", "aux"),
                "shard_benefit": ("strat", "aux")}


class ShardProbe:
    """ShardedRunsEngine.probe: before each H8 call of the chosen shards,
    runs the kernel and its plain version on copies of the arguments,
    compares them, and (with ``timed``) times both with CUDA events.

    Everything is exact except the f64 sums of non-integers (``_approx``),
    which other summation orders move by ulps of the running total: there
    the bar is rtol 1e-12 + 256 eps * the largest value (the bar of the H4
    check). Inputs of each phase are the engine's
    own, so the decision phases are compared exactly given equal inputs."""

    def __init__(self, shards, timed: bool = True):
        self.shards = set(shards)
        self.timed = timed
        self.err = {k: 0.0 for k in SHARD_KERNELS}
        self.ms = {k: 0.0 for k in SHARD_KERNELS}
        self.plain_ms = {k: 0.0 for k in SHARD_KERNELS}
        self.device_ms = {k: 0.0 for k in SHARD_KERNELS}
        self.split = {k: {} for k in SHARD_KERNELS}
        self.split_missing = set()  # kernels with a phase whose split was not measured
        self.read = {k: {} for k in SHARD_KERNELS}
        self.written = {k: {} for k in SHARD_KERNELS}
        self.cov_bytes = 0  # shard_coverage: coverage_bound's bytes of each call
        self.calls = []
        # H2 on the probed shard (timed only: its check is phase 3's) and
        # its arguments, for the dense shard of check_shard_kernels
        self.scores = None
        self.score_kw = None

    def _tally(self, name, args, kw, outs):
        def add(d, t):
            if isinstance(t, torch.Tensor):
                d[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()

        ins = [v for v in (*args, *kw.values()) if not isinstance(v, dict)]
        for t in ins:
            for x in (t if isinstance(t, (list, tuple)) else [t]):
                add(self.read[name], x)
        for t in outs:
            add(self.written[name], t)

    @staticmethod
    def _approx(name, phase, key, t) -> bool:
        """The f64 sums of non-integers, which other orders move by ulps:
        the benefit phases' scan, windows and bins, and H3's fhat
        normaliser (a fixed-order block reduction against torch.sum)."""
        if t.dtype != torch.float64:
            return False
        if name == "shard_benefit":
            return phase in ("scan", "prefix", "windows", "bins")
        return name == "shard_rows" and phase == "tables" and key == "scale"

    def bytes(self, name) -> int:
        if name == "shard_coverage":
            return self.cov_bytes
        return sum(self.read[name].values()) + sum(self.written[name].values())

    def __call__(self, fn, i, args, kw):
        from bossruns_torch.ops import genome_ops as gops

        name = fn.__name__
        if i not in self.shards:
            return
        if name == "site_scores" and self.timed:
            k1 = deep_clone(kw)
            s, c = fn(**k1)
            self.score_kw = k1
            self.scores = dict(ms=time_ms(lambda: fn(**k1), reps=5, warm=1),
                               **device(lambda: fn(**k1), reps=5, warm=1),
                               **score_bound(k1, s, c))
            return
        if name not in SHARD_KERNELS:
            return
        plain = getattr(gops, name + "_plain")
        a1, k1, a2, k2 = deep_clone(args), deep_clone(kw), deep_clone(args), deep_clone(kw)
        o1 = fn(*a1, **k1)
        o2 = plain(*a2, **k2)
        torch.cuda.synchronize()
        phase = a1[0] if name != "shard_coverage" else "all"
        if name == "shard_coverage":
            pairs = [("coverage", a1[0], a2[0], True), ("changed", o1, o2, True)]
            outs = [args[0], o1]
            self.cov_bytes += coverage_bound(args[2], args[1], o1, args[0], a1[0])["bytes"]
        else:
            ws = a1[1]
            ws = {k: v for k, v in ws.items() if k not in gops.ROW_SCRATCH}
            pairs = [(k, v, a2[1][k], not self._approx(name, phase, k, v))
                     for k, v in ws.items() if isinstance(v, torch.Tensor)]
            pairs += [(k, k1[k], k2[k], True) for k in SHARD_WRITES[name]]
            outs = [*ws.values(), *(kw.get(k) for k in SHARD_WRITES[name])]
        for k, x, y, want_exact in pairs:
            if want_exact:
                exact(f"{name} {phase} {k} (shard {i})", x, y)
            elif bool(differ(x, y).any()):
                d = differ(x, y)
                e = (x - y).abs()[d]
                tol = (1e-12 * y.abs() + 256 * np.finfo(np.float64).eps
                       * float(y[~torch.isnan(y)].abs().max()))[d]
                if not bool((e <= tol).all()):
                    raise AssertionError(f"{name} {phase} {k} (shard {i}): max err {float(e.max())}")
            self.err[name] = max(self.err[name], max_abs_err((x, y)))
        self._tally(name, args, kw, outs)
        if self.timed:
            self.ms[name] += time_ms(lambda: fn(*a1, **k1), reps=5, warm=1)
            self.plain_ms[name] += time_ms(lambda: plain(*a2, **k2), reps=3, warm=1)
            dv = device(lambda: fn(*a1, **k1), reps=5, warm=1)
            self.device_ms[name] += dv["device_ms"]
            if not dv["split"]:
                self.split_missing.add(name)
            for n, v in dv["split"].items():
                if n == "dropped":
                    self.split[name].setdefault("dropped", []).extend(f"{phase}:{d}" for d in v)
                    continue
                key = f"{phase}:{n}"
                self.split[name][key] = self.split[name].get(key, 0.0) + v
        self.calls.append((name, phase, i))


def build_inputs(rng):
    """Layout and a 4000-read match-run batch like bench.py:81-115, plus the
    same reads as a gated batch (full reads and their 400-base prefixes)."""
    from bossruns_torch.io.coo_native import EX_PAD, pad_split, split_runs, split_runs_rows
    from bossruns_torch.models.layout import build_layout

    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in GENOME.items()}
    layout = build_layout(contigs)
    lens = np.array(list(GENOME.values()))
    cid = rng.choice(len(lens), N_READS, p=lens / lens.sum())
    rlen = np.clip(rng.normal(MEAN_LEN, 2000, N_READS), 400, 20000).astype(np.int64)
    starts = (rng.random(N_READS) * (lens[cid] - rlen)).astype(np.int64)
    rstart = (layout.offsets[cid] + starts).astype(np.int64)
    pos = np.concatenate([s0 + np.arange(n) for s0, n in zip(rstart, rlen)])
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    qual = np.full(sym.shape[0], 40, np.int8)
    rbc = np.zeros(N_READS, np.int32)
    split = split_runs(layout, sym, qual, rstart, rlen.astype(np.int32), rbc)
    rs_row = rng.integers(0, layout.n_fhat, N_READS).astype(np.int32)
    rs_strand = rng.integers(0, 2, N_READS).astype(np.int32)
    batch_np = dict(pad_split(split), rs_row=rs_row, rs_strand=rs_strand,
                    rs_w=np.ones(N_READS, np.float32))

    # gated: family f = whole reads, family t = their first 400 bases
    rrow = np.arange(N_READS, dtype=np.int32)
    f = split_runs_rows(layout, sym, qual, rstart, rlen.astype(np.int32), rbc, rrow)
    tlen = np.minimum(rlen, 400)
    off = np.concatenate([[0], np.cumsum(rlen)[:-1]])
    tsel = np.concatenate([o + np.arange(n) for o, n in zip(off, tlen)])
    t = split_runs_rows(layout, sym[tsel], qual[tsel], rstart, tlen.astype(np.int32), rbc, rrow)

    def pad(a, fill=0):
        out = np.full(max(4, a.shape[0]), fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    gated_np = {}
    for pre, s in (("f_", f), ("t_", t)):
        for name, a in zip(("mr_bc", "mr_g", "mr_len", "mr_read"), s[:4]):
            gated_np[pre + name] = pad(a)
        for name, a in zip(("ex_bcsym", "ex_g", "ex_read"), s[4:]):
            gated_np[pre + name] = pad(a, EX_PAD if name == "ex_g" else 0)
    gated_np.update(rs_row=rs_row, rs_strand=rs_strand, rs_read=rrow)
    bits = (rng.random(N_READS) < 0.5).astype(np.uint8)
    log(f"# batch: {N_READS} reads, {pos.shape[0]} bases, {split[0].shape[0]} match runs, "
        f"{split[4].shape[0]} explicit observations")
    return layout, batch_np, gated_np, bits


def check_kernels(dev, card: str) -> dict:
    """Phase 3: every kernel against its plain version at the slice shape."""
    from bossruns_torch.models.convert import batch_from_numpy, tensors_from_numpy
    from bossruns_torch.models.runs import RunsEngine
    from bossruns_torch.ops import genome_ops as gops
    from bossruns_torch.ops import scores as sc

    rng = np.random.default_rng(11)
    layout, batch_np, gated_np, bits_np = build_inputs(rng)
    eng = RunsEngine(layout, device=dev)
    state = eng.init_state()
    batch = batch_from_numpy(batch_np, dev)
    gated = tensors_from_numpy(gated_np, dev)
    bits = torch.from_numpy(bits_np).to(dev)
    params = eng.make_params(CCL, TIME_COST)
    for _ in range(4):  # a realistic state: coverage ~7x, buckets on
        state, aux = eng.step(state, batch, params)
    ah = eng.pull_aux(aux)
    log(f"# state after 4 steps: any_on={ah.any_on} updated={ah.updated} "
        f"mean_coverage={ah.mean_coverage:.3f}")
    if not ah.any_on:
        raise AssertionError("buckets never switched on in the kernel-check state")
    res = {}

    # H1, ungated and gated: coverage and changed exact
    h1_err = 0.0
    full = gops.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    gf = gops.CovRows(gated["f_mr_bc"], gated["f_mr_g"], gated["f_mr_len"], gated["f_ex_bcsym"],
                      gated["f_ex_g"], gated["f_mr_read"], gated["f_ex_read"])
    gt = gops.CovRows(gated["t_mr_bc"], gated["t_mr_g"], gated["t_mr_len"], gated["t_ex_bcsym"],
                      gated["t_ex_g"], gated["t_mr_read"], gated["t_ex_read"])
    for label, args in (("ungated", eng.coverage_args(state, full)),
                        ("gated", eng.coverage_args(state, gf, gt, bits))):
        ak, ap = clone(args), clone(args)
        ch_k = gops.coverage_update(**ak)
        ch_p = gops.coverage_update_plain(**ap)
        exact(f"H1 {label} coverage", ak["coverage"], ap["coverage"])
        exact(f"H1 {label} changed", ch_k, ch_p)
        if label == "ungated":
            h1_bound = coverage_bound(args["full"], args["seq"], ch_k, args["coverage"],
                                      ak["coverage"])
        h1_err = max(h1_err, max_abs_err((ak["coverage"], ap["coverage"]), (ch_k, ch_p)))
        log(f"H1 coverage_update {label}: coverage and changed exact "
            f"({int(ch_k.sum())} sites changed)")
    args = eng.coverage_args(state, full)
    ak, ap = clone(args), clone(args)
    res["coverage_update"] = dict(
        ms=time_ms(lambda: gops.coverage_update(**ak)),
        plain_ms=time_ms(lambda: gops.coverage_update_plain(**ap)), max_abs_err=h1_err,
        **device(lambda: gops.coverage_update(**ak)), **h1_bound)

    # the stages below take the kernel outputs of the stage before
    changed = gops.coverage_update(**eng.coverage_args(state, full))

    # H2: scores within the stated f32 tolerance, covsum exact
    args = eng.score_args(state)
    s_k, cs_k = sc.site_scores(**args)
    s_p, cs_p = sc.site_scores_plain(**args)
    exact("H2 covsum", cs_k, cs_p)
    err = (s_k - s_p).abs()
    # same closed form in f32; summation order and exp/log differ
    tol = 1e-6 + 1e-5 * s_p.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"H2 scores outside rtol 1e-5 / atol 1e-6: max err {float(err.max())}")
    res["site_scores"] = dict(ms=time_ms(lambda: sc.site_scores(**args)),
                              plain_ms=time_ms(lambda: sc.site_scores_plain(**args)),
                              max_abs_err=float(err.max()),
                              **device(lambda: sc.site_scores(**args)),
                              **score_bound(args, s_k, cs_k))
    log(f"H2 site_scores: covsum exact, scores max abs err {float(err.max()):.3g} "
        "(rtol 1e-5, atol 1e-6: same f32 closed form, other summation order); "
        f"{fmt_score_bound(res['site_scores'])}")

    # H3, ungated (per-read weights) and gated (read bits): everything exact
    aux0 = torch.zeros(4, dtype=torch.float32, device=dev)
    args = eng.row_args(state, s_k, cs_k, changed, aux0, params,
                        batch.rs_row, batch.rs_strand, rs_w=batch.rs_w)
    gargs = eng.row_args(state, s_k, cs_k, changed, aux0, params, gated["rs_row"],
                         gated["rs_strand"], rs_read=gated["rs_read"], bits=bits)
    h3_err, outs = 0.0, {}
    for label, la in (("ungated", args), ("gated", gargs)):
        ak, ap = clone(la), clone(la)
        ds_k, fe_k = gops.row_stage(**ak)
        ds_p, fe_p = gops.row_stage_plain(**ap)
        pairs = (("scores_ds", ds_k, ds_p), ("fhat_exp", fe_k, fe_p),
                 ("scores", ak["scores"], ap["scores"]), ("zeroed", ak["zeroed"], ap["zeroed"]),
                 ("bucket_on", ak["bucket_on"], ap["bucket_on"]),
                 ("read_starts", ak["read_starts"], ap["read_starts"]),
                 ("aux", ak["aux"], ap["aux"]))
        for name, a, b in pairs:
            exact(f"H3 {label} {name}", a, b)
        h3_err = max(h3_err, max_abs_err(*((a, b) for _, a, b in pairs)))
        log(f"H3 row_stage {label}: scores_ds, fhat_exp, scores, zeroed, bucket_on, "
            f"read_starts, aux exact (read_starts total {float(ak['read_starts'].sum()):.0f})")
        outs[label] = ak, ds_k, fe_k
    ak, ds_k, fe_k = outs["ungated"]  # H4 takes the ungated stage's outputs
    gk, gp = clone(args), clone(args)
    res["row_stage"] = dict(ms=time_ms(lambda: gops.row_stage(**gk)),
                            plain_ms=time_ms(lambda: gops.row_stage_plain(**gp)),
                            max_abs_err=h3_err, **device(lambda: gops.row_stage(**gk)),
                            **bound(nbytes(args) + nbytes(
                                ds_k, fe_k, *(args[k] for k in ("scores", "zeroed", "bucket_on",
                                                               "read_starts", "aux")))))

    # H4: windows within tolerance; threshold and strat exact given equal inputs
    args = eng.benefit_args(state, ds_k, fe_k, ak["aux"], params)
    bk, bp = clone(args), clone(args)
    smu_k, ben_k, thr_k = gops.benefit_strategy(**bk)
    smu_p, ben_p, thr_p = gops.benefit_strategy_plain(**bp)
    # benefit and smu are differences of f64 prefix sums: beyond rtol 1e-12
    # they differ by the two scans' rounding, bounded by ulps of the total
    total = float(ds_k.sum(dim=1).max())
    atol = 256 * np.finfo(np.float64).eps * total
    worst = 0.0
    for name, a, b in (("smu", smu_k, smu_p), ("benefit", ben_k, ben_p)):
        e = (a - b).abs()
        worst = max(worst, float(e.max()))
        if not bool((e <= 1e-12 * b.abs() + atol).all()):
            raise AssertionError(f"H4 {name}: max err {float(e.max())} beyond rtol 1e-12 + {atol:.3g}")
    # the decision stage on the kernel's own benefit/smu must agree exactly
    ref = gops.find_strategy(ben_k, smu_k, fe_k[None].expand_as(ben_k), args["time_cost"])
    if float(ref.threshold) != float(thr_k):
        raise AssertionError(f"H4 threshold {float(thr_k)!r} != plain {float(ref.threshold)!r}")
    bidx = eng.bucket_idx.long()
    gate = args["bucket_on"][:, bidx.clamp_min(0)] & (bidx >= 0)[None] & eng.strat_valid[None]
    upd = bool(bk["aux"][1] > 0)
    want = torch.where((gate & upd)[..., None], ref.strat, args["strat"])
    exact("H4 strat", bk["strat"], want)
    exact("H4 aux", bk["aux"], bp["aux"])
    flips = int((bk["strat"] != bp["strat"]).sum())
    log(f"H4 benefit_strategy: smu/benefit max abs err {worst:.3g} (rtol 1e-12 + atol {atol:.3g}), "
        f"threshold {float(thr_k)!r} and strat exact given equal inputs; updated={upd}; "
        f"end-to-end vs plain: {flips} strat rows differ, threshold {float(thr_p)!r}")
    ck, cp = clone(args), clone(args)
    res["benefit_strategy"] = dict(
        ms=time_ms(lambda: gops.benefit_strategy(**ck)),
        plain_ms=time_ms(lambda: gops.benefit_strategy_plain(**cp)), max_abs_err=worst,
        **device(lambda: gops.benefit_strategy(**ck)),
        **bound(nbytes(args) + nbytes(smu_k, ben_k, thr_k, args["strat"], args["aux"])))

    # the whole device step (host clock around step + the aux pull)
    st_times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = eng.step(state, batch, params)
        eng.pull_aux(aux)
        st_times.append((time.perf_counter() - t0) * 1000.0)
    res["_step_p50_ms"] = statistics.median(st_times)
    for k, v in res.items():
        if not k.startswith("_"):
            log(f"time {k}: kernel {v['ms']:.4f} ms (device {v['device_ms']:.4f} ms), plain "
                f"{v['plain_ms']:.4f} ms [{card}]")
            log(f"device split {k} (launch ms): {fmt_split(v['split'])}")
    log(f"device step p50 (4000 reads, 8.05 Mb, host clock incl. aux pull): "
        f"{res['_step_p50_ms']:.3f} ms [{card}]")
    return res


def check_sim(sim, what: str) -> float:
    """Strategy activation, rejections, enrichment and mask shapes of a run
    simulation; returns the accepted share of valid strategy rows."""
    from bossruns_torch.utils.misc import read_strategy_npz

    if not bool(sim.state.bucket_on.any()):
        raise AssertionError(f"{what}: no bucket switched on")
    strat = sim.state.strat[:, sim.engine.strat_valid, :]
    acc = float(strat.float().mean())
    if not acc < 1.0:
        raise AssertionError(f"{what}: accepted share of strategy rows {acc} is not below 1")
    tb, tc = sim.read_cache.time_boss, sim.read_cache.time_control
    if not tb < tc:
        raise AssertionError(f"{what}: time_boss {tb} !< time_control {tc}")
    masks = read_strategy_npz(sim.out_dir / "masks" / "boss.npz")
    for name, L in GENOME.items():
        if masks[name].shape != (L // 100, 2, 1):
            raise AssertionError(f"{what}: mask {name} shape {masks[name].shape}")
    log(f"{what} checks: buckets on, accepted share {acc:.4f}, time_boss {tb} < "
        f"time_control {tc}, masks (len//100, 2, 1)")
    return acc


def run_slice(dev, card: str, work: Path, paths: dict) -> dict:
    """Phase 4: the gated simulation and its classic twin."""
    from bossruns_torch.models.runs_sim import BossRunsSim
    from bossruns_torch.ops import kernels

    def make(gated: bool, name: str) -> BossRunsSim:
        sim = BossRunsSim(ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
                          paf_trunc=paths["paf_trunc"], name=name, batchsize=N_READS,
                          maxb=N_BATCHES, out_base=work / name, gated=gated, device=dev)
        sim.checkpoint_every = 3
        return sim

    gsim = make(True, "gated")
    torch.cuda.synchronize()
    kernels.reset_launches()
    snaps = []
    t0 = time.perf_counter()
    for _ in range(N_BATCHES):
        gsim.process_batch()
        snaps.append(dict(cov=gsim.state.coverage.clone(), strat=gsim.state.strat.clone(),
                          rs=gsim.state.read_starts.clone(), tb=gsim.read_cache.time_boss,
                          tc=gsim.read_cache.time_control, dec=dict(gsim._last_decisions)))
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches = kernels.launches()
    log(f"gated sim: {N_BATCHES} batches of {N_READS} reads in {sim_s:.2f} s; launches {launches}")
    if min(launches[k] for k in UPDATE_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the gated sim never launched: {launches}")
    check_sim(gsim, "gated sim")
    if not (gsim.out_dir / "checkpoint" / "state.npz").exists():
        raise AssertionError("no checkpoint written")
    phase = gsim.phase_p50_ms()
    log("gated sim: checkpoint written")
    log(f"sim phase p50 ms: {json.dumps(phase)} [{card}]")
    gsim.cleanup()

    csim = make(False, "classic")
    kernels.reset_launches()
    for i, s in enumerate(snaps):
        csim.process_batch()
        exact(f"classic vs gated coverage, batch {i}", csim.state.coverage, s["cov"])
        exact(f"classic vs gated strat, batch {i}", csim.state.strat, s["strat"])
        exact(f"classic vs gated read_starts, batch {i}", csim.state.read_starts, s["rs"])
        if (csim.read_cache.time_boss, csim.read_cache.time_control) != (s["tb"], s["tc"]):
            raise AssertionError(f"classic vs gated pseudotime, batch {i}")
        if csim._last_decisions != s["dec"]:
            raise AssertionError(f"classic vs gated decisions, batch {i}")
    classic = kernels.launches()
    log(f"classic sim == gated sim exactly over {N_BATCHES} batches "
        f"(coverage, strat, read_starts, pseudotime, decisions); launches {classic}")
    if min(classic[k] for k in UPDATE_KERNELS) <= 0:
        raise AssertionError(f"a kernel of the classic sim never launched: {classic}")
    csim.cleanup()

    return dict(launches=launches, phase=phase, sim_s=sim_s, snaps=snaps)


def read_corpus_reads(paths: dict, n: int) -> dict:
    """The first n reads of the corpus fastq, {rid: seq}."""
    seqs = {}
    with open(paths["fq"]) as fh:
        while len(seqs) < n:
            head = fh.readline()
            if not head:
                break
            seq = fh.readline().strip()
            fh.readline()
            fh.readline()
            seqs[head[1:].split()[0]] = seq
    return seqs


def check_seed_kernel(dev, card: str, paths: dict, seqs: dict) -> dict:
    """Phase 5: H5 against its plain version on the corpus reads."""
    from bossruns_torch.aligner import BUCKET_ROWS, bucket_of, encode
    from bossruns_torch.aligner import seed as S
    from bossruns_torch.aligner.index import build_index
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs_sim import load_reference_contigs

    layout = build_layout(load_reference_contigs(paths["ref"]))
    enc = [encode(s) for s in seqs.values()]
    groups: dict[int, list] = {}
    for e in enc:
        groups.setdefault(bucket_of(e.shape[0]), []).append(e)
    L_full = max(groups, key=lambda b: len(groups[b]))
    cases = (("prefixes", 512, [e[:400] for e in enc]),
             ("full", L_full, groups[L_full][: BUCKET_ROWS[L_full]]))
    res, worst = {}, 0.0
    for k, w in ((13, 5), (15, 10)):
        t0 = time.perf_counter()
        idx = build_index(layout.seq_int, layout.site_valid(), k=k, w=w)
        di = S.DeviceIndex(idx, dev)
        log(f"index k{k} w{w}: {idx.n_minimizers} positions, {idx.keys.shape[0]} keys, "
            f"built in {time.perf_counter() - t0:.1f} s")
        for label, L, reads in cases:
            mat = np.full((len(reads), L), 4, np.int8)
            for r, e in enumerate(reads):
                mat[r, : e.shape[0]] = e[:L]
            x = torch.from_numpy(mat).to(dev)
            b = S.anchor_budget(L, w)
            got = S.seed_topn(x, di, k, w, b, L)
            want = S.seed_topn_plain(x, di, k, w, b, L)
            torch.cuda.synchronize()
            err = max_abs_err((got, want))
            worst = max(worst, err)
            exact(f"H5 k{k} w{w} {label} L={L}", got, want)
            ms = time_ms(lambda: S.seed_topn(x, di, k, w, b, L))
            plain_ms = time_ms(lambda: S.seed_topn_plain(x, di, k, w, b, L), reps=5)
            dv = device(lambda: S.seed_topn(x, di, k, w, b, L))
            mapped = float((got[2] >= 3).float().mean())
            # the function's own inputs and outputs (not the kernel's bucket table)
            r = res[(k, w, label)] = dict(ms=ms, plain_ms=plain_ms, **dv,
                                          **bound(nbytes(x, di.keys, di.pos_packed, got)))
            log(f"H5 seed_topn k{k} w{w} {label} L={L} R={len(reads)} budget {b}: all 24 rows exact, "
                f"candidate 0 voted >= 3 for {mapped:.3f} of reads; kernel {ms:.4f} ms (device "
                f"{dv['device_ms']:.4f} ms: {fmt_split(dv['split'])}), plain {plain_ms:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms [{card}]")
    # the main path's shape: the sim's decision pass (k13/w5, prefixes);
    # the full-length group is reported beside it
    full = res[(13, 5, "full")]
    log(f"H5 full-length group k13 w5 L={L_full}: kernel {full['ms']:.4f} ms, device "
        f"{full['device_ms']:.4f} ms, plain {full['plain_ms']:.4f} ms, bound "
        f"{full['bound_ms']:.4f} ms [{card}]")
    return dict(res[(13, 5, "prefixes")], max_abs_err=worst)


def check_aligner(dev, card: str, paths: dict, seqs: dict) -> None:
    """Phase 6: records seeded on the card == host-seeded records."""
    from bossruns_torch.aligner import make_aligner
    from bossruns_torch.io.paf import best_per_query, parse_paf
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs_sim import load_reference_contigs

    layout = build_layout(load_reference_contigs(paths["ref"]))
    prof = dict(k=13, w=5, min_votes=3)
    card_al = make_aligner(layout, device=dev, **prof)
    host_al = make_aligner(layout, device="cpu", backend="host", **prof)
    fields = ("qlen", "qstart", "qend", "rev", "tlen", "tstart", "tend", "nmatch",
              "blocklen", "mapq", "align_score", "s1", "primary")
    for label, kw in (("truncated", dict(trunc=True)), ("full", {})):
        card_al.map_sequences(seqs, **kw)  # warm-up
        tc, th = [], []
        for _ in range(2):  # interleaved, so host load hits both alike
            t0 = time.perf_counter()
            a = card_al.map_sequences(seqs, **kw)
            tc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            b = host_al.map_sequences(seqs, **kw)
            th.append(time.perf_counter() - t0)
        if len(a) != len(b) or list(a.qname) != list(b.qname) or list(a.tname) != list(b.tname):
            raise AssertionError(f"aligner {label}: record sets differ")
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"aligner {label}: field {f} differs")
        if any(x.dtype != y.dtype or not np.array_equal(x, y) for x, y in zip(a.cigars, b.cigars)):
            raise AssertionError(f"aligner {label}: cigars differ")
        log(f"aligner {label} pass, {len(seqs)} reads: {len(a)} records byte-identical; "
            f"device-seeded {len(seqs) / min(tc):.0f} reads/s ({card_al.threads} DP threads), "
            f"host-seeded {len(seqs) / min(th):.0f} reads/s ({host_al.threads} seeding and DP "
            f"threads) [{card}]")
        if label == "truncated":
            with open(paths["paf_trunc"]) as fh:
                truth = parse_paf(fh.read())
            tb = best_per_query(truth)
            ab = best_per_query(a)
            n = good = 0
            for rid, i in ab.items():
                j = tb.get(rid)
                if j is None:
                    continue
                n += 1
                rev = int(a.rev[i])
                pa = int(a.tend[i]) if rev else int(a.tstart[i])
                pt = int(truth.tend[j]) if int(truth.rev[j]) else int(truth.tstart[j])
                good += (a.tname[i] == truth.tname[j] and rev == int(truth.rev[j])
                         and abs(pa - pt) <= 40)
            share = good / max(n, 1)
            log(f"truncated records agreeing with the corpus PAF (contig, strand, 5' +-40): "
                f"{good}/{n} = {share:.4f}")
            if share < 0.9:
                raise AssertionError(f"truncated-record agreement {share:.4f} < 0.9")
    # small truncated batches (a live chunk batch is tens to hundreds of
    # reads): where per-call costs could favour host seeding
    for n in (16, 64, 256, 1024):
        sub = dict(list(seqs.items())[:n])
        tc, th = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            card_al.map_sequences(sub, trunc=True)
            tc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            host_al.map_sequences(sub, trunc=True)
            th.append(time.perf_counter() - t0)
        log(f"aligner truncated pass, {n} reads: device-seeded "
            f"{1000 * statistics.median(tc):.2f} ms, host-seeded "
            f"{1000 * statistics.median(th):.2f} ms (median of 5) [{card}]")


def run_live_align_sim(dev, card: str, work: Path, paths: dict) -> dict:
    """Phase 7: the simulation aligning live (no PAFs) through H5."""
    from bossruns_torch.models.runs_sim import BossRunsSim
    from bossruns_torch.ops import kernels

    sim = BossRunsSim(ref=paths["ref"], fq=paths["fq"], name="livealign", batchsize=N_READS,
                      maxb=N_LIVE_BATCHES, out_base=work / "livealign", device=dev)
    if sim._gated or sim.aligner is None:
        raise AssertionError("the live-alignment sim must run the classic flow with an aligner")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(N_LIVE_BATCHES):
        sim.process_batch()
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches = kernels.launches()
    log(f"live-alignment sim: {N_LIVE_BATCHES} batches of {N_READS} reads in {sim_s:.2f} s; "
        f"launches {launches}")
    if min(launches[k] for k in (*UPDATE_KERNELS, "seed_topn")) <= 0:
        raise AssertionError(f"a kernel of the live-alignment sim never launched: {launches}")
    check_sim(sim, "live-alignment sim")
    phase = sim.phase_p50_ms()
    log(f"live-alignment sim phase p50 ms: {json.dumps(phase)} [{card}]")
    sim.cleanup()
    return dict(launches=launches, phase=phase)


def run_live_experiment(dev, work: Path, paths: dict) -> None:
    """Phase 8: BossRuns over two fastq files appearing in fastq_pass/."""
    from types import SimpleNamespace

    from bossruns_torch.models.experiment import BossRuns
    from bossruns_torch.ops import kernels

    fqdir = work / "run" / "fastq_pass"
    fqdir.mkdir(parents=True)
    with open(paths["fq"]) as fh:
        lines = fh.readlines()
    per = 4 * N_READS
    args = SimpleNamespace(
        general=SimpleNamespace(name="live", ref=paths["ref"], wait=1, barcodes=None),
        optional=SimpleNamespace(reject_refs=None, ploidy=1, bucket_threshold=5, resume=False),
    )
    exp = BossRuns(args, out_base=work / "live", device=dev)
    exp.fq_dir, exp.channels = str(fqdir), set()
    torch.cuda.synchronize()
    kernels.reset_launches()
    covs = []
    for i in range(2):
        (fqdir / f"batch{i}.fq").write_text("".join(lines[i * per: (i + 1) * per]))
        t0 = time.perf_counter()
        exp.process_batch()
        torch.cuda.synchronize()
        covs.append(int(exp.state.coverage.to(torch.int32).sum()))
        log(f"live experiment batch {i + 1}: {N_READS} reads in "
            f"{time.perf_counter() - t0:.2f} s, coverage total {covs[-1]}")
    launches = kernels.launches()
    if not (0 < covs[0] < covs[1]) or exp.batch != 2:
        raise AssertionError(f"live experiment: coverage did not grow {covs}")
    if not (exp.out_dir / "masks" / "boss.npz").exists():
        raise AssertionError("live experiment: no masks written")
    if launches["seed_topn"] <= 0:
        raise AssertionError(f"live experiment: H5 never launched: {launches}")
    log(f"live experiment checks: coverage grew, masks written; launches {launches}")


AVA_POOL_READS = 2000
AVA_QUERY_READS = 500
AEONS_GENOME = 300_000
AEONS_READS = 4000
AEONS_BATCH = 500
AEONS_BINIT = 2
AEONS_MAXB = 4


def check_ava(dev, card: str) -> dict:
    """Phase 9: H6 against its plain version, and find_overlaps seeded on
    the card against host seeding, on a ~10 Mb working pool."""
    from bossruns_torch.aeons.ava import PoolIndex, find_overlaps
    from bossruns_torch.aligner import encode
    from bossruns_torch.aligner import seed as S
    from bossruns_torch.utils.datagen import random_genome, simulate_reads

    rng = np.random.default_rng(17)
    genome = random_genome(rng, {"m1": 1_200_000, "m2": 800_000})
    pool = {r.rid: r.seq for r in simulate_reads(rng, genome, AVA_POOL_READS, mean_len=5000.0,
                                                 sd_len=1500.0)}
    t0 = time.perf_counter()
    pidx = PoolIndex(pool, device=dev)
    di = pidx.dev
    log(f"pool index: {AVA_POOL_READS} reads, {sum(map(len, pool.values()))} bases, "
        f"{pidx.host.n_minimizers} positions, built in {time.perf_counter() - t0:.1f} s")
    res, worst = {}, 0.0
    for L, lo, ml in ((8192, 0, 5000.0), (32768, 8193, 16000.0)):
        q = []
        while len(q) < AVA_QUERY_READS:
            q += [r for r in simulate_reads(rng, genome, AVA_QUERY_READS, mean_len=ml,
                                            sd_len=ml / 3) if lo <= len(r.seq) <= L]
        q = q[:AVA_QUERY_READS]
        mat = np.full((len(q), L), 4, np.int8)
        for i, r in enumerate(q):
            e = encode(r.seq)
            mat[i, : e.shape[0]] = e
        x = torch.from_numpy(mat).to(dev)
        tol = S.candidate_tol(L)
        got = S.seed_candidates(x, di)
        want = S.seed_candidates_plain(x, di, tol=tol)
        torch.cuda.synchronize()
        worst = max(worst, max_abs_err((got, want)))
        exact(f"H6 L={L}", got, want)
        ms = time_ms(lambda: S.seed_candidates(x, di), reps=10)
        plain_ms = time_ms(lambda: S.seed_candidates_plain(x, di, tol=tol), reps=3, warm=1)
        dv = device(lambda: S.seed_candidates(x, di))
        hit = float((got[:, 0] >= 4).any(dim=1).float().mean())
        log(f"H6 seed_candidates L={L} R={len(q)} tol {tol}: all 48 entries of every row exact, "
            f"{hit:.3f} of reads with a cluster of >= 4 votes; kernel {ms:.4f} ms (device "
            f"{dv['device_ms']:.4f} ms: {fmt_split(dv['split'])}), plain {plain_ms:.4f} ms [{card}]")
        # the function's own inputs and outputs (not the kernel's bucket table)
        res[L] = dict(ms=ms, plain_ms=plain_ms, **dv,
                      **bound(nbytes(x, di.keys, di.pos_packed, got)))
        queries = {r.rid: r.seq for r in q}
        find_overlaps(queries, pidx)  # warm-up
        td, th = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            rows_d = find_overlaps(queries, pidx, merge=True)
            td.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            rows_h = find_overlaps(queries, pidx, merge=True, backend="host")
            th.append(time.perf_counter() - t0)
        if rows_d != rows_h:
            raise AssertionError(f"find_overlaps L={L}: device-seeded rows != host-seeded rows")
        log(f"find_overlaps L={L}, {len(q)} queries: {len(rows_d['qname'])} rows identical; "
            f"device-seeded {1000 * statistics.median(td):.1f} ms, host-seeded "
            f"{1000 * statistics.median(th):.1f} ms (median of 3) [{card}]")
    # the main path's shape: the sim's batches are 5 kb reads (L=8192)
    return dict(res[8192], max_abs_err=worst)


class _PoolContig:
    """A contig of bench.py's strat_triple pools: 200 kb, random coverage."""

    def __init__(self, n: int, rng, hi: int):
        self.seq = "A" * n
        self.cov = rng.integers(0, hi, n).astype(np.float32)
        self.cap_l = self.cap_r = False


def check_aeons_strategy(dev, card: str) -> dict:
    """Phase 10: H7 against its plain version and the f64 host path."""
    from bossruns_torch.aeons import benefit as B

    ccl = np.array([20000, 14000, 10000, 7000, 5000, 3500, 2500, 1700, 900, 300])
    lam = 6000.0
    rng = np.random.default_rng(5)
    res, worst = {}, 0.0
    for n_contigs in (40, 200):
        for hi in (22, 30):
            pool = {f"u{j}": _PoolContig(200_000, rng, hi) for j in range(n_contigs)}
            inp = B.StrategyInputs.build(pool, ccl, lam)
            args = inp.device_args(dev)
            mk, tk, bk = B.strategy(*args)
            mp, tp, bp = B.strategy_plain(*args)
            mh, th = inp.run_host()
            torch.cuda.synchronize()
            if tk != tp:
                raise AssertionError(f"H7 threshold {tk!r} != plain {tp!r}")
            exact("H7 mask", mk, mp)
            exact("H7 benefit", bk, bp)
            worst = max(worst, max_abs_err((bk, bp)))
            if abs(tk - th) > 1e-12 * abs(th) or not np.array_equal(mk.cpu().numpy(), mh):
                raise AssertionError(f"H7 vs host path: threshold {tk!r} vs {th!r}, "
                                     f"{int((mk.cpu().numpy() != mh).sum())} mask bits")
            ms = time_ms(lambda: B.strategy(*args), reps=10)
            plain_ms = time_ms(lambda: B.strategy_plain(*args), reps=3, warm=1)
            hs = []
            for _ in range(3):
                t0 = time.perf_counter()
                inp.run_host()
                hs.append(time.perf_counter() - t0)
            ed, eh = [], []
            for _ in range(3):  # contig_strategies end to end, descriptor build included
                t0 = time.perf_counter()
                B.contig_strategies(pool, ccl, lam, device=dev)
                ed.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                B.contig_strategies(pool, ccl, lam, device=dev, backend="host")
                eh.append(time.perf_counter() - t0)
            mb = n_contigs * 200_000 // 1_000_000
            log(f"H7 aeons_strategy {mb} Mb ({n_contigs} x 200 kb), coverage 0-{hi - 1}: "
                f"threshold {tk!r}, mask ({int(mk.sum())} of {mk.numel()} accepted) and benefit "
                f"exact vs plain, equal to the f64 host path; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, host path {1000 * statistics.median(hs):.2f} ms; "
                f"contig_strategies device {1000 * statistics.median(ed):.1f} ms, host "
                f"{1000 * statistics.median(eh):.1f} ms [{card}]")
            res[(n_contigs, hi)] = dict(ms=ms, plain_ms=plain_ms,
                                        **synced_device(lambda: B.strategy(*args), "aeons_strategy"),
                                        **bound(nbytes(args) + nbytes(mk, bk)))
    # the main path's shape is a few small contigs; report the 8 Mb pool
    return dict(res[(40, 22)], max_abs_err=worst)


def aeons_args(name: str, fq: str):
    from types import SimpleNamespace

    return SimpleNamespace(
        general=SimpleNamespace(name=name, wait=1),
        simulation=SimpleNamespace(fq=fq, batchsize=AEONS_BATCH, maxb=AEONS_MAXB,
                                   binit=AEONS_BINIT, dumptime=200_000_000),
        optional=SimpleNamespace(min_seq_len=2500, min_contig_len=10_000, min_map_len=2000,
                                 min_s1=200, tetra=True, temperature=60, lowcov=10,
                                 filter_repeats=False, resume=False),
        live=SimpleNamespace(data_wait=0, device=None),
    )


def run_aeons_sim(dev, card: str, work: Path) -> dict:
    """Phase 11: the AEONS simulation at bench.py's section_aeons shape."""
    from bossruns_torch.aeons.simulation import BossAeonsSim
    from bossruns_torch.ops import kernels
    from bossruns_torch.utils.datagen import write_corpus

    t0 = time.perf_counter()
    paths = write_corpus(work / "aeons_data", rng=np.random.default_rng(21),
                         contig_lengths={"gA": AEONS_GENOME}, n_reads=AEONS_READS,
                         mean_len=5000.0)
    log(f"AEONS corpus: {AEONS_GENOME} sites, {AEONS_READS} reads, written in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sim = BossAeonsSim(aeons_args("aeons", paths["fq"]), out_base=work / "aeons", device=dev)
    init_s = time.perf_counter() - t0
    stages, batch_s, engaged = [], [], 0
    for _ in range(AEONS_MAXB):
        t0 = time.perf_counter()
        sim.process_batch()
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        stages.append(dict(sim.stage_times))
        engaged += sim.accept_count + sim.reject_count
    launches = kernels.launches()
    log(f"AEONS sim: initial assembly of {AEONS_BINIT} x {AEONS_BATCH} reads in {init_s:.2f} s, "
        f"{AEONS_MAXB} batches of {AEONS_BATCH} in {sum(batch_s):.2f} s "
        f"(p50 {1000 * statistics.median(batch_s):.0f} ms); launches {launches} [{card}]")
    for k in ("seed_topn", "seed_candidates", "aeons_strategy"):
        if launches[k] <= 0:
            raise AssertionError(f"AEONS sim: {k} never launched: {launches}")
    out = Path(sim.out_dir)
    if not (out / "masks" / "boss.npz").exists() or not (out / "contigs" / "aeons.fa").exists():
        raise AssertionError("AEONS sim: masks or contigs not written")
    tb, tc = sim.read_cache.time_boss, sim.read_cache.time_control
    if not tb <= tc:
        raise AssertionError(f"AEONS sim: time_boss {tb} > time_control {tc}")
    if engaged <= 0 or not sim.strat:
        raise AssertionError("AEONS sim: no decisions engaged")
    n_contigs = len(sim.strat)
    acc = float(np.mean([m.mean() for m in sim.strat.values()]))
    stage_p50 = {k: round(1000 * statistics.median(s.get(k, 0.0) for s in stages), 1)
                 for k in stages[-1]}
    log(f"AEONS sim checks: {n_contigs} contigs, accepted share {acc:.4f}, "
        f"{engaged} decisions, time_boss {tb} <= time_control {tc}, masks and contigs written")
    log(f"AEONS sim stage p50 ms: {json.dumps(stage_p50)} [{card}]")
    # H7 at the sim's own shape (its contig set after the last batch),
    # outside the counted run: exact against its plain version and the host path
    from bossruns_torch.aeons import benefit as B

    contigs = sim.pool.declare_contigs(sim.args.optional.min_contig_len).sequences
    inp = B.StrategyInputs.build(contigs, sim.rl_dist.approx_ccl, sim.rl_dist.lam,
                                 sim.args.optional.lowcov)
    args = inp.device_args(dev)
    mk, tk, _ = B.strategy(*args)
    mp, tp, _ = B.strategy_plain(*args)
    mh, th = inp.run_host()
    torch.cuda.synchronize()
    exact("H7 mask at the sim's contigs", mk, mp)
    if tk != tp or abs(tk - th) > 1e-12 * abs(th) or not np.array_equal(mk.cpu().numpy(), mh):
        raise AssertionError(f"H7 at the sim's contigs: threshold {tk!r}, plain {tp!r}, "
                             f"host {th!r}")
    log(f"H7 at the sim's {len(contigs)} contigs ({inp.cov.shape[0]} chunks): threshold and "
        f"mask exact vs plain and host path; kernel {time_ms(lambda: B.strategy(*args)):.4f} "
        f"ms [{card}]")
    sim.read_cache.flush()
    return dict(launches=launches, paths=paths)


def run_aeons_live(dev, card: str, work: Path, paths: dict) -> None:
    """Phase 12: BossAeons, initial assembly then one batch over two files."""
    from bossruns_torch.aeons.core import BossAeons
    from bossruns_torch.ops import kernels

    fqdir = work / "aeons_run" / "fastq_pass"
    fqdir.mkdir(parents=True)
    with open(paths["fq"]) as fh:
        lines = fh.readlines()
    per = 4 * AEONS_BATCH
    (fqdir / "f0.fq").write_text("".join(lines[: 2 * per]))
    exp = BossAeons(aeons_args("aeons_live", paths["fq"]), out_base=work / "aeons_live",
                    device=dev)
    exp.fq_dir, exp.channels = str(fqdir), set()
    exp.first_live_asm()
    for i in (1, 2):
        (fqdir / f"f{i}.fq").write_text("".join(lines[(1 + i) * per: (2 + i) * per]))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    exp.process_batch()
    torch.cuda.synchronize()
    launches = kernels.launches()
    if exp.batch != 1 or len(exp.processed_files) != 3 or not exp.strat:
        raise AssertionError("live AEONS: the batch did not run")
    if launches["seed_candidates"] <= 0 or launches["aeons_strategy"] <= 0:
        raise AssertionError(f"live AEONS: H6/H7 never launched: {launches}")
    if not (Path(exp.out_dir) / "masks" / "boss.npz").exists():
        raise AssertionError("live AEONS: no masks written")
    log(f"live AEONS batch: {2 * AEONS_BATCH} reads from 2 files in "
        f"{time.perf_counter() - t0:.2f} s, {len(exp.strat)} contigs; launches {launches} [{card}]")


# ------------------------------------------- the sharded engine (K11 -> H8) --

#: GRCh38 chr1's length, in two contigs of equal halves (BASELINE config 3)
CHR1_SITES = 248_956_422
CHR1 = {"chr1p": CHR1_SITES // 2, "chr1q": CHR1_SITES - CHR1_SITES // 2}
N_CHR_STEPS = 4


def chrom_batches(rng, layout, n_batches: int, hot: tuple, hot_share: float, nb: int):
    """4000-read batches (mean 3500, 5% errors) on the chromosome layout:
    ``hot_share`` of the reads start in the global window ``hot``, which
    straddles a shard edge; the rest are uniform over the contigs."""
    from bossruns_torch.io.coo_native import pad_split, split_runs

    lens = layout.lengths
    out = []
    for _ in range(n_batches):
        rlen = np.clip(rng.normal(MEAN_LEN, 2000, N_READS), 400, 20000).astype(np.int64)
        n_hot = int(N_READS * hot_share)
        cid = rng.choice(len(lens), N_READS - n_hot, p=lens / lens.sum())
        uni = layout.offsets[cid] + (rng.random(N_READS - n_hot) * (lens[cid] - rlen[n_hot:]))
        hs = hot[0] + rng.random(n_hot) * (hot[1] - hot[0] - rlen[:n_hot])
        rstart = np.concatenate([hs, uni]).astype(np.int64)
        pos = np.concatenate([s0 + np.arange(n) for s0, n in zip(rstart, rlen)])
        sym = layout.seq_int[pos].astype(np.int8)
        flip = rng.random(pos.shape[0]) < 0.05
        sym[flip] = rng.integers(0, 5, int(flip.sum()))
        split = split_runs(layout, sym, np.full(pos.shape[0], 40, np.int8), rstart,
                           rlen.astype(np.int32), rng.integers(0, nb, N_READS).astype(np.int32))
        out.append(dict(pad_split(split),
                        rs_row=rng.integers(0, layout.n_fhat, N_READS).astype(np.int32),
                        rs_strand=rng.integers(0, 2, N_READS).astype(np.int32),
                        rs_w=np.ones(N_READS, np.float32)))
    return out


def chrom_genome(rng) -> dict:
    return {n: rng.integers(0, 4, L, dtype=np.uint8) for n, L in CHR1.items()}


def check_shard_kernels(dev, card: str, genome: dict) -> dict:
    """Phase 13: H8's entry points against their plain versions on shard
    (b 1, g 1) of a (2, 4) mesh over the chromosome with two barcodes (so
    the barcode-axis reductions of changed and the low mask run), with the
    halo and offsets of an inner shard, and times of both. Each shard holds
    one barcode over G_pad / 4 sites, the shapes of phase 14's shards."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.ops.model import make_model
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    t0 = time.perf_counter()
    layout = build_layout(genome, n_barcodes=2, align_chunks=4)
    eng = ShardedRunsEngine(layout, make_mesh([dev] * 8, barcode_shards=2), make_model(ploidy=2))
    Gl = eng.Gl
    rng = np.random.default_rng(13)
    # every read in a 2 Mb window across the edge of genome shards 0 and 1:
    # ~3.5x per barcode and step, so the buckets there switch on in step 2
    batches = chrom_batches(rng, layout, 2, (Gl - 1_000_000, Gl + 1_000_000), 1.0, 2)
    target = next(i for i, sh in enumerate(eng.shards) if (sh.b, sh.g) == (1, 1))
    log(f"H8 check: {layout.G_pad} sites, mesh {eng.mesh.shape}, shard (1, 1): Gl {Gl}, "
        f"Gdl {eng.Gdl}, halo {eng.halo}, g0 {eng.shards[target].g0}; set up in "
        f"{time.perf_counter() - t0:.1f} s")
    state = eng.init_state()
    params = eng.make_params(CCL, TIME_COST)
    state, _ = eng.step(state, batch_from_numpy(batches[0], dev), params)
    probe = ShardProbe([target])
    eng.probe = probe
    state, aux = eng.step(state, batch_from_numpy(batches[1], dev), params)
    eng.probe = None
    torch.cuda.synchronize()
    ah = eng.pull_aux(aux)
    seen = sorted({(n, ph) for n, ph, _ in probe.calls})
    if len(seen) != 1 + 4 + 5:
        raise AssertionError(f"H8 check: phases seen {seen}")
    res = {}
    for k in SHARD_KERNELS:
        res[k] = dict(ms=probe.ms[k], plain_ms=probe.plain_ms[k], max_abs_err=probe.err[k],
                      device_ms=probe.device_ms[k],
                      split={} if k in probe.split_missing else probe.split[k],
                      **bound(probe.bytes(k)))
        log(f"H8 {k} (shard (1, 1), all phases): exact vs plain"
            f"{'' if k == 'shard_coverage' else ' (f64 sums of non-integers within rtol 1e-12 + 256 eps of the total)'}"
            f", max abs err {probe.err[k]:.3g}; kernel {probe.ms[k]:.4f} ms (device "
            f"{res[k]['device_ms']:.4f} ms), plain {probe.plain_ms[k]:.4f} ms, bound "
            f"{res[k]['bound_ms']:.4f} ms ({res[k]['bytes']} bytes) [{card}]")
        log(f"device split {k} (phase:launch ms): {fmt_split(res[k]['split'])}")
    h2 = probe.scores
    log(f"H2 site_scores at the shard (Gl {Gl}, ploidy 2, sparse): kernel {h2['ms']:.4f} ms, "
        f"device {h2['device_ms']:.4f} ms ({fmt_split(h2['split'])}), {fmt_score_bound(h2)} "
        f"[{card}]")
    dense_scores(probe.score_kw, card)
    log(f"H8 check state: any_on={ah.any_on} updated={ah.updated} threshold={ah.threshold!r}")
    if not ah.any_on:
        raise AssertionError("H8 check: buckets never switched on")
    return res


#: sites of the dense shard that the plain version scores (its [genotypes,
#: sites] f32 temporaries at 62M sites would not fit the card)
DENSE_SLICE = 8_000_000


def dense_coverage(seq: torch.Tensor, seed: int) -> torch.Tensor:
    """[1, 5, G] uint16 coverage in which every site has covsum 1-29
    (unfrozen, nonzero), each count on the reference symbol with p 0.9 and
    on one of the other four symbols otherwise: the mid-run state of an
    experiment, where every site needs the full contraction. From numpy,
    seeded."""
    rng = np.random.default_rng(seed)
    G = seq.shape[0]
    total = rng.integers(1, 30, G)
    n_ref = rng.binomial(total, 0.9)
    rest = total - n_ref
    ref = seq.cpu().numpy().astype(np.int64)
    sites = np.arange(G)
    cov = np.zeros((5, G), np.uint16)
    cov[ref, sites] = n_ref
    for k in range(4):  # the other symbols, in plane order, split the rest evenly
        o = rng.binomial(rest, 1.0 / (4 - k)) if k < 3 else rest
        rest = rest - o
        cov[k + (k >= ref), sites] = o
    return torch.from_numpy(cov[None]).to(seq.device)


def dense_scores(kw: dict, card: str) -> dict:
    """H2 on phase 13's shard with dense coverage (``dense_coverage``):
    timed at the whole shard, held against its plain version on its first
    DENSE_SLICE sites, and the whole shard's first sites equal to the
    kernel's own result on the slice (a per-site function)."""
    from bossruns_torch.ops import scores as sc

    t0 = time.perf_counter()
    args = dict(kw, coverage=dense_coverage(kw["seq"], 16))
    log(f"dense shard coverage: {args['coverage'].shape[-1]} sites made in "
        f"{time.perf_counter() - t0:.1f} s")
    s_k, c_k = sc.site_scores(**args)
    n = DENSE_SLICE
    part = dict(args, coverage=args["coverage"][:, :, :n].contiguous(),
                seq=args["seq"][:n].contiguous(), site_valid=args["site_valid"][:n].contiguous())
    s_s, c_s = sc.site_scores(**part)
    s_p, c_p = sc.site_scores_plain(**part)
    exact("H2 dense covsum", c_s, c_p)
    exact("H2 dense whole shard vs slice", s_k[:, :n], s_s)
    if not bool(((c_k > 0) & (c_k < args["freeze_cov"])).all()):
        raise AssertionError("dense shard: a site is empty or frozen")
    # up to 29 counts a site: the f32 log-likelihoods reach ~60, whose
    # rounding moves the posterior; the bar of the port's f32 score tests
    # (tests/test_torch_scores.py: each f32 version lands up to ~3e-5 from
    # f64 at 40 counts per symbol)
    err = (s_s - s_p).abs()
    if not bool((err <= 5e-5 + 1e-5 * s_p.abs()).all()):
        raise AssertionError(f"H2 dense scores outside rtol 1e-5 / atol 5e-5: max err "
                             f"{float(err.max())}")
    del s_p, c_p, part
    res = dict(ms=time_ms(lambda: sc.site_scores(**args), reps=5, warm=1),
               **device(lambda: sc.site_scores(**args), reps=5, warm=1),
               **score_bound(args, s_k, c_k), max_abs_err=float(err.max()))
    log(f"H2 site_scores at the shard, dense (covsum 1-29 everywhere): first {n} sites within "
        f"rtol 1e-5 / atol 5e-5 of the plain version (max abs err {res['max_abs_err']:.3g}), "
        f"covsum exact; kernel {res['ms']:.4f} ms, device {res['device_ms']:.4f} ms "
        f"({fmt_split(res['split'])}), {fmt_score_bound(res)} [{card}]")
    return res


def _run_engine(make, batches, dev) -> dict:
    """Build an engine with ``make()`` and step it over device batches:
    per-step host-clock times (step + aux pull), per-step aux and
    thresholds, and its peak memory (constants, state and the steps'
    scratch) above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = make()
    params = eng.make_params(CCL, TIME_COST)
    state = eng.init_state()
    times, auxes = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = eng.step(state, b, params)
        ah = eng.pull_aux(aux)
        times.append((time.perf_counter() - t0) * 1000.0)
        auxes.append((aux.vec.clone(), float(aux.threshold), ah))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    return dict(engine=eng, state=state, times=times, auxes=auxes, peak=peak)


def coverage_checksum(parts) -> int:
    """Sum over sites of coverage * (site % 1021 + 1) in int64 (a checksum
    that moves with any count at any position)."""
    total = 0
    for cov, g0 in parts:
        w = (torch.arange(cov.shape[-1], device=cov.device, dtype=torch.int64) + g0) % 1021 + 1
        total += int(((cov.view(torch.int16).to(torch.int64) & 0xFFFF) * w).sum())
    return total


def compare_engines(what: str, s_res, m_res) -> None:
    """Every state field and every step's aux and threshold, bit for bit."""
    sharded = m_res["engine"]
    for i, ((v1, t1, _), (v2, t2, _)) in enumerate(zip(s_res["auxes"], m_res["auxes"])):
        if t1 != t2 or not torch.equal(v1, v2):
            raise AssertionError(f"{what} step {i}: threshold {t2!r} vs single {t1!r}, "
                                 f"aux {v2.tolist()} vs {v1.tolist()}")
    ss, ms = s_res["state"], m_res["state"]
    for i, sh in enumerate(sharded.shards):
        for k, idx in sharded._blocks(sh.b, sh.g).items():
            exact(f"{what} {k} shard {(sh.b, sh.g)}", getattr(ms, k)[i], getattr(ss, k)[idx])


def run_chromosome(dev, card: str, genome: dict) -> dict:
    """Phase 14: the sharded engine on a (1, 4) in-process mesh, all shards
    on the card, against the single-device engine at human-chr1 scale
    (248,956,422 sites, ploidy 2, one barcode): bit-identical decisions,
    threshold and coverage; step p50 and peak memory of each engine."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs import RunsEngine
    from bossruns_torch.ops import kernels
    from bossruns_torch.ops.model import make_model
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    t0 = time.perf_counter()
    layout = build_layout(genome, n_barcodes=1, align_chunks=4)
    Gl = layout.G_pad // 4
    rng = np.random.default_rng(14)
    # 3/4 of the reads in a 6 Mb window across the edge of shards 0 and 1
    batches = [batch_from_numpy(b, dev) for b in
               chrom_batches(rng, layout, N_CHR_STEPS, (Gl - 3_000_000, Gl + 3_000_000), 0.75, 1)]
    params_model = make_model(ploidy=2)
    log(f"chromosome: {layout.G_pad} sites ({CHR1_SITES} real, 2 contigs), ploidy 2, "
        f"{N_CHR_STEPS} batches of {N_READS} reads; tile-aligned shards: "
        f"{(layout.Gd_pad // 4) % 4096 == 0}; set up in {time.perf_counter() - t0:.1f} s")
    kernels.reset_launches()
    s_res = _run_engine(lambda: RunsEngine(layout, params_model, device=dev), batches, dev)
    single_launches = kernels.launches()
    kernels.reset_launches()
    m_res = _run_engine(lambda: ShardedRunsEngine(layout, make_mesh([dev] * 4), params_model),
                        batches, dev)
    launches = kernels.launches()
    sharded = m_res["engine"]
    compare_engines("chromosome", s_res, m_res)
    ck1 = coverage_checksum([(s_res["state"].coverage, 0)])
    ck4 = coverage_checksum([(c, sh.g0) for c, sh in zip(m_res["state"].coverage,
                                                          sharded.shards)])
    if ck1 != ck4:
        raise AssertionError(f"chromosome coverage checksum {ck4} != {ck1}")
    last = m_res["auxes"][-1][2]
    if not any(a[2].updated for a in m_res["auxes"]):
        raise AssertionError("chromosome: the strategy never updated")
    out = {}
    for name, r in (("single", s_res), ("sharded (1, 4)", m_res)):
        out[name] = dict(p50=statistics.median(r["times"]), peak=r["peak"])
        log(f"chromosome {name}: step p50 {out[name]['p50']:.2f} ms (steps "
            f"{', '.join(f'{t:.1f}' for t in r['times'])} ms, host clock incl. aux pull), peak "
            f"memory {r['peak'] / 2**30:.2f} GiB above resident [{card}]")
    log(f"chromosome: sharded == single bit for bit over {N_CHR_STEPS} steps (coverage "
        f"checksum {ck1}, zeroed, bucket_on, read_starts, strat, aux, threshold "
        f"{last.threshold!r}); updated={last.updated}")
    shard_counts = {k: launches[k] for k in (*SHARD_KERNELS, "site_scores")}
    log(f"chromosome sharded run: kernel launches {shard_counts}")
    if min(shard_counts.values()) <= 0:
        raise AssertionError(f"a kernel of the sharded chromosome run never launched: {launches}")
    if any(launches[k] for k in ("coverage_update", "row_stage", "benefit_strategy")):
        raise AssertionError(f"the sharded engine launched a single-device entry point: {launches}")
    # the step's device time by launch: two more steps of each engine, after
    # the checks and the launch count, under the profiler
    for name, r in (("single", s_res), ("sharded (1, 4)", m_res)):
        eng, st = r["engine"], r["state"]
        params = eng.make_params(CCL, TIME_COST)
        split = device_split(lambda: eng.pull_aux(eng.step(st, batches[-1], params)[1]),
                             reps=2, warm=0, band=(0.85 * min(r["times"]), 1.05 * max(r["times"])))
        out[name].update(device_ms=None if split is None else split_ms(split), split=split)
        if split is not None:
            log(f"chromosome {name}: step device time {out[name]['device_ms']:.3f} ms by launch: "
                f"{fmt_split(split)} [{card}]")
    # H1 and H2 at the single engine's shape: launches in its 4 checked
    # steps, device time per call (queued events, on a copy of the state the
    # runs leave and the last batch) and the bounds of those inputs
    # (coverage_bound, score_bound)
    from bossruns_torch.ops import genome_ops as gops
    from bossruns_torch.ops import scores as sc

    eng, st, b = s_res["engine"], s_res["state"], batches[-1]
    rows = gops.CovRows(b.mr_bc, b.mr_g, b.mr_len, b.ex_bcsym, b.ex_g)
    cargs = eng.coverage_args(st._replace(coverage=st.coverage.clone()), rows)
    h1 = coverage_bound(rows, eng.seq, gops.coverage_update(**cargs), st.coverage,
                        cargs["coverage"])
    h1_ms = queued_ms(lambda: gops.coverage_update(**cargs))
    del cargs
    args = eng.score_args(st)
    h2 = score_bound(args, *sc.site_scores(**args))
    h2_ms = queued_ms(lambda: sc.site_scores(**args))
    log(f"chromosome single, H1 coverage_update: {single_launches['coverage_update']} launches, "
        f"device {h1_ms:.4f} ms, bound {h1['bound_ms']:.4f} ms by bytes ({h1['bytes']} B, "
        f"{h1['entries_changed']} coverage entries changed) [{card}]")
    log(f"chromosome single, H2 site_scores: {single_launches['site_scores']} launches, device "
        f"{h2_ms:.4f} ms, {fmt_score_bound(h2)} [{card}]")
    del s_res, m_res, sharded
    torch.cuda.empty_cache()
    return dict(out, launches=launches)


def run_mesh_paths(dev, card: str, work: Path, paths: dict, sl: dict) -> None:
    """Phase 15: the (2, 2) mesh with two barcodes on the 8.05 Mb genome
    against the single engine, and BossRunsSim(mesh_shards=(1, 4)) over the
    corpus against the unsharded sims of phase 4 (gated == classic there)."""
    from bossruns_torch.io.coo_native import pad_split, split_runs
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs import RunsEngine
    from bossruns_torch.models.runs_sim import BossRunsSim
    from bossruns_torch.ops import kernels
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh
    from bossruns_torch.utils.misc import read_strategy_npz

    rng = np.random.default_rng(15)
    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in GENOME.items()}
    layout = build_layout(contigs, n_barcodes=2, align_chunks=2)
    batches = []
    lens = layout.lengths
    for _ in range(3):
        cid = rng.choice(len(lens), N_READS, p=lens / lens.sum())
        rlen = np.clip(rng.normal(MEAN_LEN, 2000, N_READS), 400, 20000).astype(np.int64)
        rstart = (layout.offsets[cid] + rng.random(N_READS) * (lens[cid] - rlen)).astype(np.int64)
        pos = np.concatenate([s0 + np.arange(n) for s0, n in zip(rstart, rlen)])
        sym = layout.seq_int[pos].astype(np.int8)
        flip = rng.random(pos.shape[0]) < 0.05
        sym[flip] = rng.integers(0, 5, int(flip.sum()))
        split = split_runs(layout, sym, np.full(pos.shape[0], 40, np.int8), rstart,
                           rlen.astype(np.int32), rng.integers(0, 2, N_READS).astype(np.int32))
        batches.append(batch_from_numpy(dict(
            pad_split(split), rs_row=rng.integers(0, layout.n_fhat, N_READS).astype(np.int32),
            rs_strand=rng.integers(0, 2, N_READS).astype(np.int32),
            rs_w=np.ones(N_READS, np.float32)), dev))
    s_res = _run_engine(lambda: RunsEngine(layout, device=dev), batches, dev)
    m_res = _run_engine(lambda: ShardedRunsEngine(layout, make_mesh([dev] * 4, barcode_shards=2)),
                        batches, dev)
    compare_engines("(2, 2) mesh", s_res, m_res)
    ah = m_res["auxes"][-1][2]
    log(f"(2, 2) mesh, 2 barcodes, 8.05 Mb: == single engine bit for bit over 3 steps "
        f"(threshold {ah.threshold!r}, updated={ah.updated}); step p50 "
        f"{statistics.median(m_res['times']):.2f} ms vs single "
        f"{statistics.median(s_res['times']):.2f} ms [{card}]")
    del s_res, m_res

    sim = BossRunsSim(ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
                      paf_trunc=paths["paf_trunc"], name="mesh", batchsize=N_READS,
                      maxb=N_BATCHES, out_base=work / "mesh", mesh_shards=(1, 4), device=dev)
    if sim._gated or not isinstance(sim.engine, ShardedRunsEngine):
        raise AssertionError("the mesh sim must run the sharded engine in the classic flow")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for i, snap in enumerate(sl["snaps"]):
        sim.process_batch()
        got = sim.engine.state_numpy(sim.state, ("coverage", "strat", "read_starts"))
        for k, key in (("coverage", "cov"), ("strat", "strat"), ("read_starts", "rs")):
            if not np.array_equal(got[k], snap[key].cpu().numpy()):
                raise AssertionError(f"mesh sim {k}, batch {i}: != unsharded sim")
        if (sim.read_cache.time_boss, sim.read_cache.time_control) != (snap["tb"], snap["tc"]):
            raise AssertionError(f"mesh sim pseudotime, batch {i}")
        if sim._last_decisions != snap["dec"]:
            raise AssertionError(f"mesh sim decisions, batch {i}")
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches = kernels.launches()
    masks = read_strategy_npz(sim.out_dir / "masks" / "boss.npz")
    ref = read_strategy_npz(work / "gated" / "out_gated" / "masks" / "boss.npz")
    if set(masks) != set(ref) or any(not np.array_equal(masks[k], ref[k]) for k in ref):
        raise AssertionError("mesh sim masks != unsharded sim masks")
    shard_counts = {k: launches[k] for k in (*SHARD_KERNELS, "site_scores")}
    log(f"mesh sim (1, 4): {N_BATCHES} batches of {N_READS} reads in {sim_s:.2f} s == "
        f"unsharded sim exactly (coverage, strat, read_starts, pseudotime, decisions, masks); "
        f"shard kernel launches {shard_counts}; phase p50 ms {json.dumps(sim.phase_p50_ms())} "
        f"[{card}]")
    if min(shard_counts.values()) <= 0:
        raise AssertionError(f"a kernel of the mesh sim never launched: {launches}")
    if any(launches[k] for k in ("coverage_update", "row_stage", "benefit_strategy")):
        raise AssertionError(f"the mesh sim launched a single-device entry point: {launches}")
    sim.cleanup()


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


def parse_phases(argv: list[str]) -> set[int]:
    """``--phases 3,13,14``: run only those phases (a timing run, which
    prints no kernel table and no ok line). Default: every phase."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="", help="comma-separated phase numbers (3-15)")
    a = ap.parse_args(argv)
    phases = {int(x) for x in a.phases.split(",") if x} or set(range(3, 16))
    if not phases <= set(range(3, 16)):
        ap.error(f"phases are 3-15, got {sorted(phases)}")
    if 15 in phases and 4 not in phases:
        ap.error("phase 15 compares against the sims of phase 4")
    if 12 in phases and 11 not in phases:
        ap.error("phase 12 runs on the corpus of phase 11")
    return phases


def main(argv: list[str]) -> int:
    global SM_CLOCK_MHZ
    phases = parse_phases(argv)
    full = phases == set(range(3, 16))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from bossruns_torch.device import require_cuda
    from bossruns_torch.ops import kernels

    dev = require_cuda()
    # the plain versions run on the card too: keep f32 matmuls and
    # convolutions out of TF32 (the plain scores use no matmul at all)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    SM_CLOCK_MHZ = sm_clock_mhz()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    log(f"card: {card}; highest SM clock {SM_CLOCK_MHZ:.0f} MHz")
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {so.name}")

    res, sl, live, aeons, chrom = {}, None, None, None, None
    if 3 in phases:
        res = check_kernels(dev, card)
    with tempfile.TemporaryDirectory(prefix="bossruns_smoke_") as tmp:
        work = Path(tmp)
        from bossruns_torch.utils.datagen import write_corpus

        if phases & set(range(4, 9)):
            t0 = time.perf_counter()
            paths = write_corpus(work / "data", rng=np.random.default_rng(3),
                                 contig_lengths=GENOME, n_reads=N_READS * (N_BATCHES + 1),
                                 mean_len=float(MEAN_LEN))
            log(f"corpus: {sum(GENOME.values())} sites, {N_READS * (N_BATCHES + 1)} reads, "
                f"written in {time.perf_counter() - t0:.1f} s")
            seqs = read_corpus_reads(paths, N_READS)
        if 4 in phases:
            sl = run_slice(dev, card, work, paths)
        if 5 in phases:
            res["seed_topn"] = check_seed_kernel(dev, card, paths, seqs)
        if 6 in phases:
            check_aligner(dev, card, paths, seqs)
        if 7 in phases:
            live = run_live_align_sim(dev, card, work, paths)
        if 8 in phases:
            run_live_experiment(dev, work, paths)
        if 9 in phases:
            res["seed_candidates"] = check_ava(dev, card)
        if 10 in phases:
            res["aeons_strategy"] = check_aeons_strategy(dev, card)
        if 11 in phases:
            aeons = run_aeons_sim(dev, card, work)
        if 12 in phases:
            run_aeons_live(dev, card, work, aeons["paths"])
        if phases & {13, 14}:
            t0 = time.perf_counter()
            genome = chrom_genome(np.random.default_rng(12))
            log(f"chromosome genome: {CHR1_SITES} sites made in {time.perf_counter() - t0:.1f} s")
            if 13 in phases:
                res.update(check_shard_kernels(dev, card, genome))
            if 14 in phases:
                chrom = run_chromosome(dev, card, genome)
            del genome
        if 15 in phases:
            run_mesh_paths(dev, card, work, paths, sl)
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu")]
    if loaded:
        raise AssertionError(f"the JAX package or jax was imported: {loaded[:5]}")
    if not full:
        log(f"phases {sorted(phases)} done (a timing run: no kernel table, no ok line)")
        return 0

    meta = {
        "coverage_update": ("csrc/coverage.cu", "bossruns_tpu/models/runs.py:518"),
        "site_scores": ("csrc/scores.cu", "bossruns_tpu/ops/scores.py:102"),
        "row_stage": ("csrc/rows.cu", "bossruns_tpu/models/runs.py:592"),
        "benefit_strategy": ("csrc/strategy.cu", "bossruns_tpu/ops/genome_ops.py:88"),
        "seed_topn": ("csrc/seed.cu", "bossruns_tpu/aligner/seed.py:273"),
        "seed_candidates": ("csrc/seed.cu", "bossruns_tpu/aligner/seed.py:410"),
        "aeons_strategy": ("csrc/aeons_strategy.cu", "bossruns_tpu/aeons/benefit.py:53"),
        "shard_coverage": ("csrc/coverage.cu", "bossruns_tpu/parallel/mesh.py:209"),
        "shard_rows": ("csrc/rows.cu", "bossruns_tpu/parallel/mesh.py:209"),
        "shard_benefit": ("csrc/strategy.cu", "bossruns_tpu/parallel/mesh.py:209"),
    }
    # H1-H4 count the gated sim's launches (path 4), H5 the live-alignment
    # sim's (path 7), H6 and H7 the AEONS sim's (path 11), H8 the sharded
    # chromosome run's (path 14, whose shards have phase 13's shapes; the
    # mesh sim of path 15 is checked to launch H8 too). No single PyTorch
    # call computes any of these functions, so library_ms is null throughout.
    counts = dict(sl["launches"], seed_topn=live["launches"]["seed_topn"],
                  seed_candidates=aeons["launches"]["seed_candidates"],
                  aeons_strategy=aeons["launches"]["aeons_strategy"],
                  **{k: chrom["launches"][k] for k in SHARD_KERNELS})
    table = {"kernels": [
        {"name": k, "route": "cuda", "source": f"bossruns_torch/{src}", "replaces": rep,
         "launches": counts[k], "max_abs_err": res[k]["max_abs_err"],
         "ms": res[k]["ms"], "device_ms": res[k]["device_ms"], "plain_ms": res[k]["plain_ms"],
         "bound_ms": res[k]["bound_ms"], "bound_by": res[k]["bound_by"], "library_ms": None,
         "split": res[k]["split"]}
        for k, (src, rep) in meta.items()
    ]}
    for k in meta:
        log(f"bound {k}: {res[k]['bytes']} bytes -> {res[k]['bound_ms']:.4f} ms at 3.35 TB/s; "
            f"kernel {res[k]['ms']:.4f} ms, device {res[k]['device_ms']:.4f} ms")
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
