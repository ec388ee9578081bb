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
     median times of both (H2 called without flags: its launch over every
     site into new buffers); H2 also as the single engine calls it, into
     kept buffers on the tiles H1 flagged and with its rescore-all flag
     set, against the call without flags bit for bit and the plain
     version, with times and bounds;
  4. the slice: a synthetic 8.05 Mb corpus through the port's gated
     BossRunsSim (4000-read batches), checked for strategy activation,
     rejections, enrichment, mask shapes, kernel launch counts and a
     checkpoint; the classic flow on the same corpus must agree exactly;
  5. the seeding kernel H5 against its plain version on that corpus, both
     on the reads packed 4 bits a base and uploaded from pinned staging, at
     k13/w5 and k15/w10: the 4000 reads' 400-base prefixes (L=512) and
     the largest full-length bucket group, all 24 rows exact, with times;
  6. the aligner on the card against the host-seeded aligner: records
     byte-identical for 4000 reads (truncated and full passes), reads/s of
     both, and the truncated records' loci against the corpus's own PAF;
  7. the simulation with live alignment (no PAFs, classic flow): 6
     batches of 4000 reads through H5 and H1-H4, with the same checks as 4;
  8. the live experiment (BossRuns) over two 4000-read fastq files;
  9. the all-vs-all seeding kernel H6 against its plain version (the
     packed payload, as in 5) on a metagenome-sized working pool (2000
     reads of 5 kb, ~10 Mb): 500-read query batches at L=8192 and
     L=32768, all 48 entries of every row exact, with times, and
     find_overlaps on the card against host seeding (identical rows, times
     of both);
 10. the contig strategy kernel H7 against its plain version on bench.py's
     strat_triple pools (40 and 200 contigs of 200 kb, coverage 0-21 and
     0-29) and on one 5 Mb contig beside 2,000 one-chunk contigs:
     threshold, mask and benefit exact, with times of H7 (and its split by
     launch), the plain version and the f64 host path;
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
     time by launch; then H1, H2 and H4 at the single engine's shape
     (launches, device time, H4's split, bounds; H2 without flags, over
     the tiles the last batch's H1 call flagged and with every site,
     checked as in 3, the plain version on gathered sites), and H4's binning launch
     alone (shard_benefit's bins phase) on the step's own benefit and on a
     copy spread over 100 exponent bins, counts and fsum exact;
 15. a (2, 2) mesh with two barcodes on the 8.05 Mb genome against the
     single engine, and BossRunsSim(mesh_shards=(1, 4)) over the corpus
     of phase 4 against the unsharded sims (6 batches, every bit);
 16. decisions against the port's own f64 oracle: the engine at phase 3's
     shape for 4 steps, strat, bucket_on, read_starts and coverage equal
     to bossruns_torch.oracle.full_update given the engine's scores, bit
     for bit, after every step; the step p50 beside the host clock's
     full_update p50 on the same inputs and their ratio; then the zymo
     conformance drive (12.6 Mb, 9 contigs, 3 batches of 12,000 reads:
     exact vs the drift-free oracle on every batch, agreement with the
     bug-compatible oracle >= 0.996) and the dataplane drive (12.6 Mb,
     haploid, 2 batches of 6000 reads through the classic sim: coverage
     bit-exact, agreement >= 0.996);
 17. the readfish side and data preparation: ``python -m
     bossruns_torch.prepare`` on the card over phase 4's corpus, its PAFs
     and offsets equal line for line to the same entry's on the CPU, a sim
     of 2 batches over them; the port's Analysis with
     TorchMapperPlugin on the card over the first 400 bases of 4000
     corpus reads, every decision equal to make_decision on the CPU
     plugin's alignments, and an all-false mask's hot reload turning the
     next batch's mapped chunks to unblock (reads/s and chunks/s);
 18. the engine options (RunsConfig fhat_alpha=1.7, dtype="float64",
     benefit_dtype="float32" and both dtypes): at phase 3's shape each
     option's engine for 4 counted steps beside the default, the steps
     taken in turns (host-clock p50 and the device time of one step), and
     each kernel variant against its plain version with
     times and bounds (H2 with f64 tables within rtol 1e-12; H3 exact but
     for fhat_exp's f32 rounding and a general alpha's fhat weights, rtol
     1e-13; H4's f32 path exact given its own benefit and, end to end,
     within one exponent bin of the plain version, differing cells
     counted); the f64-score engine against the port's oracle on the
     oracle's own f64 scores (0 differing valid cells asserted, the
     default's count printed beside it); fhat_alpha=1.7 against the
     oracle given its scores, bit for bit; the (2, 2) mesh under each
     option equal to the single engine, H8's variants timed on one
     shard; and, with phase 14's chromosome genome, the single engine's
     step p50 and peak memory with each dtype option and its strategy
     against the default's;
 19. dtype="float16" (with f64 and with f32 decisions): at phase 3's shape
     each engine for 4 counted steps beside the default, the steps in
     turns (host-clock p50, device ms of one step), and each half entry
     point against its plain version with times and bounds (H2 _h16 and
     H3 _h16 / _h16_d32 bit for bit, H4 with half aux); the f16 engine
     against the f16 plain path on the card over 4 steps (state exact,
     scores in f16 ulps); the (2, 2) mesh at f16 equal to the single
     engine, H8 _h16 timed on one shard; with phase 14's genome, the f16
     single engine's step p50 and peak memory and H2 _h16 on its state;
     and H2 _h16 against its plain version, bit for bit, on the
     adversarial model of tests/test_torch_f16.py (b), where the 15-term
     q dot's addition tree decides the last f16 bit (ROADMAP F15);
 20. the scoreboard and the tools: ``python -m bossruns_torch.bench``
     (every section, each in its own process; exit code 0, every record
     present, none skipped, failed or timed out, the headline first and
     last with vs_baseline > 1, zymo agreement >= 0.996; each section's
     wall seconds), then each ``python -m bossruns_torch.tools.<name>``
     at its default shape but check_sequencer_connection (which needs a
     sequencer), all in processes where jax and the JAX package cannot
     be imported and which report holding no module of either; the
     headline's engines must have replayed their captured step;
 21. the captured step (models/graphs.py: one CUDA graph per path and
     batch-shape tier, StepParams on the card) against the eager step
     body, in turns: at phase 3's shape each path (step, step_from_numpy,
     step_gated) and each engine option through step, and, with phase
     14's genome, the chr1 single engine and the (1, 4) in-process mesh;
     every step's state, strategy, aux and threshold bit for bit (16
     steps each), host-clock p50 of both (the first two of each left
     out), the device time of one step each way, the replay, eager and
     capture counts and capture ms, and at chr1 the peak memory of each
     mode over 3 steps from a fresh state;
 22. the seeding link (reads 4 bits a base, packed into pinned staging,
     one non-blocking copy a bucket): 4000 reads of mean 2,500 (sd 1,200)
     from phase 4's genome, over at least four length buckets, mapped on
     the card with a ~50 ms sleep queued on the stream just before the
     dispatch loop, the loop's host time (the staged payload's upload and
     every call's H5 launch before the first pull) held below 10% of the
     sleep, and the time to the first pull beside it; the batch's encode
     and pack in one pass by the library's host loop (bk_pack_rows) equal
     to NumPy's, codes and payload, with times of both; one 4096 x 512 bucket's
     packed, pinned upload against the int8 matrix's pageable copy,
     host clock, in turns; map_sequences p50 on the batch, its records
     equal to the plain seeding's on the card; the live-alignment sim's
     batch p50 (phase 7) and the readfish loop's chunks/s (phase 17)
     beside the numbers before the packed link. ``link_turn_main`` runs
     the part every version of the port can (dispatch check, map p50,
     live-alignment sim, readfish loop) for a comparison in turns with an
     earlier commit.
Phase 3 also holds RunsEngine.step_from_numpy (one uint32 wire upload)
equal to step on the card and times its pack + upload beside the
per-field upload that pack_batch(device=...) makes; phase 4's classic
sim steps through step_from_numpy and its gated sim ships pack_gated's
buffer, each counted.
Every engine step on the card goes through the graph cache (the sims
print their replayed and eager counts); the eager body runs only where
phase 21 holds a replay against it, and under the sharded engine's probe.
Each driven path (4, 7, 8, 11, 12, the sharded run of 14, 15, each run
of 16 and 17, and each option's engine and mesh run of 18 and 19) runs
with the launch counts set to 0 just before it and read just after. H2's bound is
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

from bossruns_torch.utils.profiling import device_split, queued_ms, time_ms

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


def device(fn, reps: int = 10, warm: int = 2) -> dict:
    """``device_ms`` of one fn() call from ``queued_ms`` and its split by
    launch from ``device_split``, whose sum must lie within 25-110% of the
    queued time: the queued time also holds the gaps between launches,
    which take half to two thirds of a phase of a few short launches (H8's
    row and benefit phases, ~0.01 ms each on an NVIDIA H100 80GB HBM3 at
    700 W)."""
    ms = queued_ms(fn, reps, warm)
    split = device_split(fn, reps, 0, band=(0.25 * ms, 1.1 * ms + 0.002), log=log)
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
    split = device_split(fn, reps, 0, band=(0.7 * ms, None), log=log)
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


#: f64 rate outside the tensor cores of one H100 SXM (NVIDIA's H100 data
#: sheet, 700 W)
F64_FLOP_PER_MS = 34e12 / 1e3


def score_bound(args: dict, scores, covsum, sel=None, tiles=None) -> dict:
    """H2's bound for these inputs: the larger of the byte bound (each input
    read once, scores and covsum written once) and the arithmetic of the
    sites that need the contraction (a nonzero count among the model's
    symbols, unfrozen, valid). With ``sel`` (bool [G], the sites of the
    tiles H1 flagged) and ``tiles`` (the flags): the bound of a call over them,
    which counts the bytes and the arithmetic of the selected sites only
    and the flags read once. Per contracted site: 2 LB LG + LG + LB FMAs (the two contractions,
    the k and q log q sums) and LG + LB + 2 special-function operations
    (an exponential per genotype for the log-sum-exp, a log per symbol, the
    log of the sum and its reciprocal) per such site. The posterior can
    come from the log-sum-exp's own terms (e_j / se), so the kernel's second
    exponential pass, exp(lp - lse), which it keeps to round as the plain
    version does, is not counted. Every other site's score is one of four
    constants and costs no arithmetic. With f64 tables (dtype="float64")
    the FMAs run at the f64 rate and each exponential or log, a sequence of
    f64 FMAs in software on this card, counts as one f64 operation (a
    floor of its cost)."""
    t = args["tables"]
    LB, LG = t.len_b, t.len_g
    cov = args["coverage"]
    nz = (cov[:, :LB].view(torch.int16) != 0).any(dim=1)
    need = nz & (covsum < args["freeze_cov"]) & args["site_valid"][None, :]
    moved = nbytes(args) + nbytes(scores, covsum)
    sites = int(need.numel())
    if sel is not None:
        G = cov.shape[-1]
        per_site = nbytes(cov, args["seq"], args["site_valid"], scores, covsum) // G
        n_sel = int(sel.sum())
        need &= sel[None, :]
        moved += per_site * (n_sel - G) + nbytes(tiles)
        sites = cov.shape[0] * n_sel
    n = int(need.sum())
    by = bound(moved)
    f64 = t.dtype == torch.float64
    if f64:
        fma_ms = (2 * (2 * LB * LG + LG + LB) + LG + LB + 2) * n / F64_FLOP_PER_MS
        sfu_ms = 0.0
    else:
        fma_ms = 2 * (2 * LB * LG + LG + LB) * n / F32_FLOP_PER_MS
        sfu_ms = (LG + LB + 2) * n / (N_SMS * SFU_PER_SM_CLOCK * SM_CLOCK_MHZ * 1e3)
    ops_ms = max(fma_ms, sfu_ms)
    out = dict(by, n_contract=n, sites=sites, byte_ms=by["bound_ms"],
               fma_ms=fma_ms, sfu_ms=sfu_ms, f64=f64)
    if ops_ms > by["bound_ms"]:
        out.update(bound_ms=ops_ms, bound_by="operations")
    return out


def fmt_score_bound(b: dict) -> str:
    if b.get("f64"):
        ops = f"f64 FMAs and exp/log {b['fma_ms']:.4f} ms at 34 TFLOP/s"
    else:
        ops = (f"FMAs {b['fma_ms']:.4f} ms, special functions {b['sfu_ms']:.4f} ms at "
               f"{SM_CLOCK_MHZ:.0f} MHz")
    return (f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes {b['byte_ms']:.4f} ms for "
            f"{b['bytes']} B; {b['n_contract']} of {b['sites']} sites contracted: {ops})")


def check_tiled_scores(what: str, args: dict, tiles, fresh, plain_chunk: int = 0,
                       atol: float = 1e-6) -> dict:
    """H2 as the single engine calls it, against the call without flags
    ``fresh`` (scores, covsum: every site into new buffers) and its plain
    version on the same inputs and H1's tile flags ``tiles``, into kept
    buffers that hold a sentinel: with ``full`` clear the flagged tiles'
    sites equal ``fresh`` bit for bit and every other site keeps the
    sentinel; with ``full`` set every site equals it. The plain version, given the same
    ``out``, ``tiles`` and ``full`` (or, with ``plain_chunk``, on the
    selected sites gathered that many at a time, where the whole genome's
    temporaries would not fit), agrees within H2's f32 tolerance (rtol
    1e-5, ``atol``) on the rescored sites, covsum exact, and leaves the
    same sentinel. Then each
    mode's device time (queued events) and bound: the tiled one counts
    the flagged tiles' sites only (``score_bound``)."""
    from bossruns_torch.ops import scores as sc

    s_d, cs_d = fresh
    nb, G = cs_d.shape
    dev = cs_d.device
    flags = {m: torch.full((1,), int(m == "full"), dtype=torch.int32, device=dev)
             for m in ("tiled", "full")}
    sel = sc.tile_mask(tiles, flags["tiled"], G)
    sentinel = lambda: (torch.full_like(s_d, -7.0), torch.full_like(cs_d, -1))
    out = dict(tiles=int((tiles != 0).sum()), n_tiles=int(tiles.numel()))
    err = 0.0
    for mode in ("tiled", "full"):
        kept = sentinel()
        sc.site_scores(**args, out=kept, tiles=tiles, full=flags[mode])
        if mode == "tiled":
            exact(f"H2 {what} tiled scores (sentinel outside the flagged tiles)", kept[0],
                  torch.where(sel[None, :], s_d, torch.full_like(s_d, -7.0)))
            exact(f"H2 {what} tiled covsum (sentinel outside the flagged tiles)", kept[1],
                  torch.where(sel[None, :], cs_d, torch.full_like(cs_d, -1)))
        else:
            exact(f"H2 {what} kept buffers with full set, scores", kept[0], s_d)
            exact(f"H2 {what} kept buffers with full set, covsum", kept[1], cs_d)
        if plain_chunk:
            idx = sel.nonzero()[:, 0] if mode == "tiled" else torch.arange(G, device=dev)
            pieces = idx.split(plain_chunk)
        else:
            kp = sentinel()
            sc.site_scores_plain(**args, out=kp, tiles=tiles, full=flags[mode])
            exact(f"H2 {what} {mode}: plain covsum", kept[1], kp[1])
            pieces = [None]  # the sentinel's sites: -7 on both sides, inside the tolerance
        for ix in pieces:
            if ix is None:
                s_p, s_k = kp[0], kept[0]
            else:
                # uint16 has no gather on the card: gather its int16 view
                cov = args["coverage"].view(torch.int16)[:, :, ix].view(torch.uint16)
                a = dict(args, coverage=cov, seq=args["seq"][ix], site_valid=args["site_valid"][ix])
                s_p, cs_p = sc.site_scores_plain(**a)
                exact(f"H2 {what} {mode}: plain covsum", kept[1][:, ix], cs_p)
                s_k = kept[0][:, ix]
            e = (s_k - s_p).abs()
            if not bool((e <= atol + 1e-5 * s_p.abs()).all()):
                raise AssertionError(f"H2 {what} {mode}: scores outside rtol 1e-5 / atol {atol} "
                                     f"of the plain version: max err {float(e.max())}")
            err = max(err, float(e.max()) if e.numel() else 0.0)
        del kept
    kept = sentinel()
    for mode in ("tiled", "full"):
        ms = queued_ms(lambda: sc.site_scores(**args, out=kept, tiles=tiles, full=flags[mode]))
        b = (score_bound(args, *kept, sel=sel, tiles=tiles) if mode == "tiled"
             else score_bound(args, *kept))
        out[mode] = dict(b, device_ms=ms)
    out["max_abs_err"] = err
    log(f"H2 {what}, kept buffers: {out['tiles']} of {out['n_tiles']} tiles flagged by H1; "
        f"the flagged tiles equal the call without flags bit for bit and the rest keeps "
        f"the sentinel; with full set every site equals it; plain version "
        f"max abs err {err:.3g} (rtol 1e-5, atol {atol}), covsum and sentinel exact")
    for mode in ("tiled", "full"):
        log(f"H2 {what}, kept buffers ({'flagged tiles' if mode == 'tiled' else 'full set'}): "
            f"device {out[mode]['device_ms']:.4f} ms, {fmt_score_bound(out[mode])}")
    return out


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

    Everything is exact except the sums of non-integers (``_approx``),
    which other summation orders move by ulps of the running total: there
    the bar is rtol 1e-12 + 256 eps * the largest value for f64 (the bar of
    the H4 check), and for the f32 decision path's scan rtol 1e-6 + 4096
    eps * the largest value (a float sum of at most one 4096-row tile's
    non-negative terms, in another order); a general fhat_alpha adds the
    fhat weights (CUDA's lgamma and exp in the kernel, torch's in the plain
    version). Inputs of each phase are the engine's own, so the decision
    phases are compared exactly given equal inputs."""

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
    def _approx(name, phase, key, t, kw) -> bool:
        """The sums of non-integers, which other orders move by ulps: the
        benefit phases' scan, windows and bins, H3's fhat normaliser (a
        fixed-order block reduction against torch.sum) and, under a general
        fhat_alpha, the fhat weights."""
        if not t.is_floating_point():
            return False
        if name == "shard_benefit":
            return phase in ("scan", "prefix", "windows", "bins")
        if name != "shard_rows" or phase != "tables":
            return False
        return key == "scale" or (key == "fhat_w" and kw.get("fhat_alpha", 1.0) != 1.0)

    @staticmethod
    def _tol(y):
        """The bar of ``_approx``'s values for the plain version's y."""
        rtol, n = (1e-12, 256) if y.dtype == torch.float64 else (1e-6, 4096)
        return rtol * y.abs() + n * float(torch.finfo(y.dtype).eps) * float(
            y[~torch.isnan(y)].abs().max())

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
            pairs = [(k, v, a2[1][k], not self._approx(name, phase, k, v, kw))
                     for k, v in ws.items() if isinstance(v, torch.Tensor)]
            pairs += [(k, k1[k], k2[k], True) for k in SHARD_WRITES[name]]
            outs = [*ws.values(), *(kw.get(k) for k in SHARD_WRITES[name])]
        for k, x, y, want_exact in pairs:
            if want_exact:
                exact(f"{name} {phase} {k} (shard {i})", x, y)
            elif bool(differ(x, y).any()):
                d = differ(x, y)
                e = (x - y).abs()[d]
                tol = self._tol(y)[d]
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
    changed, tiles = gops.coverage_update_tiled(**eng.coverage_args(state, full))

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
    # the same inputs as the single engine calls H2, into kept buffers, on
    # the tiles this batch's H1 call flagged
    res["site_scores"]["modes"] = {"slice": check_tiled_scores("slice", args, tiles,
                                                               (s_k, cs_k))}

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

    res["_wire"] = check_wire(eng, state, batch, batch_np, params, card)

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


def host_ms(fn, reps: int = 15, warm: int = 2) -> float:
    """Median host-clock ms of fn() between two synchronizes."""
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(out)


def check_wire(eng, state, batch, batch_np, params, card: str) -> dict:
    """Phase 3: RunsEngine.step_from_numpy (the batch packed into one uint32
    buffer, uploaded in one copy, its fields viewed on the card) against
    step on the uploaded ReadBatch, from copies of one state, bit for bit;
    then the pack + upload time beside batch_from_numpy's per-field upload
    (what pack_batch(device=...) ends with), host clock."""
    from bossruns_torch.models.convert import batch_from_numpy

    s1, s2 = deep_clone(state), deep_clone(state)
    s1, a1 = eng.step(s1, batch, params)
    s2, a2 = eng.step_from_numpy(s2, batch_np, params)
    for k in s1._fields:
        exact(f"step_from_numpy {k}", getattr(s2, k), getattr(s1, k))
    exact("step_from_numpy aux", a2.vec, a1.vec)
    exact("step_from_numpy threshold", a2.threshold, a1.threshold)
    wire, spec = eng.pack_wire(batch_np)

    def wire_up():
        w, sp = eng.pack_wire(batch_np, out=eng.stage)
        return eng.unpack_wire(eng.upload_wire(w, sp), sp)

    def wire_pageable():
        w, sp = eng.pack_wire(batch_np)
        return eng.unpack_wire(torch.from_numpy(w).to(eng.device), sp)

    out = dict(wire_ms=host_ms(wire_up), pageable_ms=host_ms(wire_pageable),
               fields_ms=host_ms(lambda: batch_from_numpy(batch_np, eng.device)),
               wire_bytes=int(wire.nbytes))
    log(f"step_from_numpy == step on the card (state, aux, threshold bit for bit); pack into "
        f"pinned staging + one async upload into the tier's device wire of the "
        f"{out['wire_bytes']} B wire {out['wire_ms']:.3f} ms, the same pack into a new array + a "
        f"pageable upload {out['pageable_ms']:.3f} ms, vs the per-field upload of "
        f"pack_batch(device=...) {out['fields_ms']:.3f} ms (8 copies), host clock [{card}]")
    return out


def counting(obj, name: str, tally: dict) -> None:
    """Count the calls of obj.name (an instance attribute over the method)."""
    real = getattr(obj, name)

    def counted(*a, **kw):
        tally[name] = tally.get(name, 0) + 1
        return real(*a, **kw)

    setattr(obj, name, counted)


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
    g = sim.engine.graphs
    log(f"{what} steps: " + ("eager (no graph cache on this engine)" if g is None else
                             f"replayed {dict(g.replays)}, eager {dict(g.eager)}, "
                             f"{len(g.captures)} captures"))
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
    wire_calls = {}
    counting(gsim.engine, "pack_gated", wire_calls)
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
    counting(csim.engine, "step_from_numpy", wire_calls)
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
    if wire_calls.get("step_from_numpy") != N_BATCHES or wire_calls.get("pack_gated", 0) < N_BATCHES:
        raise AssertionError(f"the sims did not take the wire on every batch: {wire_calls}")
    log(f"wire: the classic sim stepped through step_from_numpy on all {N_BATCHES} batches, the "
        f"gated sim packed {wire_calls['pack_gated']} gated wires (one upload each)")
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
    """Phase 5: H5 against its plain version on the corpus reads, both on
    the 4-bit packed payload uploaded from the index's pinned staging."""
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
            (x,) = S.upload_reads([mat], di)   # packed, through the index's pinned staging
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
            # the function's own inputs (the packed reads) and outputs (not
            # the kernel's bucket table)
            r = res[(k, w, label)] = dict(ms=ms, plain_ms=plain_ms, **dv,
                                          shape=f"reads_packed int32{list(x.shape)}",
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


RECORD_FIELDS = ("qlen", "qstart", "qend", "rev", "tlen", "tstart", "tend", "nmatch",
                 "blocklen", "mapq", "align_score", "s1", "primary")


def same_records(a, b, what: str) -> None:
    """Raise unless two PafRecords are byte-identical."""
    if len(a) != len(b) or list(a.qname) != list(b.qname) or list(a.tname) != list(b.tname):
        raise AssertionError(f"{what}: record sets differ")
    for f in RECORD_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: field {f} differs")
    if any(x.dtype != y.dtype or not np.array_equal(x, y) for x, y in zip(a.cigars, b.cigars)):
        raise AssertionError(f"{what}: cigars differ")


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
        same_records(a, b, f"aligner {label}")
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
    batch_ms = []
    for _ in range(N_LIVE_BATCHES):
        tb = time.perf_counter()
        sim.process_batch()
        batch_ms.append(1000 * (time.perf_counter() - tb))
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches = kernels.launches()
    batch_p50 = statistics.median(batch_ms)
    log(f"live-alignment sim: {N_LIVE_BATCHES} batches of {N_READS} reads in {sim_s:.2f} s, "
        f"batch p50 {batch_p50:.1f} ms ({', '.join(f'{t:.1f}' for t in batch_ms)}); "
        f"launches {launches} [{card}]")
    if min(launches[k] for k in (*UPDATE_KERNELS, "seed_topn")) <= 0:
        raise AssertionError(f"a kernel of the live-alignment sim never launched: {launches}")
    check_sim(sim, "live-alignment sim")
    phase = sim.phase_p50_ms()
    log(f"live-alignment sim phase p50 ms: {json.dumps(phase)} [{card}]")
    sim.cleanup()
    return dict(launches=launches, phase=phase, batch_p50_ms=batch_p50)


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
        (x,) = S.upload_reads([mat], di)   # packed, through the index's pinned staging
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
        # the function's own inputs (the packed reads) and outputs (not the
        # kernel's bucket table)
        res[L] = dict(ms=ms, plain_ms=plain_ms, **dv, shape=f"reads_packed int32{list(x.shape)}",
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
    """A contig of n bases with random per-base coverage in [0, hi)."""

    def __init__(self, n: int, rng, hi: int):
        self.seq = "A" * n
        self.cov = rng.integers(0, hi, n).astype(np.float32)
        self.cap_l = self.cap_r = False


def strategy_pools(rng):
    """Phase 10's contig pools: bench.py's strat_triple pools (40 and 200
    contigs of 200 kb, coverage 0-21 and 0-29), keyed (n_contigs, hi), and
    "long": one 5 Mb contig (50,000 chunks) beside 2,000 one-chunk contigs
    (coverage 0-21), the longest dependent chain of the per-contig scan
    beside the most contigs."""
    for n_contigs in (40, 200):
        for hi in (22, 30):
            yield ((n_contigs, hi), f"{n_contigs * 200_000 // 1_000_000} Mb ({n_contigs} x 200 kb), "
                   f"coverage 0-{hi - 1}",
                   {f"u{j}": _PoolContig(200_000, rng, hi) for j in range(n_contigs)})
    pool = {"long": _PoolContig(5_000_000, rng, 22)}
    pool.update((f"t{j}", _PoolContig(100, rng, 22)) for j in range(2000))
    yield "long", "long (one 5 Mb contig + 2,000 x 100 b), coverage 0-21", pool


def check_aeons_strategy(dev, card: str) -> dict:
    """Phase 10: H7 against its plain version and the f64 host path."""
    from bossruns_torch.aeons import benefit as B

    ccl = np.array([20000, 14000, 10000, 7000, 5000, 3500, 2500, 1700, 900, 300])
    lam = 6000.0
    rng = np.random.default_rng(5)
    res, worst = {}, 0.0
    for key, what, pool in strategy_pools(rng):
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
        res[key] = dict(ms=ms, plain_ms=plain_ms,
                        **synced_device(lambda: B.strategy(*args), "aeons_strategy"),
                        **bound(nbytes(args) + nbytes(mk, bk)))
        log(f"H7 aeons_strategy {what}: threshold {tk!r} (host {th!r}), mask "
            f"({int(mk.sum())} of {mk.numel()} accepted) and benefit exact vs plain, equal to the "
            f"f64 host path; kernel {ms:.4f} ms (device {res[key]['device_ms']:.4f} ms, bound "
            f"{res[key]['bound_ms']:.4f} ms by bytes), plain {plain_ms:.4f} ms, host path "
            f"{1000 * statistics.median(hs):.2f} ms; contig_strategies device "
            f"{1000 * statistics.median(ed):.1f} ms, host {1000 * statistics.median(eh):.1f} ms "
            f"[{card}]")
        log(f"device split aeons_strategy {what} (launch ms): {fmt_split(res[key]['split'])}")
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
    """H2 on phase 13's shard with dense coverage (``dense_coverage``),
    called without flags as the sharded step calls it (every site into new
    buffers): timed at the whole shard, held against its plain version on its first
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


#: what a step p50 over a run's third step on leaves out
REPLAYED = "steps 1-2 are the shape tier's eager warm-up and its graph capture"


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
        out[name] = dict(p50=statistics.median(r["times"][2:]), peak=r["peak"])
        log(f"chromosome {name}: step p50 {out[name]['p50']:.2f} ms over the replayed steps "
            f"(steps {', '.join(f'{t:.1f}' for t in r['times'])} ms, host clock incl. aux pull; "
            f"{REPLAYED}), peak memory {r['peak'] / 2**30:.2f} GiB above resident [{card}]")
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
                             reps=2, warm=0, band=(0.85 * min(r["times"]), 1.05 * max(r["times"])),
                             log=log)
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
    if eng._full_host:
        raise AssertionError("chromosome single: the engine's last step rescored every site "
                             "(its steps on one state should rescore by tile after the first)")
    rows = gops.CovRows(b.mr_bc, b.mr_g, b.mr_len, b.ex_bcsym, b.ex_g)
    cargs = eng.coverage_args(st._replace(coverage=st.coverage.clone()), rows)
    changed, tiles = gops.coverage_update_tiled(**cargs)
    h1 = coverage_bound(rows, eng.seq, changed, st.coverage, cargs["coverage"])
    # H2 on the coverage after that call: without flags (the sharded
    # step's call, every site into new buffers), and as the single engine
    # calls it, on the tiles H1 flagged and with its rescore-all flag set
    args = eng.score_args(st._replace(coverage=cargs["coverage"]))
    fresh = sc.site_scores(**args)
    h2 = score_bound(args, *fresh)
    h2_ms = queued_ms(lambda: sc.site_scores(**args))
    log(f"chromosome single, H2 site_scores without flags: device {h2_ms:.4f} ms, "
        f"{fmt_score_bound(h2)} [{card}]")
    # the plain version on the sites gathered 16M at a time, at phase 13's
    # bar for H2 on a chromosome's coverage (atol 5e-5)
    h2_modes = check_tiled_scores("chromosome single", args, tiles, fresh, plain_chunk=1 << 24,
                                  atol=5e-5)
    h2_modes["flagless"] = dict(h2, device_ms=h2_ms)
    del args, fresh
    h1_ms = queued_ms(lambda: gops.coverage_update(**cargs))
    del cargs
    log(f"chromosome single, H1 coverage_update: {single_launches['coverage_update']} launches, "
        f"device {h1_ms:.4f} ms, bound {h1['bound_ms']:.4f} ms by bytes ({h1['bytes']} B, "
        f"{h1['entries_changed']} coverage entries changed) [{card}]")
    log(f"chromosome single, H2 site_scores: {single_launches['site_scores']} launches, tiled "
        f"{h2_modes['tiled']['device_ms']:.4f} ms over {h2_modes['tiles']} of "
        f"{h2_modes['n_tiles']} tiles (bound {h2_modes['tiled']['bound_ms']:.4f} ms), full set "
        f"{h2_modes['full']['device_ms']:.4f} ms (bound {h2_modes['full']['bound_ms']:.4f} ms), "
        f"without flags {h2_ms:.4f} ms [{card}]")
    h4 = chrom_benefit(eng, st, b, card, single_launches["benefit_strategy"])
    del s_res, m_res, sharded
    torch.cuda.empty_cache()
    return dict(out, launches=launches, benefit=h4, h2_modes=h2_modes)


#: exact powers of two 2^0 ... 2^-99 (scaling by one is exact)
SPREAD_BINS = 100


def chrom_benefit(eng, st, b, card: str, launches: int) -> dict:
    """H4 at the single engine's chromosome shape, on copies of the state
    the runs leave and their last batch: the stages before it (H1, H2, H3)
    give its inputs; then its device time per call, split by launch, and
    its byte bound. Then H4's binning launch alone, through shard_benefit's
    bins phase (one launch on both sides of a redesign), on this benefit
    and on a copy whose positive values are scaled by 2^-(i % 100), so they
    spread over 100 exponent bins: counts and fsum exact against the plain
    bin_benefit, device time of each."""
    from bossruns_torch.ops import genome_ops as gops
    from bossruns_torch.ops import scores as sc

    params = eng.make_params(CCL, TIME_COST)
    rows = gops.CovRows(b.mr_bc, b.mr_g, b.mr_len, b.ex_bcsym, b.ex_g)
    st = st._replace(coverage=st.coverage.clone(), zeroed=st.zeroed.clone(),
                     bucket_on=st.bucket_on.clone(), read_starts=st.read_starts.clone(),
                     strat=st.strat.clone())
    changed = gops.coverage_update(**eng.coverage_args(st, rows))
    scores, covsum = sc.site_scores(**eng.score_args(st))
    aux = torch.zeros(4, dtype=torch.float32, device=scores.device)
    ds, fe = gops.row_stage(**eng.row_args(st, scores, covsum, changed, aux, params,
                                           b.rs_row, b.rs_strand, rs_w=b.rs_w))
    del changed, scores, covsum
    bargs = eng.benefit_args(st, ds, fe, aux, params)
    smu, ben, thr = gops.benefit_strategy(**bargs)
    res = dict(launches=launches, **device(lambda: gops.benefit_strategy(**bargs)),
               **bound(nbytes(bargs) + nbytes(smu, ben, thr, bargs["strat"], bargs["aux"])))
    log(f"chromosome single, H4 benefit_strategy: {launches} launches, device "
        f"{res['device_ms']:.4f} ms ({fmt_split(res['split'])}), bound {res['bound_ms']:.4f} ms "
        f"by bytes ({res['bytes']} B; {ds.shape[1]} rows) [{card}]")
    del smu
    kw = dict(bargs, row0=0, halo=bargs["win_cap"])
    fe_b = fe[None].expand_as(ben)
    k = torch.arange(ben.numel(), device=ben.device).remainder(SPREAD_BINS).reshape(ben.shape)
    pow2 = torch.from_numpy(np.ldexp(1.0, -np.arange(SPREAD_BINS))).to(ben.device)
    for what, x in (("own benefit", ben), (f"spread over {SPREAD_BINS} bins", ben * pow2[k])):
        ws = gops.benefit_workspace(ds)
        ws["benefit"].copy_(x)
        ws["norm"].copy_(x.max().reshape(1))
        ws["counts"].zero_()
        ws["fsum"].zero_()
        gops.shard_benefit("bins", ws, **kw)
        counts, fsum = gops.bin_benefit(x, fe_b, ws["norm"][0], gops.NBINS)
        exact(f"bin_benefit {what} counts", ws["counts"].to(torch.float64), counts)
        exact(f"bin_benefit {what} fsum", ws["fsum"], fsum)
        ms = queued_ms(lambda: gops.shard_benefit("bins", ws, **kw))
        bb = bound(nbytes(x, fe, ws["counts"], ws["fsum"]))
        res[f"bins {what}"] = dict(device_ms=ms, **bb)
        log(f"chromosome single, bin_benefit alone on the {what}: {int((x > 0).sum())} positive "
            f"of {x.numel()}, {int((counts > 0).sum())} bins used, counts and fsum exact vs "
            f"plain; device {ms:.4f} ms, bound {bb['bound_ms']:.4f} ms by bytes [{card}]")
        del ws
    return res


def reads_batch(rng, layout, n_reads: int, mean_len: float = MEAN_LEN) -> dict:
    """A ReadBatch as numpy: n_reads reads (5% errors) over the layout's
    contigs in proportion to their lengths, spread over its barcodes."""
    from bossruns_torch.io.coo_native import pad_split, split_runs

    lens = layout.lengths
    cid = rng.choice(len(lens), n_reads, p=lens / lens.sum())
    rlen = np.clip(rng.normal(mean_len, 2000, n_reads), 400, 20000).astype(np.int64)
    rlen = np.minimum(rlen, lens[cid] - 1)
    rstart = (layout.offsets[cid] + rng.random(n_reads) * (lens[cid] - rlen)).astype(np.int64)
    pos = np.concatenate([s0 + np.arange(n) for s0, n in zip(rstart, rlen)])
    sym = layout.seq_int[pos].astype(np.int8)
    flip = rng.random(pos.shape[0]) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    split = split_runs(layout, sym, np.full(pos.shape[0], 40, np.int8), rstart,
                       rlen.astype(np.int32),
                       rng.integers(0, layout.n_barcodes, n_reads).astype(np.int32))
    return dict(pad_split(split), rs_row=rng.integers(0, layout.n_fhat, n_reads).astype(np.int32),
                rs_strand=rng.integers(0, 2, n_reads).astype(np.int32),
                rs_w=np.ones(n_reads, np.float32))


def mesh_inputs(dev):
    """The 8.05 Mb genome with two barcodes (align_chunks 2: its 80 chunks
    put the bounds of two genome shards on H4's 4096-row tiles) and three
    4000-read batches on the card, their reads spread over both barcodes."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.layout import build_layout

    rng = np.random.default_rng(15)
    contigs = {n: rng.integers(0, 4, L).astype(np.uint8) for n, L in GENOME.items()}
    layout = build_layout(contigs, n_barcodes=2, align_chunks=2)
    return layout, [batch_from_numpy(reads_batch(rng, layout, N_READS), dev) for _ in range(3)]


def run_mesh_paths(dev, card: str, work: Path, paths: dict, sl: dict) -> None:
    """Phase 15: the (2, 2) mesh with two barcodes on the 8.05 Mb genome
    against the single engine, and BossRunsSim(mesh_shards=(1, 4)) over the
    corpus against the unsharded sims of phase 4 (gated == classic there)."""
    from bossruns_torch.models.runs import RunsEngine
    from bossruns_torch.models.runs_sim import BossRunsSim
    from bossruns_torch.ops import kernels
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh
    from bossruns_torch.utils.misc import read_strategy_npz

    layout, batches = mesh_inputs(dev)
    s_res = _run_engine(lambda: RunsEngine(layout, device=dev), batches, dev)
    m_res = _run_engine(lambda: ShardedRunsEngine(layout, make_mesh([dev] * 4, barcode_shards=2)),
                        batches, dev)
    compare_engines("(2, 2) mesh", s_res, m_res)
    ah = m_res["auxes"][-1][2]
    log(f"(2, 2) mesh, 2 barcodes, 8.05 Mb: == single engine bit for bit over 3 steps "
        f"(threshold {ah.threshold!r}, updated={ah.updated}); step p50 "
        f"{statistics.median(m_res['times'][2:]):.2f} ms vs single "
        f"{statistics.median(s_res['times'][2:]):.2f} ms ({REPLAYED}) [{card}]")
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


N_ORACLE_STEPS = 4


def genome_mb() -> str:
    return f"{sum(GENOME.values()) / 1e6:.2f} Mb"


def count_path(what: str, fn, kernels_of_path):
    """Drive one path between a reset and a read of the launch counts;
    fails when a kernel of the path never launched."""
    from bossruns_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launches()
    missing = [k for k in kernels_of_path if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched: {launches}")
    log(f"{what}: launches {launches}")
    return out, launches


def check_decisions(dev, card: str) -> dict:
    """Phase 16, first half: the engine on the card at the 8.05 Mb slice
    shape against the port's f64 oracle given the engine's own scores,
    every step, bit for bit; then the engine's step p50 beside the host
    clock's full_update p50 on the same inputs."""
    from bossruns_torch import oracle
    from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy
    from bossruns_torch.models.runs import RunsConfig, RunsEngine

    layout, batch_np, _, _ = build_inputs(np.random.default_rng(11))
    eng = RunsEngine(layout, config=RunsConfig(debug_aux=True), device=dev)
    batch = batch_from_numpy(batch_np, dev)
    params = eng.make_params(CCL, TIME_COST)
    state = eng.init_state()

    def host_state():
        st = state_to_numpy(state)
        st["read_starts"] = st["read_starts"].astype(np.float64)
        return st

    def steps():
        nonlocal state
        out = []
        for i in range(N_ORACLE_STEPS):
            before = host_state()
            state, aux = eng.step(state, batch, params)
            scores = aux.scores.cpu().numpy()
            want, aux_o = oracle.full_update(eng, before, batch_np, CCL, TIME_COST,
                                             scores_override=scores)
            got = state_to_numpy(state)
            for k in ("strat", "bucket_on", "coverage"):
                if not np.array_equal(got[k], want[k]):
                    raise AssertionError(f"step {i}: {k} differs from the f64 oracle "
                                         f"in {int((got[k] != want[k]).sum())} entries")
            if not np.array_equal(got["read_starts"].astype(np.float64), want["read_starts"]):
                raise AssertionError(f"step {i}: read_starts differ from the f64 oracle")
            ah = eng.pull_aux(aux)
            if (ah.any_on, ah.updated) != (aux_o["any_on"], aux_o["updated"]):
                raise AssertionError(f"step {i}: any_on/updated {ah} vs oracle {aux_o['updated']}")
            out.append((before, scores, ah.updated))
        return out

    record, launches = count_path(f"engine vs f64 oracle, {N_ORACLE_STEPS} steps", steps,
                                  UPDATE_KERNELS)
    if not record[-1][2]:
        raise AssertionError("the strategy never updated in the oracle check")
    log(f"engine on the card == f64 oracle bit for bit on all {N_ORACLE_STEPS} steps "
        f"(strat, bucket_on, read_starts, coverage; {N_READS} reads, {genome_mb()}) [{card}]")

    st_times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = eng.step(state, batch, params)
        eng.pull_aux(aux)
        st_times.append((time.perf_counter() - t0) * 1000.0)
    before, scores, _ = record[-1]
    own, given = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        oracle.full_update(eng, before, batch_np, CCL, TIME_COST)
        own.append((time.perf_counter() - t0) * 1000.0)
        t0 = time.perf_counter()
        oracle.full_update(eng, before, batch_np, CCL, TIME_COST, scores_override=scores)
        given.append((time.perf_counter() - t0) * 1000.0)
    step_ms, own_ms, given_ms = (statistics.median(x) for x in (st_times, own, given))
    log(f"device step p50 {step_ms:.3f} ms (host clock incl. aux pull); host full_update p50 "
        f"{own_ms:.1f} ms with its own f64 scores, {given_ms:.1f} ms given the engine's; "
        f"ratio full_update / step {own_ms / step_ms:.1f} ({N_READS} reads, {genome_mb()}) "
        f"[{card}]")
    return dict(launches=launches, step_ms=step_ms, oracle_ms=own_ms, oracle_given_ms=given_ms)


def run_conformance(dev, card: str, work: Path) -> dict:
    """Phase 16, second half: the zymo and dataplane conformance drives on
    the card at their defaults (12.6 Mb, 9 contigs)."""
    from bossruns_torch import conformance as conf

    t0 = time.perf_counter()
    z, zl = count_path("zymo conformance drive",
                       lambda: conf.drive_zymo_conformance(device=dev), UPDATE_KERNELS)
    z_s = time.perf_counter() - t0
    if (z["n_sites"], z["n_contigs"]) != (sum(conf.ZYMO_LIKE_LENGTHS.values()),
                                          len(conf.ZYMO_LIKE_LENGTHS)):
        raise AssertionError(f"zymo drive shape {z['n_sites']} sites, {z['n_contigs']} contigs")
    if not (z["exact_vs_drift_free"] and len(z["exact_batches"]) == 3):
        raise AssertionError(f"zymo drive not exact vs the drift-free oracle: {z['exact_batches']}")
    if not z["any_on"] or z["min_agreement"] < 0.996:
        raise AssertionError(f"zymo drive: any_on {z['any_on']}, agreement {z['per_batch']}")
    log(f"zymo conformance (12.6 Mb, 3 x 12,000 reads, engine on the card): exact vs the "
        f"drift-free f64 oracle on batches {z['exact_batches']}, agreement with the "
        f"bug-compatible oracle per batch {z['per_batch']} (min {z['min_agreement']}); "
        f"{z_s:.1f} s [{card}]")
    t0 = time.perf_counter()
    d, dl = count_path("dataplane conformance drive",
                       lambda: conf.drive_dataplane_conformance(device=dev,
                                                                work_dir=work / "dpc"),
                       UPDATE_KERNELS)
    d_s = time.perf_counter() - t0
    if not (d["coverage_exact"] and len(d["coverage_exact_batches"]) == 2):
        raise AssertionError(f"dataplane drive coverage not exact: {d['coverage_exact_batches']}")
    if not d["any_on"] or d["min_agreement"] < 0.996:
        raise AssertionError(f"dataplane drive: any_on {d['any_on']}, agreement {d['per_batch']}")
    log(f"dataplane conformance (12.6 Mb, haploid, 2 x 6000 reads, sim on the card): coverage "
        f"bit-exact per contig on every batch, agreement per batch {d['per_batch']} "
        f"(min {d['min_agreement']}; the JAX package's BENCH_r05 value 0.999179 was taken by "
        f"the JAX package, not this card); {d_s:.1f} s [{card}]")
    return dict(zymo=z, zymo_launches=zl, dataplane=d, dataplane_launches=dl)


RF_BATCH = 500
RF_TOML = """
[[regions]]
name = "smoke"
min_chunks = 0
max_chunks = 999
single_on = "stop_receiving"
multi_on = "stop_receiving"
single_off = "unblock"
multi_off = "unblock"
no_seq = "unblock"
no_map = "proceed"
"""


def run_prepare(world: Path, paths: dict, device: str) -> dict:
    """``python -m bossruns_torch.prepare`` in a subprocess on a copy of
    the corpus; returns the world's paths and the aligner's reads/s from
    the entry's own line."""
    import os
    import re
    import shutil

    world.mkdir(parents=True)
    ref, fq = world / "ref.fa", world / "reads.fq"
    shutil.copy(paths["ref"], ref)
    shutil.copy(paths["fq"], fq)
    root = Path(__file__).resolve().parent
    res = subprocess.run(
        [sys.executable, "-m", "bossruns_torch.prepare", "--ref", str(ref), "--fq", str(fq),
         "--out", str(world / "prep"), "--device", device],
        capture_output=True, text=True, timeout=600, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)))
    if res.returncode != 0:
        raise AssertionError(f"prepare --device {device} failed:\n{res.stderr[-3000:]}")
    m = re.search(r"align (\d+) reads on \S+: ([0-9.]+) s, ([0-9.]+) reads/s", res.stdout)
    if m is None:
        raise AssertionError(f"prepare --device {device}: no rate line in {res.stdout[-2000:]}")
    return dict(ref=str(ref), fq=str(fq), prep=world / "prep", n=int(m.group(1)),
                seconds=float(m.group(2)), rate=float(m.group(3)))


def check_prepare(dev, card: str, work: Path, paths: dict) -> None:
    """Phase 17, first half: the simulation-data entry over the whole
    corpus on the card and on the CPU, the files byte for byte equal, then
    a sim over the card's PAFs."""
    from bossruns_torch.models.runs_sim import BossRunsSim

    gpu = run_prepare(work / "prep_gpu", paths, "cuda")
    cpu = run_prepare(work / "prep_cpu", paths, "cpu")
    for name in ("full.paf", "trunc.paf"):
        got = (gpu["prep"] / name).read_text().splitlines()
        want = (cpu["prep"] / name).read_text().splitlines()
        if got != want or not want:
            n_bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
            raise AssertionError(f"prepare {name}: the card's lines differ from the CPU's "
                                 f"in {n_bad} of {len(want)}")
    if Path(f"{gpu['fq']}.offsets.npy").read_bytes() != Path(f"{cpu['fq']}.offsets.npy").read_bytes():
        raise AssertionError("prepare: the fastq offsets differ between the card and the CPU")
    n_lines = (gpu["prep"] / "full.paf").read_text().count("\n")
    log(f"prepare: {gpu['n']} reads on the card at {gpu['rate']:.1f} reads/s ({gpu['seconds']:.2f} "
        f"s, {n_lines} full.paf lines), on the CPU at {cpu['rate']:.1f} reads/s "
        f"({cpu['seconds']:.2f} s); full.paf, trunc.paf and the offsets equal line for line "
        f"[{card}]")
    sim = BossRunsSim(ref=gpu["ref"], fq=gpu["fq"], paf_full=str(gpu["prep"] / "full.paf"),
                      paf_trunc=str(gpu["prep"] / "trunc.paf"), name="prepsim",
                      batchsize=N_READS, maxb=2, out_base=work / "prepsim", device=dev)

    def run():
        for _ in range(2):
            sim.process_batch()

    count_path("sim over the card's PAFs, 2 batches", run, UPDATE_KERNELS)
    if not (sim.out_dir / "masks" / "boss.npz").exists() or sim.batch != 2:
        raise AssertionError("sim over the prepared PAFs wrote no masks")
    log("sim over the card's PAFs: 2 batches, masks written")
    sim.cleanup()


class SmokeChunk:
    """A read chunk as the readfish side sees it after basecalling."""

    def __init__(self, channel: int, read_id: str, seq: str):
        self.channel, self.read_id, self.seq = channel, read_id, seq
        self.read_number, self.barcode, self.decision = 0, None, None
        self.alignment_data = None


class SmokeClient:
    """The Read Until client protocol over prepared chunk batches."""

    channel_count = 512
    signal_dtype = None
    calibration_values = None
    wait_for_sequencing_to_start = False

    def __init__(self, batches, run_dir: Path):
        self.batches = list(batches)
        self.mk_run_dir = str(run_dir)
        self.unblocked, self.stopped = [], []

    @property
    def is_sequencing(self) -> bool:
        return bool(self.batches)

    def get_read_chunks(self, batch_size, last=True):
        return self.batches.pop(0)

    def unblock_read_batch(self, actions, duration=0.1):
        self.unblocked.extend(actions)

    def stop_receiving_batch(self, actions):
        self.stopped.extend(actions)


class SmokeCaller:
    """Chunks arrive basecalled: the caller passes them through."""

    def basecall(self, chunks, *_):
        return chunks


def chunk_batches(seqs: dict, tag: str) -> list:
    items = list(seqs.items())
    return [[SmokeChunk(1 + (i + j) % SmokeClient.channel_count, f"{rid}{tag}", s[:400])
             for j, (rid, s) in enumerate(items[i: i + RF_BATCH])]
            for i in range(0, len(items), RF_BATCH)]


def run_readfish(dev, card: str, work: Path, paths: dict, seqs: dict) -> dict:
    """Phase 17, second half: the port's readfish loop (Analysis) with
    TorchMapperPlugin on the card over the first 400-base chunks of the
    corpus reads; every decision against make_decision on the alignments
    of the plugin on the CPU; then an all-false mask's hot reload."""
    import logging

    from bossruns_torch.live.conf import RFConf
    from bossruns_torch.live.decision import Decision, StrategyStore, make_decision
    from bossruns_torch.live.mapper import TorchMapperPlugin
    from bossruns_torch.live.readfish_boss import Analysis
    from bossruns_torch.utils.misc import write_strategy_npz

    run_dir = work / "readfish"
    out = run_dir / "out_smoke"
    rng = np.random.default_rng(17)
    write_strategy_npz(out, {n: rng.random((L // 100, 2)) < 0.5 for n, L in GENOME.items()})
    mapper = TorchMapperPlugin(paths["ref"], device=dev)
    batches = chunk_batches(seqs, "")
    client = SmokeClient(batches, run_dir)
    conf = RFConf.from_toml_str(RF_TOML, channel_count=SmokeClient.channel_count)
    worker = Analysis(client, conf=conf, logger=logging.getLogger("smoke_readfish"),
                      caller=SmokeCaller(), mapper=mapper, throttle=0.0, out_base=run_dir)
    worker.readfish_started_during_sequencing = False
    t0 = time.perf_counter()
    count_path(f"readfish loop, {len(seqs)} chunks", worker.run, ("seed_topn",))
    loop_s = time.perf_counter() - t0
    chunks = [c for b in batches for c in b]

    cpu = TorchMapperPlugin(paths["ref"], device="cpu")
    store = StrategyStore(out / "masks" / "boss.npz")
    ref = [c for b in chunk_batches(seqs, "") for c in cpu.map_reads(b)]
    bad = [c.read_id for c, r in zip(chunks, ref)
           if c.decision is not make_decision(store, r.alignment_data, len(r.seq))]
    if bad:
        raise AssertionError(f"readfish: {len(bad)} of {len(chunks)} decisions differ from the "
                             f"CPU mapper's, e.g. {bad[:3]}")
    modes = {}
    for c in chunks:
        modes[c.decision.name] = modes.get(c.decision.name, 0) + 1
    if not (modes.get("single_on") and modes.get("single_off")):
        raise AssertionError(f"readfish: decisions not mixed {modes}")

    time.sleep(0.01)
    write_strategy_npz(out, {n: np.zeros((L // 100, 2), bool) for n, L in GENOME.items()})
    (flip,) = chunk_batches(dict(list(seqs.items())[:RF_BATCH]), "_again")
    client.batches = [flip]
    n_unblocked = len(client.unblocked)
    worker.run()
    mapped = [c for c in flip if c.alignment_data]
    if not mapped or any(c.decision not in (Decision.single_off, Decision.multi_off)
                         for c in mapped):
        raise AssertionError("readfish: the all-false mask did not turn mapped reads off")
    if len(client.unblocked) - n_unblocked != len(mapped):
        raise AssertionError("readfish: the all-false mask's batch was not unblocked")
    log(f"readfish loop (Analysis + TorchMapperPlugin on the card): {len(chunks)} chunks of 400 "
        f"bases in {loop_s:.2f} s, {len(chunks) / loop_s:.1f} chunks/s; decisions {modes} equal "
        f"make_decision on the CPU mapper's alignments; after an all-false mask {len(mapped)} "
        f"mapped chunks of the next batch unblocked [{card}]")
    return dict(chunks_per_s=len(chunks) / loop_s)


# ------------------------------------------------------ phase 18: options --

#: RunsConfig options of phase 18, beside the default
OPTIONS = {
    "fhat_alpha=1.7": dict(fhat_alpha=1.7),
    "dtype=float64": dict(dtype="float64"),
    "benefit_dtype=float32": dict(benefit_dtype="float32"),
    "dtype=float64, benefit_dtype=float32": dict(dtype="float64", benefit_dtype="float32"),
}
#: phase 18's rows of the kernel table: name -> (entry point, option whose
#: run counts its launches, source, TPU kernel)
OPTION_ROWS = {
    "site_scores_s64": ("site_scores_s64", "dtype=float64", "csrc/scores.cu",
                        "bossruns_tpu/ops/scores.py:102"),
    "row_stage_alpha": ("row_stage", "fhat_alpha=1.7", "csrc/rows.cu",
                        "bossruns_tpu/ops/genome_ops.py:134"),
    "row_stage_s64": ("row_stage_s64", "dtype=float64", "csrc/rows.cu",
                      "bossruns_tpu/models/runs.py:592"),
    "row_stage_d32": ("row_stage_d32", "benefit_dtype=float32", "csrc/rows.cu",
                      "bossruns_tpu/models/runs.py:592"),
    "row_stage_s64_d32": ("row_stage_s64_d32", "dtype=float64, benefit_dtype=float32",
                          "csrc/rows.cu", "bossruns_tpu/models/runs.py:592"),
    "benefit_strategy_d32": ("benefit_strategy_d32", "benefit_dtype=float32", "csrc/strategy.cu",
                             "bossruns_tpu/ops/genome_ops.py:88"),
    "shard_rows_alpha": ("shard_rows", "fhat_alpha=1.7", "csrc/rows.cu",
                         "bossruns_tpu/parallel/mesh.py:209"),
    "shard_rows_s64": ("shard_rows_s64", "dtype=float64", "csrc/rows.cu",
                       "bossruns_tpu/parallel/mesh.py:209"),
    "shard_rows_d32": ("shard_rows_d32", "benefit_dtype=float32", "csrc/rows.cu",
                       "bossruns_tpu/parallel/mesh.py:209"),
    "shard_rows_s64_d32": ("shard_rows_s64_d32", "dtype=float64, benefit_dtype=float32",
                           "csrc/rows.cu", "bossruns_tpu/parallel/mesh.py:209"),
    "shard_benefit_d32": ("shard_benefit_d32", "benefit_dtype=float32", "csrc/strategy.cu",
                          "bossruns_tpu/parallel/mesh.py:209"),
}


def threshold_rule(what: str, thr_a: float, thr_b: float, strat_a, strat_b, benefit,
                   slack) -> int:
    """Test (d)'s rule for two strategies of one step: equal, or thresholds
    at most one exponent bin apart and every differing cell's benefit
    between them, widened by ``slack`` (per cell: the bar within which the
    two sides' benefits agree, since a cell at a shared threshold flips
    when its benefit rounds to either side). Returns the count of
    differing cells."""
    diff = strat_a != strat_b
    n = int(diff.sum())
    if n:
        lo, hi = sorted((thr_a, thr_b))
        if not hi <= 2 * lo * (1 + 1e-5):
            raise AssertionError(f"{what}: thresholds {thr_a!r} and {thr_b!r} more than a bin apart")
        b = benefit[diff]
        e = slack[diff] if isinstance(slack, torch.Tensor) else slack
        if not bool(((b >= lo - e) & (b <= hi + e)).all()):
            raise AssertionError(f"{what}: a differing cell's benefit lies outside the thresholds")
    return n


def option_kernels(name: str, eng, state, batch, params, card: str) -> dict:
    """The option's kernel variants against their plain versions on the
    engine's own state and batch, with times and bounds: H2 with f64
    tables, H3 (exact, but for fhat_exp's f32 rounding, one ulp, and the
    fhat weights of a general alpha, rtol 1e-13), H4's f32 decision path
    (the windows within the scan's rounding, the threshold and strategy
    exact given the kernel's own benefit, and against the plain version
    end to end test (d)'s rule)."""
    from bossruns_torch.ops import genome_ops as gops
    from bossruns_torch.ops import kernels
    from bossruns_torch.ops import scores as sc

    S, D = eng.dtype, eng.benefit_dtype
    v = kernels.row_variant(S, D)
    out = {}
    sargs = eng.score_args(state)
    s_k, cs_k = sc.site_scores(**sargs)
    if S == torch.float64:
        s_p, cs_p = sc.site_scores_plain(**sargs)
        exact("H2 f64 covsum", cs_k, cs_p)
        err = (s_k - s_p).abs()
        if not bool((err <= 1e-12 + 1e-12 * s_p.abs()).all()):
            raise AssertionError(f"H2 f64 scores outside rtol 1e-12 / atol 1e-12: {float(err.max())}")
        out["site_scores_s64"] = dict(ms=time_ms(lambda: sc.site_scores(**sargs)),
                                      plain_ms=time_ms(lambda: sc.site_scores_plain(**sargs)),
                                      max_abs_err=float(err.max()),
                                      **device(lambda: sc.site_scores(**sargs)),
                                      **score_bound(sargs, s_k, cs_k))
        log(f"H2 site_scores_s64 ({name}): covsum exact, f64 scores max abs err "
            f"{float(err.max()):.3g} (rtol 1e-12, atol 1e-12); "
            f"{fmt_score_bound(out['site_scores_s64'])}")
        del s_p, cs_p
    if S == torch.float16:
        s_p, cs_p = sc.site_scores_plain(**sargs)
        exact("H2 f16 covsum", cs_k, cs_p)
        exact("H2 f16 scores (the f32 ops rounded to half at the same points)", s_k, s_p)
        out["site_scores_h16"] = dict(ms=time_ms(lambda: sc.site_scores(**sargs)),
                                      plain_ms=time_ms(lambda: sc.site_scores_plain(**sargs)),
                                      max_abs_err=0.0, **device(lambda: sc.site_scores(**sargs)),
                                      **score_bound(sargs, s_k, cs_k))
        log(f"H2 site_scores_h16 ({name}): covsum and f16 scores exact; "
            f"{fmt_score_bound(out['site_scores_h16'])}")
        del s_p, cs_p
    rows = gops.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    changed = gops.coverage_update(**eng.coverage_args(
        state._replace(coverage=state.coverage.clone()), rows))
    aux = torch.zeros(4, dtype=S, device=s_k.device)
    args = eng.row_args(state, s_k, cs_k, changed, aux, params, batch.rs_row, batch.rs_strand,
                        rs_w=batch.rs_w)
    ak, ap = clone(args), clone(args)
    ds_k, fe_k = gops.row_stage(**ak)
    ds_p, fe_p = gops.row_stage_plain(**ap)
    pairs = [("scores_ds", ds_k, ds_p)] + [(k, ak[k], ap[k]) for k in (
        "scores", "zeroed", "bucket_on", "read_starts", "aux")]
    for k, a, b in pairs:
        exact(f"H3{v} ({name}) {k}", a, b)
    fe_err = (fe_k - fe_p).abs()
    if not bool((fe_err <= 2.0 ** -23 * fe_p.abs()).all()):
        raise AssertionError(f"H3{v} ({name}) fhat_exp beyond one f32 ulp")
    wk = gops.row_workspace(s_k, eng.contig_denom, eng.NW_pad, state.read_starts)
    wp = gops.row_workspace(s_k, eng.contig_denom, eng.NW_pad, state.read_starts)
    k1, k2 = clone(args), clone(args)
    for phase in ("sums", "tables"):
        gops.shard_rows(phase, wk, **k1)
        gops.shard_rows_plain(phase, wp, **k2)
    fw_err = float(((wk["fhat_w"] - wp["fhat_w"]).abs() / wp["fhat_w"].abs().clamp_min(
        torch.finfo(D).tiny)).max())
    if fw_err > 1e-13:
        raise AssertionError(f"H3{v} ({name}) fhat_w relative error {fw_err} beyond 1e-13")
    row = "row_stage_alpha" if name == "fhat_alpha=1.7" else f"row_stage{v}"
    gk, gp = clone(args), clone(args)
    out[row] = dict(ms=time_ms(lambda: gops.row_stage(**gk)),
                    plain_ms=time_ms(lambda: gops.row_stage_plain(**gp)),
                    max_abs_err=max(max_abs_err(*((a, b) for _, a, b in pairs)),
                                    float(fe_err.max())),
                    **device(lambda: gops.row_stage(**gk)),
                    **bound(nbytes(args) + nbytes(ds_k, fe_k, *(args[k] for k in (
                        "scores", "zeroed", "bucket_on", "read_starts", "aux")))))
    log(f"H3 {row} ({name}): scores_ds, scores, zeroed, bucket_on, read_starts, aux exact; "
        f"fhat_exp max abs err {float(fe_err.max()):.3g} (one f32 ulp allowed); fhat_w max "
        f"relative err {fw_err:.3g} (rtol 1e-13)")
    del wk, wp, k1, k2, gk, gp
    bargs = eng.benefit_args(state, ds_k, fe_k, ak["aux"], params)
    bk, bp = clone(bargs), clone(bargs)
    smu_k, ben_k, thr_k = gops.benefit_strategy(**bk)
    smu_p, ben_p, thr_p = gops.benefit_strategy_plain(**bp)
    eps, rtol = (256 * 2.0 ** -52, 1e-12) if D == torch.float64 else (4096 * 2.0 ** -23, 1e-6)
    atol = eps * float(ds_k.sum(dim=1).max())
    worst = 0.0
    for k, a, b in (("smu", smu_k, smu_p), ("benefit", ben_k, ben_p)):
        e = (a - b).abs()
        worst = max(worst, float(e.max()))
        if not bool((e <= rtol * b.abs() + atol).all()):
            raise AssertionError(f"H4 ({name}) {k}: max err {float(e.max())} beyond rtol {rtol} + "
                                 f"{atol:.3g}")
    ref = gops.find_strategy(ben_k, smu_k, fe_k[None].expand_as(ben_k), bargs["time_cost"])
    if float(ref.threshold) != float(thr_k):
        raise AssertionError(f"H4 ({name}) threshold {float(thr_k)!r} != plain "
                             f"{float(ref.threshold)!r} on the kernel's benefit")
    bidx = eng.bucket_idx.long()
    gate = bargs["bucket_on"][:, bidx.clamp_min(0)] & (bidx >= 0)[None] & eng.strat_valid[None]
    want = torch.where((gate & (bk["aux"][1] > 0))[..., None], ref.strat, bargs["strat"])
    exact(f"H4 ({name}) strat", bk["strat"], want)
    flips = threshold_rule(f"H4 ({name}) vs plain", float(thr_k), float(thr_p), bk["strat"],
                           bp["strat"], ben_k, rtol * ben_p.abs() + atol)
    log(f"H4 benefit_strategy{'_d32' if D == torch.float32 else ''} ({name}): smu/benefit max "
        f"abs err {worst:.3g} (rtol {rtol:g} + atol {atol:.3g}), threshold {float(thr_k)!r} "
        f"and strat exact given the kernel's benefit; end to end vs plain {flips} strat cells "
        f"differ, threshold {float(thr_p)!r} (test (d)'s rule, within the windows' bar)")
    aux_row = ("benefit_strategy_d32" if D == torch.float32
               else "benefit_strategy_aux_h16" if S == torch.float16 else None)
    if aux_row is not None:
        ck, cp = clone(bargs), clone(bargs)
        out[aux_row] = dict(
            ms=time_ms(lambda: gops.benefit_strategy(**ck)),
            plain_ms=time_ms(lambda: gops.benefit_strategy_plain(**cp)), max_abs_err=worst,
            **device(lambda: gops.benefit_strategy(**ck)),
            **bound(nbytes(bargs) + nbytes(smu_k, ben_k, thr_k, bargs["strat"], bargs["aux"])))
    for k, r in out.items():
        log(f"time {k} ({name}): kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} [{card}]")
        log(f"device split {k} (launch ms): {fmt_split(r['split'])}")
    return out


def check_options(dev, card: str) -> dict:
    """Phase 18 at phase 3's 8.05 Mb shape: each option's engine (the
    default beside them) for 4 counted steps, its step p50 and its kernel
    variants against their plain versions; the f64-score engine and the
    default against the port's oracle on the oracle's own f64 scores; the
    fhat_alpha=1.7 engine against the oracle given its scores, bit for
    bit; then the (2, 2) mesh under each option."""
    from bossruns_torch import oracle
    from bossruns_torch.models.convert import batch_from_numpy, state_to_numpy
    from bossruns_torch.models.runs import RunsConfig, RunsEngine
    from bossruns_torch.ops import kernels

    layout, batch_np, _, _ = build_inputs(np.random.default_rng(11))
    batch = batch_from_numpy(batch_np, dev)
    rows, launches, engines = {}, {}, {}
    for name, opt in (("default", {}), *OPTIONS.items()):
        eng = RunsEngine(layout, config=RunsConfig(**opt), device=dev)
        params = eng.make_params(CCL, TIME_COST)
        state = eng.init_state()
        rv = kernels.row_variant(eng.dtype, eng.benefit_dtype)
        path = ("coverage_update", "site_scores" + ("_s64" if eng.dtype == torch.float64 else ""),
                "row_stage" + rv,
                "benefit_strategy" + ("_d32" if eng.benefit_dtype == torch.float32 else ""))

        def steps():
            nonlocal state
            aux = None
            for _ in range(4):
                state, aux = eng.step(state, batch, params)
            return eng.pull_aux(aux)

        ah, launches[name] = count_path(f"engine ({name}), 4 steps", steps, path)
        if not (ah.any_on and ah.updated):
            raise AssertionError(f"engine ({name}): the strategy did not update ({ah})")
        if name != "default":  # a kernel shared by two options keeps its first measurement
            for k, r in option_kernels(name, eng, state, batch, params, card).items():
                rows.setdefault(k, r)
        engines[name] = (eng, state, params)
    # the steps in turns (the options in order, then reversed, three times)
    # against the host's drift: host-clock p50 over 30 steps each, and the
    # card's own time of one step (queued events)
    times = {k: [] for k in engines}
    order = list(engines)
    for r in range(6):
        for name in (order if r % 2 == 0 else order[::-1]):
            eng, state, params = engines[name]
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.pull_aux(eng.step(state, batch, params)[1])
                times[name].append((time.perf_counter() - t0) * 1000.0)
    p50 = {k: statistics.median(v) for k, v in times.items()}
    dev_ms = {k: queued_ms(lambda: e.step(st, batch, pr)) for k, (e, st, pr) in engines.items()}
    del engines
    torch.cuda.empty_cache()
    log("step by option (4000 reads, 8.05 Mb; host-clock p50 incl. aux pull over 30 steps "
        "taken in turns / device ms of one step): "
        + ", ".join(f"{k} {p50[k]:.3f} / {dev_ms[k]:.4f} ms" for k in p50) + f" [{card}]")
    log(f"the f64 decision contract's cost per step: default {p50['default']:.3f} ms (device "
        f"{dev_ms['default']:.4f}) vs benefit_dtype=float32 {p50['benefit_dtype=float32']:.3f} "
        f"ms (device {dev_ms['benefit_dtype=float32']:.4f}), bench.py's f32_ms counterpart "
        f"[{card}]")

    # dtype=float64 against the oracle's own f64 scores, the default beside it
    e64 = RunsEngine(layout, config=RunsConfig(dtype="float64"), device=dev)
    e32 = RunsEngine(layout, device=dev)
    params = e64.make_params(CCL, TIME_COST)
    s64, s32 = e64.init_state(), e32.init_state()
    st_np = state_to_numpy(s64)
    valid = e64.strat_valid.cpu().numpy()
    n_valid = int(valid.sum()) * 2 * e64.nb
    d64, d32 = [], []
    for i in range(N_ORACLE_STEPS):
        s64, a64 = e64.step(s64, batch, params)
        s32, _ = e32.step(s32, batch, params)
        st_np, aux_o = oracle.full_update(e64, st_np, batch_np, CCL, TIME_COST, fast_scores=True)
        want = st_np["strat"][:, valid]
        d64.append(int((s64.strat.cpu().numpy()[:, valid] != want).sum()))
        d32.append(int((s32.strat.cpu().numpy()[:, valid] != want).sum()))
        if e64.pull_aux(a64).updated != aux_o["updated"]:
            raise AssertionError(f"dtype=float64 step {i}: updated differs from the oracle")
    log(f"dtype=float64 engine vs oracle.full_update(fast_scores=True) on the oracle's own f64 "
        f"scores: valid strat cells differing per step {d64} of {n_valid} (expected 0); default "
        f"engine (f32 scores) vs the same oracle: {d32} ({N_READS} reads, {genome_mb()}) [{card}]")
    if any(d64):
        raise AssertionError(f"dtype=float64 engine differs from the oracle's own scores: {d64}")
    del e64, e32, s64, s32

    # fhat_alpha=1.7 against the oracle given the engine's scores
    ea = RunsEngine(layout, config=RunsConfig(debug_aux=True, fhat_alpha=1.7), device=dev)
    sa = ea.init_state()
    st_np = state_to_numpy(sa)
    st_np["read_starts"] = st_np["read_starts"].astype(np.float64)
    for i in range(N_ORACLE_STEPS):
        sa, aa = ea.step(sa, batch, params)
        st_np, aux_o = oracle.full_update(ea, st_np, batch_np, CCL, TIME_COST,
                                          scores_override=aa.scores.cpu().numpy())
        got = state_to_numpy(sa)
        for k in ("strat", "bucket_on", "coverage"):
            if not np.array_equal(got[k], st_np[k]):
                raise AssertionError(f"fhat_alpha=1.7 step {i}: {k} differs from the oracle")
        if not np.array_equal(got["read_starts"].astype(np.float64), st_np["read_starts"]):
            raise AssertionError(f"fhat_alpha=1.7 step {i}: read_starts differ from the oracle")
    log(f"fhat_alpha=1.7 engine == the port's f64 oracle given its scores, bit for bit on all "
        f"{N_ORACLE_STEPS} steps (strat, bucket_on, read_starts, coverage) [{card}]")
    del ea, sa
    rows.update(check_option_meshes(dev, card))
    return dict(rows=rows, launches=launches, p50=p50, device_ms=dev_ms)


def check_option_meshes(dev, card: str, options: dict = OPTIONS,
                        rows_map: dict = OPTION_ROWS) -> dict:
    """Phases 18 and 19: the (2, 2) mesh with two barcodes on the 8.05 Mb
    genome under each option, against the single engine bit for bit over 3
    steps (H8's launches counted in the sharded run), then one more step
    with H8 on shard (1, 1) against its plain version, timed (the rows of
    ``rows_map`` that name the option)."""
    from bossruns_torch.models.runs import RunsConfig, RunsEngine
    from bossruns_torch.ops import kernels
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    layout, batches = mesh_inputs(dev)
    rows = {}
    for name, opt in options.items():
        cfg = RunsConfig(**opt)
        s_res = _run_engine(lambda: RunsEngine(layout, config=cfg, device=dev), batches, dev)
        kernels.reset_launches()
        m_res = _run_engine(lambda: ShardedRunsEngine(layout, make_mesh([dev] * 4, 2),
                                                      config=cfg), batches, dev)
        torch.cuda.synchronize()
        launches = kernels.launches()
        compare_engines(f"(2, 2) mesh ({name})", s_res, m_res)
        eng = m_res["engine"]
        rv = kernels.row_variant(eng.dtype, eng.benefit_dtype)
        bv = "_d32" if eng.benefit_dtype == torch.float32 else ""
        if min(launches["shard_rows" + rv], launches["shard_benefit" + bv]) <= 0:
            raise AssertionError(f"(2, 2) mesh ({name}): H8 never launched: {launches}")
        ah = m_res["auxes"][-1][2]
        log(f"(2, 2) mesh ({name}): == single engine bit for bit over 3 steps (threshold "
            f"{ah.threshold!r}, updated={ah.updated}); H8 launches shard_rows{rv} "
            f"{launches['shard_rows' + rv]}, shard_benefit{bv} {launches['shard_benefit' + bv]}")
        target = next(i for i, sh in enumerate(eng.shards) if (sh.b, sh.g) == (1, 1))
        probe = ShardProbe([target])
        eng.probe = probe
        eng.step(m_res["state"], batches[-1], eng.make_params(CCL, TIME_COST))
        eng.probe = None
        torch.cuda.synchronize()
        for k, entry, which in (("shard_rows", "shard_rows" + rv, "rows"),
                                ("shard_benefit", "shard_benefit" + bv, "benefit")):
            row = ("shard_rows_alpha" if name == "fhat_alpha=1.7" and which == "rows"
                   else "shard_benefit_aux_h16" if entry == "shard_benefit"
                   and eng.dtype == torch.float16 else entry)
            if row not in rows_map or rows_map[row][1] != name:
                continue
            rows[row] = dict(ms=probe.ms[k], plain_ms=probe.plain_ms[k], max_abs_err=probe.err[k],
                             device_ms=probe.device_ms[k],
                             split={} if k in probe.split_missing else probe.split[k],
                             launches=launches[entry], **bound(probe.bytes(k)))
            r = rows[row]
            log(f"H8 {row} ({name}, shard (1, 1), all phases) vs plain: max abs err "
                f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f} "
                f"ms), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms [{card}]")
        del s_res, m_res, eng, probe
        torch.cuda.empty_cache()
    return rows


#: phase 18's engines at chromosome scale
CHR_OPTIONS = (("default", {}), ("dtype=float64", dict(dtype="float64")),
               ("benefit_dtype=float32", dict(benefit_dtype="float32")))


def run_options_chromosome(dev, card: str, genome: dict, options=CHR_OPTIONS) -> dict:
    """Phases 18 and 19 at human-chr1 scale (phase 14's single engine, its
    layout and batches): the step p50 and peak memory of the default and
    of each option's engine, and each option's strategy agreement with the
    default's after the 4 steps; with f16 scores, H2 _h16 on the state the
    run leaves (device time, launches, bound; its plain version's f32
    temporaries would not fit the card at this size)."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs import RunsConfig, RunsEngine
    from bossruns_torch.ops import kernels
    from bossruns_torch.ops import scores as sc
    from bossruns_torch.ops.model import make_model

    layout = build_layout(genome, n_barcodes=1, align_chunks=4)
    Gl = layout.G_pad // 4
    rng = np.random.default_rng(14)
    batches = [batch_from_numpy(b, dev) for b in
               chrom_batches(rng, layout, N_CHR_STEPS, (Gl - 3_000_000, Gl + 3_000_000), 0.75, 1)]
    model = make_model(ploidy=2)
    out, strat = {}, {}
    for name, opt in options:
        kernels.reset_launches()
        r = _run_engine(lambda: RunsEngine(layout, model, RunsConfig(**opt), device=dev),
                        batches, dev)
        launches = kernels.launches()
        st = r["state"]
        strat[name] = st.strat[:, r["engine"].strat_valid, :].clone()
        out[name] = dict(p50=statistics.median(r["times"][2:]), peak=r["peak"],
                         updated=r["auxes"][-1][2].updated)
        log(f"chromosome single ({name}): step p50 {out[name]['p50']:.2f} ms over the replayed "
            f"steps (steps {', '.join(f'{t:.1f}' for t in r['times'])} ms, host clock incl. aux "
            f"pull; {REPLAYED}), peak memory {r['peak'] / 2**30:.2f} GiB above resident; updated="
            f"{out[name]['updated']} [{card}]")
        if r["engine"].dtype == torch.float16:
            args = r["engine"].score_args(st)
            h2 = score_bound(args, *sc.site_scores(**args))
            h2.update(device_ms=queued_ms(lambda: sc.site_scores(**args)),
                      launches=launches["site_scores_h16"])
            out[name]["h2"] = h2
            log(f"chromosome single ({name}), H2 site_scores_h16: {h2['launches']} launches, "
                f"device {h2['device_ms']:.4f} ms, {fmt_score_bound(h2)} [{card}]")
            del args
        del r, st
        torch.cuda.empty_cache()
    n = strat["default"].numel()
    for name, _ in options[1:]:
        d = int((strat[name] != strat["default"]).sum())
        out[name]["differ"] = d
        log(f"chromosome single: {name} strategy vs the default's after {N_CHR_STEPS} steps: "
            f"{d} of {n} valid cells differ ({d / n:.3g}) [{card}]")
    return out


# ------------------------------------------------------ phase 19: float16 --

#: RunsConfig options of phase 19, beside the default
F16_OPTIONS = {
    "dtype=float16": dict(dtype="float16"),
    "dtype=float16, benefit_dtype=float32": dict(dtype="float16", benefit_dtype="float32"),
}
#: phase 19's rows of the kernel table: name -> (entry point, option whose
#: run counts its launches, source, TPU kernel); the _aux_h16 rows are the
#: default entry point of H4 and H8's benefit writing a half aux
F16_ROWS = {
    "site_scores_h16": ("site_scores_h16", "dtype=float16", "csrc/scores.cu",
                        "bossruns_tpu/ops/scores.py:102"),
    "row_stage_h16": ("row_stage_h16", "dtype=float16", "csrc/rows.cu",
                      "bossruns_tpu/models/runs.py:592"),
    "row_stage_h16_d32": ("row_stage_h16_d32", "dtype=float16, benefit_dtype=float32",
                          "csrc/rows.cu", "bossruns_tpu/models/runs.py:592"),
    "benefit_strategy_aux_h16": ("benefit_strategy", "dtype=float16", "csrc/strategy.cu",
                                 "bossruns_tpu/ops/genome_ops.py:88"),
    "shard_rows_h16": ("shard_rows_h16", "dtype=float16", "csrc/rows.cu",
                       "bossruns_tpu/parallel/mesh.py:209"),
    "shard_rows_h16_d32": ("shard_rows_h16_d32", "dtype=float16, benefit_dtype=float32",
                           "csrc/rows.cu", "bossruns_tpu/parallel/mesh.py:209"),
    "shard_benefit_aux_h16": ("shard_benefit", "dtype=float16", "csrc/strategy.cu",
                              "bossruns_tpu/parallel/mesh.py:209"),
}
#: phase 19's engines at chromosome scale
F16_CHR = (("default", {}), ("dtype=float16", dict(dtype="float16")))


def plain_step(eng, state, batch, params):
    """RunsEngine._step through the plain versions (on the card here):
    updates ``state`` in place; returns (scores, aux, threshold)."""
    from bossruns_torch.ops import genome_ops as gops
    from bossruns_torch.ops import scores as sc

    full = gops.CovRows(batch.mr_bc, batch.mr_g, batch.mr_len, batch.ex_bcsym, batch.ex_g)
    changed = gops.coverage_update_plain(**eng.coverage_args(state, full))
    scores, covsum = sc.site_scores_plain(**eng.score_args(state))
    aux = torch.zeros(4, dtype=eng.dtype, device=eng.device)
    ds, fe = gops.row_stage_plain(**eng.row_args(state, scores, covsum, changed, aux, params,
                                                 batch.rs_row, batch.rs_strand, rs_w=batch.rs_w))
    _, _, thr = gops.benefit_strategy_plain(**eng.benefit_args(state, ds, fe, aux, params))
    return scores, aux, thr


def check_f16_overflow(dev, card: str) -> None:
    """Phase 19: the f16 engine against the f16 plain path on the card over
    2 steps where coverage sums pass 2048 (rounded to f16), 65,519 (inf)
    and the contig means go inf and NaN: a 40 kb contig (whose f16 site
    count is finite) beside a 130 kb one, with covsums of 2049, 4097 and
    70,000 written into the state; everything bit for bit, aux's inf
    mean included."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs import RunsConfig, RunsEngine

    rng = np.random.default_rng(19)
    layout = build_layout({c: rng.integers(0, 4, n).astype(np.uint8)
                           for c, n in (("s", 40_000), ("a", 130_000))}, min_len=30_000)
    cov = np.zeros((1, 5, layout.G_pad), np.uint16)
    o_s, o_a = (int(layout.offsets[layout.names.index(c)]) for c in ("s", "a"))
    cov[0, 0, o_s: o_s + 20_000] = 9
    cov[0, 0, o_s + 100: o_s + 300] = 2049
    cov[0, 1, o_s + 300: o_s + 500] = 4097
    cov[0, :2, o_s + 700] = 35_000
    cov[0, 2, o_a + 1000: o_a + 21_000] = 2051
    cfg = RunsConfig(dtype="float16", debug_aux=True)
    ek, ep = RunsEngine(layout, config=cfg, device=dev), RunsEngine(layout, config=cfg, device=dev)
    sk, sp = ek.init_state(), ep.init_state()
    for st in (sk, sp):
        st.coverage.copy_(torch.from_numpy(cov.view(np.int16)).view(torch.uint16))
    params = ek.make_params(CCL, TIME_COST)
    for i in range(2):
        batch = batch_from_numpy(reads_batch(rng, layout, 300), dev)
        sk, ak = ek.step(sk, batch, params)
        scores_p, aux_p, thr_p = plain_step(ep, sp, batch, params)
        for k in sk._fields:
            exact(f"f16 overflow, step {i}: {k}", getattr(sk, k), getattr(sp, k))
        exact(f"f16 overflow, step {i}: aux", ak.vec, aux_p)
        exact(f"f16 overflow, step {i}: threshold", ak.threshold, thr_p)
        exact(f"f16 overflow, step {i}: scores", ak.scores, scores_p)
    if not bool(torch.isinf(ak.vec[3])):
        raise AssertionError(f"f16 overflow: the mean coverage {float(ak.vec[3])} is not inf")
    log(f"f16 engine == the f16 plain path on coverage sums of 2049, 4097 and 70,000 over 2 "
        f"steps (state, aux with its inf mean, threshold {float(ak.threshold)!r}, scores bit "
        f"for bit; contig s dropped out: {bool(sk.zeroed[0, o_s: o_s + 20_000].all())}) [{card}]")


def check_f16_adversarial(dev, card: str) -> None:
    """Phase 19: H2 _h16 against its plain version on the card, bit for
    bit, on the adversarial case of tests/test_torch_f16.py (b) (the same
    draws): a diploid model with random phi and prior, whose posteriors
    spread over all 15 genotypes, over 2 x 60,000 sites of counts 0-5.
    There the 15-term q dot's addition tree decides the last f16 bit
    (ROADMAP F15). The sites where the card's scores differ from the plain
    version's on the CPU (CUDA's expf/logf against the host's) are
    counted."""
    from bossruns_torch.ops import kernels
    from bossruns_torch.ops import scores as sc
    from bossruns_torch.ops.model import ObservationModel

    rng = np.random.default_rng(0)
    n = 60_000
    model = ObservationModel(2, rng.dirichlet(np.full(5, 0.3), 15).T,
                             rng.dirichlet(np.ones(15), 4))
    cnt = rng.integers(0, 6, (2, 5, n)).astype(np.uint16)
    ref = rng.integers(0, 4, n).astype(np.int8)

    def args(where):
        return dict(coverage=torch.from_numpy(cnt.view(np.int16)).view(torch.uint16).to(where),
                    seq=torch.from_numpy(ref).to(where),
                    site_valid=torch.ones(n, dtype=torch.bool, device=where),
                    tables=sc.ScoreTables(model, torch.float16, device=where),
                    freeze_cov=1 << 20, tiny=float(np.finfo(np.float16).tiny))

    h2 = kernels.KERNELS["site_scores_h16"]
    n0 = h2.launches
    s_k, cs_k = sc.site_scores(**args(dev))
    if h2.launches != n0 + 1:
        raise AssertionError("H2 _h16 was not launched on the adversarial case")
    s_p, cs_p = sc.site_scores_plain(**args(dev))
    exact("H2 _h16 adversarial case: covsum", cs_k, cs_p)
    exact("H2 _h16 adversarial case: f16 scores", s_k, s_p)
    s_cpu = sc.site_scores_plain(**args("cpu"))[0]
    off = int(differ(s_k.cpu(), s_cpu).sum())
    log(f"H2 site_scores_h16 on the adversarial model (random phi and prior, 2 x {n} sites, "
        f"counts 0-5): kernel == plain on the card, bit for bit; {off} scores differ from the "
        f"plain version on the CPU [{card}]")


def check_f16(dev, card: str) -> dict:
    """Phase 19 at phase 3's 8.05 Mb shape: each f16 engine (the default
    beside them) for 4 counted steps and its half entry points against
    their plain versions (option_kernels), the steps in turns, the f16
    engine against the f16 plain path on the card over 4 steps, and the
    (2, 2) mesh at f16."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.runs import RunsConfig, RunsEngine
    from bossruns_torch.ops import kernels

    layout, batch_np, _, _ = build_inputs(np.random.default_rng(11))
    batch = batch_from_numpy(batch_np, dev)
    rows, launches, engines = {}, {}, {}
    for name, opt in (("default", {}), *F16_OPTIONS.items()):
        eng = RunsEngine(layout, config=RunsConfig(**opt), device=dev)
        params = eng.make_params(CCL, TIME_COST)
        state = eng.init_state()
        path = ("coverage_update", "site_scores" + kernels.SCORE_SUFFIX[eng.dtype],
                "row_stage" + kernels.row_variant(eng.dtype, eng.benefit_dtype),
                "benefit_strategy" + ("_d32" if eng.benefit_dtype == torch.float32 else ""))

        def steps():
            nonlocal state
            aux = None
            for _ in range(4):
                state, aux = eng.step(state, batch, params)
            return eng.pull_aux(aux)

        ah, launches[name] = count_path(f"engine ({name}), 4 steps", steps, path)
        if not (ah.any_on and ah.updated):
            raise AssertionError(f"engine ({name}): the strategy did not update ({ah})")
        if name != "default":
            if state.read_starts.dtype != eng.dtype:
                raise AssertionError(f"engine ({name}): read_starts {state.read_starts.dtype}")
            for k, r in option_kernels(name, eng, state, batch, params, card).items():
                rows.setdefault(k, r)
        engines[name] = (eng, state, params)
    times = {k: [] for k in engines}
    order = list(engines)
    for r in range(6):
        for name in (order if r % 2 == 0 else order[::-1]):
            eng, state, params = engines[name]
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.pull_aux(eng.step(state, batch, params)[1])
                times[name].append((time.perf_counter() - t0) * 1000.0)
    p50 = {k: statistics.median(v) for k, v in times.items()}
    dev_ms = {k: queued_ms(lambda: e.step(st, batch, pr)) for k, (e, st, pr) in engines.items()}
    del engines
    torch.cuda.empty_cache()
    log("step by dtype (4000 reads, 8.05 Mb; host-clock p50 incl. aux pull over 30 steps "
        "taken in turns / device ms of one step): "
        + ", ".join(f"{k} {p50[k]:.3f} / {dev_ms[k]:.4f} ms" for k in p50) + f" [{card}]")

    # the f16 engine against the f16 plain path on the card, step by step
    cfg = RunsConfig(dtype="float16", debug_aux=True)
    ek, ep = RunsEngine(layout, config=cfg, device=dev), RunsEngine(layout, config=cfg, device=dev)
    sk, sp = ek.init_state(), ep.init_state()
    params = ek.make_params(CCL, TIME_COST)
    for i in range(4):
        sk, ak = ek.step(sk, batch, params)
        scores_p, aux_p, thr_p = plain_step(ep, sp, batch, params)
        for k in sk._fields:
            exact(f"f16 engine vs plain path, step {i}: {k}", getattr(sk, k), getattr(sp, k))
        exact(f"f16 engine vs plain path, step {i}: aux", ak.vec, aux_p)
        exact(f"f16 engine vs plain path, step {i}: threshold", ak.threshold, thr_p)
        # the kernel rounds to half where the plain version does: bar 0 ulps
        exact(f"f16 engine vs plain path, step {i}: scores", ak.scores, scores_p)
    log(f"f16 engine == the f16 plain path on the card over 4 steps (coverage, zeroed, "
        f"bucket_on, read_starts, strat, aux, threshold and f16 scores bit for bit; threshold "
        f"{float(ak.threshold)!r}, read_starts max {float(sk.read_starts.max())}) [{card}]")
    del ek, ep, sk, sp
    torch.cuda.empty_cache()
    check_f16_overflow(dev, card)
    check_f16_adversarial(dev, card)
    rows.update(check_option_meshes(dev, card, F16_OPTIONS, F16_ROWS))
    return dict(rows=rows, launches=launches, p50=p50, device_ms=dev_ms)


# ------------------------------------------- phase 20: scoreboard, tools --

#: every record the scoreboard prints on a complete run
BENCH_METRICS = ("strategy_update_p50_latency", "aligner_production_trunc_reads_per_s",
                 "aligner_trunc_reads_per_s", "aligner_full_reads_per_s",
                 "sim_batch_p50_latency", "conformance_mask_agreement", "conformance_dataplane",
                 "aeons_batch_p50_latency", "strategy_update_p50_latency_scaled")
#: python -m bossruns_torch.tools.<name>, each at its default shape, and a
#: line its output must hold (check_sequencer_connection needs a sequencer)
TOOLS = {"bench_aligner": '"aligner_full_reads_per_s"',
         "bench_scale": '"genome_sites": 134000000',
         "profile_step": "full step (f32 decisions)",
         "profile_seed": "H5 seed_topn",
         "profile_aeons_strategy": "40 Mb (200 contigs)",
         "check_decision_parity": "TOTAL disagreements over 5 batches: 0 "}
#: run in every process of phase 20 (it comes first on PYTHONPATH): jax and
#: the JAX package cannot be imported, and at exit each process writes the
#: names of any of their modules it holds to its own file
IMPORT_GUARD = """
import atexit, os, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _NoJax())

def _report(path=os.path.join(os.path.dirname(__file__), f"modules_{os.getpid()}.txt")):
    with open(path, "w") as fh:
        fh.write(" ".join(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib", "bossruns_tpu")))

atexit.register(_report)
"""


def guarded_run(args: list[str], guard: Path, timeout: float) -> tuple[int, str, float]:
    """Run ``python args`` from the repo root with IMPORT_GUARD first on its
    path (and so on every process it starts); (exit code, stdout, seconds)."""
    import os

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(guard), root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
    return proc.returncode, proc.stdout, time.perf_counter() - t0


# ------------------------------------------------ phase 21: captured steps --

#: steps of each path held graph against eager, and more taken in turns for
#: the host-clock p50s (each side's first two left out: the graph's warm-up
#: and capture)
GRAPH_CHECK, GRAPH_TIME = 4, 12
#: engine options of phase 21 (phase 18's and phase 19's, and the default)
GRAPH_OPTIONS = {"default": {}, **OPTIONS, "dtype=float16": dict(dtype="float16"),
                 "dtype=float16, benefit_dtype=float32": dict(dtype="float16",
                                                              benefit_dtype="float32")}


def same_state(a, b) -> bool:
    """Every field of two states (tensors, or per-shard lists) equal, bit
    for bit, compared on the card."""
    for x, y in zip(a, b):
        xs, ys = (x, y) if isinstance(x, list) else ([x], [y])
        if not all(torch.equal(p, q) for p, q in zip(xs, ys)):
            return False
    return True


def graph_turns(what: str, eng, state, step_graph, step_eager, card: str,
                n_check: int = GRAPH_CHECK, n_time: int = GRAPH_TIME) -> dict:
    """``n_check + n_time`` steps of one path in turns (each pair's order
    alternating): ``step_graph(state, i)`` through the engine's graph cache
    on ``state``, ``step_eager(state, i)`` through the eager body on a copy.
    State (the strategy included), aux.vec and threshold equal bit for bit
    after every step; the host-clock ms of each step incl. the aux pull;
    then the device time of one step each way (queued events)."""
    sg, se = state, deep_clone(state)
    times = {"graph": [], "eager": []}
    updated = 0
    for i in range(n_check + n_time):
        outs = {}
        for side in (("graph", "eager") if i % 2 == 0 else ("eager", "graph")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if side == "graph":
                sg, a = step_graph(sg, i)
            else:
                se, a = step_eager(se, i)
            ah = eng.pull_aux(a)
            times[side].append((time.perf_counter() - t0) * 1000.0)
            outs[side] = (a.vec.clone(), a.threshold.clone(), ah)
        (vg, tg, ah), (ve, te, _) = outs["graph"], outs["eager"]
        if not (same_state(sg, se) and torch.equal(vg, ve) and torch.equal(tg, te)):
            raise AssertionError(f"{what}: the captured step differs from the eager one at "
                                 f"step {i}: aux {vg.tolist()} vs {ve.tolist()}")
        updated += ah.updated
    stats = eng.graphs.stats()
    if not sum(stats["replays"].values()):
        raise AssertionError(f"{what}: no step replayed ({stats})")
    out = dict(graph_ms=statistics.median(times["graph"][2:]),
               eager_ms=statistics.median(times["eager"][2:]),
               graph_device_ms=queued_ms(lambda: step_graph(sg, 0)),
               eager_device_ms=queued_ms(lambda: step_eager(se, 0)), stats=stats, updated=updated)
    log(f"{what}: graph == eager bit for bit over {n_check + n_time} steps in turns (state, "
        f"strategy, aux, threshold; {updated} updated); host p50 graph {out['graph_ms']:.3f} ms vs "
        f"eager {out['eager_ms']:.3f} ms (steps 3-{n_check + n_time} of each); device "
        f"{out['graph_device_ms']:.4f} vs {out['eager_device_ms']:.4f} ms; replays "
        f"{stats['replays']}, eager {stats['eager']}, {stats['captures']} captures "
        f"({', '.join(f'{ms:.1f}' for ms in stats['capture_ms'])} ms) [{card}]")
    return out


def check_graphs(dev, card: str) -> dict:
    """Phase 21 at phase 3's shape (8.05 Mb, 4000 reads): each path of the
    single engine (step, step_from_numpy, step_gated) and each engine option
    through ``step``, graph against eager (``graph_turns``)."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.runs import RunsConfig, RunsEngine

    layout, batch_np, gated_np, bits_np = build_inputs(np.random.default_rng(11))
    batch = batch_from_numpy(batch_np, dev)
    bits = torch.from_numpy(bits_np).to(dev)
    out = {}

    def gated_graph(eng, params):
        def step(s, i):
            wire, spec = eng.pack_gated(gated_np, out=eng.stage)
            g = eng.unpack_gated(eng.upload_wire(wire, spec), spec)
            return eng.step_gated(s, g, bits, params)
        return step

    def gated_eager(eng, params):
        def step(s, i):
            wire, spec = eng.pack_gated(gated_np)
            g = eng.unpack_gated(torch.from_numpy(wire).to(dev), spec)
            return eng.eager("step_gated", s, g, bits, params)
        return step

    for path in ("step", "step_from_numpy", "step_gated"):
        eng = RunsEngine(layout, device=dev)
        params = eng.make_params(CCL, TIME_COST)
        if path == "step_gated":
            fg, fe = gated_graph(eng, params), gated_eager(eng, params)
        else:
            x = batch if path == "step" else batch_np
            fg = lambda s, i, eng=eng, x=x, params=params, path=path: (  # noqa: E731
                getattr(eng, path)(s, x, params))
            fe = lambda s, i, eng=eng, x=x, params=params, path=path: (  # noqa: E731
                eng.eager(path, s, x, params))
        out[path] = graph_turns(f"8.05 Mb {path}", eng, eng.init_state(), fg, fe, card)
        if not out[path]["stats"]["replays"].get(path):
            raise AssertionError(f"{path}: no replay ({out[path]['stats']})")
    for name, opt in GRAPH_OPTIONS.items():
        eng = RunsEngine(layout, config=RunsConfig(**opt), device=dev)
        params = eng.make_params(CCL, TIME_COST)
        out[name] = graph_turns(
            f"8.05 Mb option {name}", eng, eng.init_state(),
            lambda s, i, eng=eng, params=params: eng.step(s, batch, params),
            lambda s, i, eng=eng, params=params: eng.eager("step", s, batch, params), card)
    return out


def graph_peak(eng, batches, params, mode: str, n: int = 3) -> dict:
    """Peak allocated and reserved memory (bytes above what was there) of
    ``n`` steps from a fresh state, ``mode`` "graph" (the state is new to
    the cache: the first step captures into a new pool) or "eager". Every
    graph is dropped and the allocator's cache emptied first, so neither
    mode finds memory the other left reserved."""
    import gc

    d = eng.device
    eng.graphs.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_r = torch.cuda.memory_allocated(d), torch.cuda.memory_reserved(d)
    torch.cuda.reset_peak_memory_stats(d)
    st = eng.init_state()
    for i in range(n):
        b = batches[i % len(batches)]
        st, a = eng.step(st, b, params) if mode == "graph" else eng.eager("step", st, b, params)
        eng.pull_aux(a)
    torch.cuda.synchronize()
    out = dict(peak=torch.cuda.max_memory_allocated(d) - base,
               reserved=torch.cuda.max_memory_reserved(d) - base_r)
    del st, a
    return out


def one_tier(batches: list[dict]) -> list[dict]:
    """The batches with every field padded to the longest (mr_len 0, ex_g
    EX_PAD, read-start weight 0): one shape tier."""
    from bossruns_torch.io.coo_native import EX_PAD

    fills = {"ex_g": EX_PAD}
    for k in batches[0]:
        m = max(b[k].shape[0] for b in batches)
        for b in batches:
            a = np.full(m, fills.get(k, 0), b[k].dtype)
            a[: b[k].shape[0]] = b[k]
            b[k] = a
    return batches


def graphs_chromosome(dev, card: str, genome: dict) -> dict:
    """Phase 21 at human-chr1 scale (phase 14's genome, ploidy 2, one
    barcode): the single engine and the (1, 4) in-process mesh, graph
    against eager in turns over 4 batches of one tier (``graph_turns``),
    then each mode's peak memory over 3 steps from a fresh state."""
    from bossruns_torch.models.convert import batch_from_numpy
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs import RunsEngine
    from bossruns_torch.ops.model import make_model
    from bossruns_torch.parallel.mesh import ShardedRunsEngine, make_mesh

    layout = build_layout(genome, n_barcodes=1, align_chunks=4)
    Gl = layout.G_pad // 4
    rng = np.random.default_rng(21)
    batches = [batch_from_numpy(b, dev) for b in one_tier(
        chrom_batches(rng, layout, 4, (Gl - 3_000_000, Gl + 3_000_000), 0.75, 1))]
    out = {}
    for name, make in (("single", lambda: RunsEngine(layout, make_model(ploidy=2), device=dev)),
                       ("sharded (1, 4)", lambda: ShardedRunsEngine(
                           layout, make_mesh([dev] * 4), make_model(ploidy=2)))):
        eng = make()
        params = eng.make_params(CCL, TIME_COST)
        r = graph_turns(
            f"chromosome {name}", eng, eng.init_state(),
            lambda s, i, eng=eng, params=params: eng.step(s, batches[i % 4], params),
            lambda s, i, eng=eng, params=params: eng.eager("step", s, batches[i % 4], params),
            card)
        if not r["updated"]:
            raise AssertionError(f"chromosome {name}: the strategy never updated")
        r.update({f"{m}_mem": graph_peak(eng, batches, params, m) for m in ("eager", "graph")})
        log(f"chromosome {name}: peak memory over 3 steps from a fresh state, eager "
            f"{r['eager_mem']['peak'] / 2**30:.3f} GiB allocated ({r['eager_mem']['reserved'] / 2**30:.3f} "
            f"reserved) vs graph {r['graph_mem']['peak'] / 2**30:.3f} GiB "
            f"({r['graph_mem']['reserved'] / 2**30:.3f} reserved, capture included), above the "
            f"engine's constants [{card}]")
        out[name] = r
        del eng
        torch.cuda.empty_cache()
    return out


def run_scoreboard(card: str, work: Path) -> dict:
    """Phase 20: ``python -m bossruns_torch.bench`` (every section, in
    subprocesses) and each tool once at its default shape, in processes
    where jax and the JAX package cannot be imported (IMPORT_GUARD, whose
    reports show that none of them held a module of either). The
    scoreboard exits 0 with every record present, none skipped, failed or
    timed out, the headline first and last with vs_baseline > 1, and zymo
    agreement >= 0.996; each tool exits 0 and prints its line."""
    from bossruns_torch.bench import ORDER

    guard = work / "guard"
    guard.mkdir()
    (guard / "sitecustomize.py").write_text(IMPORT_GUARD)
    rc, out, secs = guarded_run(["-m", "bossruns_torch.bench"], guard, timeout=1100)
    recs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    recs = [r for r in recs if "metric" in r]
    for line in out.splitlines():
        if line.startswith("# section") or line.startswith("# kernels"):
            log(line)
    for r in recs:
        if r["metric"] != "bench_summary":
            log(json.dumps(r))
    if rc != 0:
        raise AssertionError(f"python -m bossruns_torch.bench exited {rc}")
    names = [r["metric"] for r in recs]
    bad = [n for n in names if n.endswith(("_skipped", "_device_skipped", "_error", "_timeout"))]
    missing = [m for m in BENCH_METRICS if m not in names]
    if bad or missing:
        raise AssertionError(f"scoreboard: failed {bad}, missing {missing}")
    head = recs[0]
    if not (names[0] == names[-1] == "strategy_update_p50_latency"):
        raise AssertionError(f"scoreboard: first {names[0]}, last {names[-1]}")
    if not (recs[-1]["vs_baseline"] > 1 and recs[-1]["detail"]["f32_ms"] is not None):
        raise AssertionError(f"scoreboard headline: {recs[-1]}")
    zymo = next(r for r in recs if r["metric"] == "conformance_mask_agreement")
    if zymo["value"] < 0.996:
        raise AssertionError(f"scoreboard: zymo agreement {zymo['value']}")
    log(f"scoreboard: {len(BENCH_METRICS)} records, rc 0 in {secs:.1f} s; headline "
        f"{head['value']} ms first and {recs[-1]['value']} ms last, vs_baseline "
        f"{recs[-1]['vs_baseline']} [{card}]")
    g = recs[-1]["detail"].get("graphs") or {}
    if not all(g.get(k, {}).get("replays", {}).get("step") for k in ("f64", "f32")):
        raise AssertionError(f"scoreboard headline: the step did not replay a graph: {g}")
    log(f"scoreboard headline on the graph path: f64 engine replays {g['f64']['replays']}, eager "
        f"{g['f64']['eager']}, {g['f64']['captures']} captures; f32 engine replays "
        f"{g['f32']['replays']}, eager {g['f32']['eager']}")
    tools = {}
    for name, want in TOOLS.items():
        rc, out, secs = guarded_run(["-m", f"bossruns_torch.tools.{name}"], guard, timeout=600)
        for line in out.splitlines():
            log(f"  {name}: {line}")
        if rc != 0 or want not in out:
            raise AssertionError(f"tools.{name}: exit code {rc}, {want!r} missing")
        tools[name] = secs
        log(f"tools.{name}: rc 0 in {secs:.1f} s [{card}]")
    reports = sorted(guard.glob("modules_*.txt"))
    held = [p.read_text() for p in reports if p.read_text()]
    if held or len(reports) < 1 + len(ORDER) + len(TOOLS):
        raise AssertionError(f"import guard: {len(reports)} processes reported, modules {held}")
    log(f"no process of phase 20 ({len(reports)}) imported jax or the JAX package")
    return dict(records=recs, tools=tools)


# ---------------------------------------------------- phase 22: seed link --

#: the sleep queued before the dispatch check (ms at the card's highest SM
#: clock; its own length is measured with CUDA events)
LINK_SLEEP_MS = 50.0
#: the readfish loop's chunks/s that PERF.md records from before the packed
#: link (NVIDIA H100 80GB HBM3, 700.00 W)
READFISH_PARENT = (11285, 12205)


def link_reads(paths: dict, n: int = N_READS) -> dict:
    """The live-alignment sim's full reads on the corpus genome: mean 2,500,
    sd 1,200 (the aligner's buckets 512 to 16384), {rid: seq}."""
    from bossruns_torch.models.runs_sim import load_reference_contigs
    from bossruns_torch.utils.datagen import simulate_reads

    genome = load_reference_contigs(paths["ref"])
    sim = simulate_reads(np.random.default_rng(22), genome, n, mean_len=2500.0, sd_len=1200.0)
    return {r.rid: r.seq for r in sim}


def link_aligner(dev, paths: dict):
    """(reads, aligner, buckets): ``link_reads``, the k13/w5 aligner on the
    card over the corpus genome, and the length buckets the reads fill."""
    from bossruns_torch.aligner import bucket_of, make_aligner
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs_sim import load_reference_contigs

    reads = link_reads(paths)
    layout = build_layout(load_reference_contigs(paths["ref"]))
    al = make_aligner(layout, device=dev, k=13, w=5, min_votes=3)
    return reads, al, sorted({bucket_of(len(r)) for r in reads.values()})


def dispatch_check(al, seqs: dict, reps: int = 3) -> list[dict]:
    """map_sequences on the card with a ~LINK_SLEEP_MS sleep queued on the
    stream just before its dispatch loop (after the batch's encode): the
    host ms of the loop (every _seed_bucket_dispatch call before the first
    pull, summed) and of everything before the first pull, beside the
    sleep's own length (CUDA events). The aligner's methods are wrapped on
    the instance, so the check runs on any version of the aligner, whatever
    its dispatch takes."""
    acc = {}
    real_dispatch, real_pull = al._seed_bucket_dispatch, al._pull_seeds

    def dispatch(*a, **kw):
        if not acc["calls"]:
            acc["e0"].record()
            torch.cuda._sleep(int(LINK_SLEEP_MS * SM_CLOCK_MHZ * 1000))
            acc["e1"].record()
        t0 = time.perf_counter()
        try:
            return real_dispatch(*a, **kw)
        finally:
            acc["ms"] += 1000 * (time.perf_counter() - t0)
            acc["calls"] += 1

    def pull(*a, **kw):
        acc.setdefault("first_pull", time.perf_counter())
        return real_pull(*a, **kw)

    al._seed_bucket_dispatch, al._pull_seeds = dispatch, pull
    rows = []
    try:
        for i in range(reps + 2):  # two warm-ups: each takes one staging buffer first
            acc.clear()
            acc.update(ms=0.0, calls=0, e0=torch.cuda.Event(enable_timing=True),
                       e1=torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            al.map_sequences(seqs)
            torch.cuda.synchronize()
            if i > 1:
                rows.append(dict(dispatch_ms=acc["ms"], calls=acc["calls"],
                                 to_first_pull_ms=1000 * (acc["first_pull"] - t0),
                                 sleep_ms=acc["e0"].elapsed_time(acc["e1"])))
    finally:
        del al._seed_bucket_dispatch, al._pull_seeds
    return rows


def fmt_dispatch(rows: list[dict]) -> str:
    return "; ".join(f"dispatch {r['dispatch_ms']:.2f} ms in {r['calls']} calls, first pull at "
                     f"{r['to_first_pull_ms']:.2f} ms, sleep {r['sleep_ms']:.2f} ms" for r in rows)


def link_turn(dev, card: str, work: Path, paths: dict) -> dict:
    """What the seed link moves, through entry points every version of the
    port has (one turn of a parent/change comparison): the dispatch check,
    map_sequences p50 on the multi-bucket batch, the live-alignment sim's
    batch p50 (phase 7) and the readfish loop's chunks/s (phase 17's
    loop)."""
    reads, al, buckets = link_aligner(dev, paths)
    rows = dispatch_check(al, reads)
    map_ms = [host_ms(lambda: al.map_sequences(reads), reps=1, warm=0) for _ in range(5)]
    log(f"seed link: {len(reads)} reads over buckets {buckets}, ~{LINK_SLEEP_MS:.0f} ms sleep "
        f"queued before the loop: {fmt_dispatch(rows)}; map_sequences p50 "
        f"{statistics.median(map_ms):.1f} ms ({', '.join(f'{t:.1f}' for t in map_ms)}) [{card}]")
    live = run_live_align_sim(dev, card, work, paths)
    rf = run_readfish(dev, card, work, paths, read_corpus_reads(paths, N_READS))
    return dict(dispatch=rows, map_ms=map_ms, live_batch_p50_ms=live["batch_p50_ms"],
                chunks_per_s=rf["chunks_per_s"])


def link_turn_main() -> None:
    """One turn of the seed link's comparison with an earlier commit, from
    the root of either tree: ``python3 -c 'import chip_smoke;
    chip_smoke.link_turn_main()'`` (this file copied into the older tree)."""
    global SM_CLOCK_MHZ
    from bossruns_torch.device import require_cuda
    from bossruns_torch.ops import kernels

    dev = require_cuda()
    card = card_line()
    SM_CLOCK_MHZ = sm_clock_mhz()
    kernels.build()
    kernels.load()
    with tempfile.TemporaryDirectory(prefix="bossruns_link_") as tmp:
        paths = write_smoke_corpus(Path(tmp))
        out = link_turn(dev, card, Path(tmp), paths)
    log(f"seed link turn: {json.dumps(out)} [{card}]")


def check_seed_link(dev, card: str, paths: dict, live: dict | None, rf: dict | None) -> None:
    """Phase 22: the seeding link on the card. The library's host encode
    and pack (bk_pack_rows) equal NumPy's on a multi-bucket batch;
    every bucket of a map_sequences call is queued before the first pull (the
    dispatch loop behind a queued sleep takes under 10% of it in host
    time); one 4096 x 512 bucket's upload packed into pinned staging
    against the int8 matrix's pageable copy, in turns; map_sequences p50
    on that batch, its records equal to the plain seeding's on the card;
    and the live-alignment sim's batch p50 and the readfish loop's chunks/s
    of phases 7 and 17, where they ran, beside the numbers before."""
    from bossruns_torch.aligner import bucket_of, length_groups
    from bossruns_torch.aligner import seed as S

    reads, al, buckets = link_aligner(dev, paths)
    if len(buckets) < 4:
        raise AssertionError(f"seed link: the batch fills only buckets {buckets}")
    # the batch's encode and pack in one pass: the library's host loop (the
    # card's index, into pinned staging) against NumPy (a CPU index), byte
    # for byte, codes and payload, host clock in turns
    text = "".join(reads.values()).encode()
    lens = np.array([len(r) for r in reads.values()], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    calls = [(offs[g], lens[g], bucket_of(int(lens[g].max()))) for g in length_groups(lens)]
    sides = {True: al.dev_index, False: S.DeviceIndex(al.index, "cpu")}
    enc_ms, got = {True: [], False: []}, {}
    for card_side in (True, False, True, False, True):
        t0 = time.perf_counter()
        got[card_side] = S.encode_rows(text, calls, sides[card_side])
        enc_ms[card_side].append(1000 * (time.perf_counter() - t0))
    (c1, (_, p1)), (c0, (_, p0)) = got[True], got[False]
    if not np.array_equal(c1, c0) or any(a.tobytes() != b.tobytes() for a, b in zip(p1, p0)):
        raise AssertionError("seed link: the host encode and pack (bk_pack_rows) differ from "
                             "NumPy's")
    log(f"seed link encode + pack of {len(reads)} reads ({len(text)} bases, {len(calls)} seeding "
        f"calls), codes and payload equal to NumPy's, host clock in turns: bk_pack_rows "
        f"{', '.join(f'{t:.2f}' for t in enc_ms[True])} ms; NumPy (_ENC, padded matrix, "
        f"pack_reads) {', '.join(f'{t:.2f}' for t in enc_ms[False])} ms [{card}]")

    rows = dispatch_check(al, reads)
    log(f"seed link dispatch, {len(reads)} reads over buckets {buckets}, ~{LINK_SLEEP_MS:.0f} ms "
        f"sleep queued before the loop: {fmt_dispatch(rows)} [{card}]")
    slow = [r for r in rows if r["dispatch_ms"] >= 0.1 * r["sleep_ms"]]
    if slow:
        raise AssertionError(f"seed link: the dispatch loop waited behind the sleep: {slow}")

    # one bucket's upload, host clock to a synchronize, in turns
    di = al.dev_index
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 4, (4096, 512)).astype(np.int8)
    mat[:, 400:] = 4

    def packed():
        (x,) = S.upload_reads([mat], di)
        return x

    def pageable():
        return torch.from_numpy(mat).to(dev)

    if not torch.equal(S.unpack_reads(packed(), 512), pageable()):
        raise AssertionError("seed link: the packed upload does not decode to the reads")
    up = {"packed": [], "pageable": []}
    for order in (("packed", "pageable"), ("pageable", "packed")) * 2:
        for name in order:
            up[name].append(host_ms(packed if name == "packed" else pageable))
    log(f"upload of one 4096 x 512 bucket, host clock to a synchronize, in turns: packed into "
        f"pinned staging + one non-blocking copy ({mat.nbytes // 2} B) "
        f"{', '.join(f'{t:.3f}' for t in up['packed'])} ms; the int8 matrix's pageable copy "
        f"({mat.nbytes} B) {', '.join(f'{t:.3f}' for t in up['pageable'])} ms [{card}]")

    # map_sequences p50, and its records against the plain seeding's
    (rec, _) = count_path(f"seed link: map_sequences, {len(reads)} reads",
                          lambda: al.map_sequences(reads), ("seed_topn",))
    map_ms = [host_ms(lambda: al.map_sequences(reads), reps=1, warm=0) for _ in range(5)]
    kernel = S.seed_topn
    S.seed_topn = S.seed_topn_plain  # the dispatch reads it at each call
    try:
        plain = al.map_sequences(reads)
    finally:
        S.seed_topn = kernel
    same_records(rec, plain, "seed link map_sequences (H5 vs the plain seeding on the card)")
    log(f"seed link map_sequences: {len(reads)} reads, {len(rec)} records equal to the plain "
        f"seeding's; p50 {statistics.median(map_ms):.1f} ms "
        f"({', '.join(f'{t:.1f}' for t in map_ms)}) [{card}]")
    if live is not None:
        log(f"live-alignment sim batch p50 (phase 7): {live['batch_p50_ms']:.1f} ms [{card}]")
    if rf is not None:
        log(f"readfish loop (phase 17): {rf['chunks_per_s']:.1f} chunks/s; before the packed "
            f"link {READFISH_PARENT[0]:,}-{READFISH_PARENT[1]:,} chunks/s (PERF.md) [{card}]")


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


ALL_PHASES = range(3, 23)


def parse_phases(argv: list[str]) -> set[int]:
    """``--phases 3,13,14``: run only those phases (a timing run, which
    prints no kernel table and no ok line). Default: every phase."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="", help="comma-separated phase numbers (3-22)")
    a = ap.parse_args(argv)
    phases = {int(x) for x in a.phases.split(",") if x} or set(ALL_PHASES)
    if not phases <= set(ALL_PHASES):
        ap.error(f"phases are 3-22, got {sorted(phases)}")
    if 15 in phases and 4 not in phases:
        ap.error("phase 15 compares against the sims of phase 4")
    if 12 in phases and 11 not in phases:
        ap.error("phase 12 runs on the corpus of phase 11")
    return phases


def write_smoke_corpus(work: Path) -> dict:
    """The 8.05 Mb corpus of phases 4-8, 17 and 22 under ``work``."""
    from bossruns_torch.utils.datagen import write_corpus

    t0 = time.perf_counter()
    paths = write_corpus(work / "data", rng=np.random.default_rng(3), contig_lengths=GENOME,
                         n_reads=N_READS * (N_BATCHES + 1), mean_len=float(MEAN_LEN))
    log(f"corpus: {sum(GENOME.values())} sites, {N_READS * (N_BATCHES + 1)} reads, "
        f"written in {time.perf_counter() - t0:.1f} s")
    return paths


def main(argv: list[str]) -> int:
    global SM_CLOCK_MHZ
    phases = parse_phases(argv)
    full = phases == set(ALL_PHASES)
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

    res, sl, live, aeons, chrom, rf = {}, None, None, None, None, None
    if 3 in phases:
        res = check_kernels(dev, card)
    with tempfile.TemporaryDirectory(prefix="bossruns_smoke_") as tmp:
        work = Path(tmp)
        if phases & {4, 5, 6, 7, 8, 17, 22}:
            paths = write_smoke_corpus(work)
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
        if phases & {13, 14, 18, 19, 21}:
            t0 = time.perf_counter()
            genome = chrom_genome(np.random.default_rng(12))
            log(f"chromosome genome: {CHR1_SITES} sites made in {time.perf_counter() - t0:.1f} s")
            if 13 in phases:
                res.update(check_shard_kernels(dev, card, genome))
            if 14 in phases:
                chrom = run_chromosome(dev, card, genome)
            if 18 in phases:  # phase 18's chromosome part, while the genome is at hand
                run_options_chromosome(dev, card, genome)
            if 19 in phases:  # and phase 19's
                run_options_chromosome(dev, card, genome, F16_CHR)
            if 21 in phases:  # and phase 21's
                graphs_chrom = graphs_chromosome(dev, card, genome)
            del genome
        if 15 in phases:
            run_mesh_paths(dev, card, work, paths, sl)
        if 16 in phases:
            check_decisions(dev, card)
            run_conformance(dev, card, work)
        if 17 in phases:
            check_prepare(dev, card, work, paths)
            rf = run_readfish(dev, card, work, paths, seqs)
        if 18 in phases:
            opt = check_options(dev, card)
        if 19 in phases:
            f16 = check_f16(dev, card)
        if 20 in phases:
            run_scoreboard(card, work)
        if 21 in phases:
            graphs = check_graphs(dev, card)
        if 22 in phases:
            check_seed_link(dev, card, paths, live, rf)
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
    res["site_scores"]["modes"]["chromosome single"] = chrom["h2_modes"]
    table = {"kernels": [
        {"name": k, "route": "cuda", "source": f"bossruns_torch/{src}", "replaces": rep,
         "launches": counts[k], "max_abs_err": res[k]["max_abs_err"],
         "ms": res[k]["ms"], "device_ms": res[k]["device_ms"], "plain_ms": res[k]["plain_ms"],
         "bound_ms": res[k]["bound_ms"], "bound_by": res[k]["bound_by"], "library_ms": None,
         "split": res[k]["split"], **({"shape": res[k]["shape"]} if "shape" in res[k] else {}),
         **({"modes": res[k]["modes"]} if "modes" in res[k] else {})}
        for k, (src, rep) in meta.items()
    ]}
    # phase 18's variants: launches from their option's run (the 8.05 Mb
    # engine for H2-H4, the (2, 2) mesh for H8)
    for k, (entry, name, src, rep) in (*OPTION_ROWS.items(), *F16_ROWS.items()):
        o = opt if k in OPTION_ROWS else f16
        r = o["rows"][k]
        table["kernels"].append(
            {"name": k, "route": "cuda", "source": f"bossruns_torch/{src}", "replaces": rep,
             "launches": r.get("launches", o["launches"][name].get(entry)),
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "device_ms": r["device_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": None, "split": r["split"]})
        res[k] = r
    for row in table["kernels"]:
        if not row["launches"]:
            raise AssertionError(f"{row['name']} was never launched on its path")
    for k in (*meta, *OPTION_ROWS, *F16_ROWS):
        log(f"bound {k}: {res[k]['bytes']} bytes -> {res[k]['bound_ms']:.4f} ms "
            f"({res[k]['bound_by']}); kernel {res[k]['ms']:.4f} ms, device "
            f"{res[k]['device_ms']:.4f} ms")
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
