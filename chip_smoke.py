"""On-card smoke run of the PyTorch/CUDA port (bossruns_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits nonzero:
  1. the card: torch version, nvidia-smi name and power limit;
  2. build the CUDA kernels from bossruns_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     8.05 Mb slice shape with a 4000-read batch (mean length 3500), with
     median times of both;
  4. the slice: a synthetic 8.05 Mb corpus through the port's gated
     BossRunsSim (4000-read batches), checked for strategy activation,
     rejections, enrichment, mask shapes, kernel launch counts and a
     checkpoint; the classic flow on the same corpus must agree exactly.
The last three lines are the kernel table, the card and
{"ok": true, "device": ...}. Nothing here imports JAX or the JAX package.
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


def exact(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    if a.shape != b.shape or not torch.equal(a, b):
        n = int((a != b).sum()) if a.shape == b.shape else -1
        raise AssertionError(f"{name}: kernel and plain differ ({n} elements)")


def max_abs_err(*pairs) -> float:
    """Largest |a - b| over pairs of same-shape tensors, in f64."""
    worst = 0.0
    for a, b in pairs:
        if a.dtype == torch.uint16:
            a, b = (x.view(torch.int16).to(torch.int32) & 0xFFFF for x in (a, b))
        worst = max(worst, float((a.to(torch.float64) - b.to(torch.float64)).abs().max()))
    return worst


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
        h1_err = max(h1_err, max_abs_err((ak["coverage"], ap["coverage"]), (ch_k, ch_p)))
        log(f"H1 coverage_update {label}: coverage and changed exact "
            f"({int(ch_k.sum())} sites changed)")
    args = eng.coverage_args(state, full)
    ak, ap = clone(args), clone(args)
    res["coverage_update"] = dict(
        ms=time_ms(lambda: gops.coverage_update(**ak)),
        plain_ms=time_ms(lambda: gops.coverage_update_plain(**ap)), max_abs_err=h1_err)

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
                              max_abs_err=float(err.max()))
    log(f"H2 site_scores: covsum exact, scores max abs err {float(err.max()):.3g} "
        "(rtol 1e-5, atol 1e-6: same f32 closed form, other summation order)")

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
                            max_abs_err=h3_err)

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
        plain_ms=time_ms(lambda: gops.benefit_strategy_plain(**cp)), max_abs_err=worst)

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
            log(f"time {k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms [{card}]")
    log(f"device step p50 (4000 reads, 8.05 Mb, host clock incl. aux pull): "
        f"{res['_step_p50_ms']:.3f} ms [{card}]")
    return res


def run_slice(dev, card: str, work: Path) -> dict:
    """Phase 4: the gated simulation and its classic twin."""
    from bossruns_torch.models.runs_sim import BossRunsSim
    from bossruns_torch.ops import kernels
    from bossruns_torch.utils.datagen import write_corpus
    from bossruns_torch.utils.misc import read_strategy_npz

    t0 = time.perf_counter()
    paths = write_corpus(work / "data", rng=np.random.default_rng(3), contig_lengths=GENOME,
                         n_reads=N_READS * (N_BATCHES + 1), mean_len=float(MEAN_LEN))
    log(f"corpus: {sum(GENOME.values())} sites, {N_READS * (N_BATCHES + 1)} reads, "
        f"written in {time.perf_counter() - t0:.1f} s")

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
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not bool(gsim.state.bucket_on.any()):
        raise AssertionError("no bucket switched on")
    strat = gsim.state.strat[:, gsim.engine.strat_valid, :]
    acc = float(strat.float().mean())
    if not acc < 1.0:
        raise AssertionError(f"accepted share of strategy rows {acc} is not below 1")
    tb, tc = gsim.read_cache.time_boss, gsim.read_cache.time_control
    if not tb < tc:
        raise AssertionError(f"time_boss {tb} !< time_control {tc}")
    masks = read_strategy_npz(gsim.out_dir / "masks" / "boss.npz")
    for name, L in GENOME.items():
        if masks[name].shape != (L // 100, 2, 1):
            raise AssertionError(f"mask {name} shape {masks[name].shape}")
    if not (gsim.out_dir / "checkpoint" / "state.npz").exists():
        raise AssertionError("no checkpoint written")
    phase = gsim.phase_p50_ms()
    log(f"gated sim checks: buckets on, accepted share {acc:.4f}, time_boss {tb} < "
        f"time_control {tc}, masks (len//100, 2, 1), checkpoint written")
    log(f"sim phase p50 ms: {json.dumps(phase)} [{card}]")
    gsim.cleanup()

    csim = make(False, "classic")
    for i, s in enumerate(snaps):
        csim.process_batch()
        exact(f"classic vs gated coverage, batch {i}", csim.state.coverage, s["cov"])
        exact(f"classic vs gated strat, batch {i}", csim.state.strat, s["strat"])
        exact(f"classic vs gated read_starts, batch {i}", csim.state.read_starts, s["rs"])
        if (csim.read_cache.time_boss, csim.read_cache.time_control) != (s["tb"], s["tc"]):
            raise AssertionError(f"classic vs gated pseudotime, batch {i}")
        if csim._last_decisions != s["dec"]:
            raise AssertionError(f"classic vs gated decisions, batch {i}")
    log(f"classic sim == gated sim exactly over {N_BATCHES} batches "
        f"(coverage, strat, read_starts, pseudotime, decisions)")
    csim.cleanup()

    return dict(launches=launches, phase=phase, sim_s=sim_s)


def main() -> int:
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
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    log(f"card: {card}")
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {so.name}")

    res = check_kernels(dev, card)
    with tempfile.TemporaryDirectory(prefix="bossruns_smoke_") as tmp:
        sl = run_slice(dev, card, Path(tmp))
    if "jax" in sys.modules or any(m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    meta = {
        "coverage_update": ("csrc/coverage.cu", "bossruns_tpu/models/runs.py:518"),
        "site_scores": ("csrc/scores.cu", "bossruns_tpu/ops/scores.py:102"),
        "row_stage": ("csrc/rows.cu", "bossruns_tpu/models/runs.py:592"),
        "benefit_strategy": ("csrc/strategy.cu", "bossruns_tpu/ops/genome_ops.py:88"),
    }
    table = {"kernels": [
        {"name": k, "route": "cuda", "source": f"bossruns_torch/{src}", "replaces": rep,
         "launches": sl["launches"][k], "max_abs_err": res[k]["max_abs_err"],
         "ms": res[k]["ms"], "plain_ms": res[k]["plain_ms"]}
        for k, (src, rep) in meta.items()
    ]}
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
