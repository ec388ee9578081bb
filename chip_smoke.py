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
     assembly.
Each driven path (4, 7, 8, 11, 12) runs with the launch counts set to 0
just before it and read just after. The last three lines are the kernel
table, the card and {"ok": true, "device": ...}. Nothing here imports JAX
or the JAX package.
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

    return dict(launches=launches, phase=phase, sim_s=sim_s)


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
            mapped = float((got[2] >= 3).float().mean())
            log(f"H5 seed_topn k{k} w{w} {label} L={L} R={len(reads)} budget {b}: all 24 rows exact, "
                f"candidate 0 voted >= 3 for {mapped:.3f} of reads; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms [{card}]")
            res[(k, w, label)] = dict(ms=ms, plain_ms=plain_ms)
    # the main path's shape: the sim's decision pass (k13/w5, prefixes)
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
        hit = float((got[:, 0] >= 4).any(dim=1).float().mean())
        log(f"H6 seed_candidates L={L} R={len(q)} tol {tol}: all 48 entries of every row exact, "
            f"{hit:.3f} of reads with a cluster of >= 4 votes; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms [{card}]")
        res[L] = dict(ms=ms, plain_ms=plain_ms)
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
            res[(n_contigs, hi)] = dict(ms=ms, plain_ms=plain_ms)
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
        work = Path(tmp)
        from bossruns_torch.utils.datagen import write_corpus

        t0 = time.perf_counter()
        paths = write_corpus(work / "data", rng=np.random.default_rng(3), contig_lengths=GENOME,
                             n_reads=N_READS * (N_BATCHES + 1), mean_len=float(MEAN_LEN))
        log(f"corpus: {sum(GENOME.values())} sites, {N_READS * (N_BATCHES + 1)} reads, "
            f"written in {time.perf_counter() - t0:.1f} s")
        sl = run_slice(dev, card, work, paths)
        seqs = read_corpus_reads(paths, N_READS)
        res["seed_topn"] = check_seed_kernel(dev, card, paths, seqs)
        check_aligner(dev, card, paths, seqs)
        live = run_live_align_sim(dev, card, work, paths)
        run_live_experiment(dev, work, paths)
        res["seed_candidates"] = check_ava(dev, card)
        res["aeons_strategy"] = check_aeons_strategy(dev, card)
        aeons = run_aeons_sim(dev, card, work)
        run_aeons_live(dev, card, work, aeons["paths"])
    if "jax" in sys.modules or any(m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")

    meta = {
        "coverage_update": ("csrc/coverage.cu", "bossruns_tpu/models/runs.py:518"),
        "site_scores": ("csrc/scores.cu", "bossruns_tpu/ops/scores.py:102"),
        "row_stage": ("csrc/rows.cu", "bossruns_tpu/models/runs.py:592"),
        "benefit_strategy": ("csrc/strategy.cu", "bossruns_tpu/ops/genome_ops.py:88"),
        "seed_topn": ("csrc/seed.cu", "bossruns_tpu/aligner/seed.py:273"),
        "seed_candidates": ("csrc/seed.cu", "bossruns_tpu/aligner/seed.py:410"),
        "aeons_strategy": ("csrc/aeons_strategy.cu", "bossruns_tpu/aeons/benefit.py:53"),
    }
    # H1-H4 count the gated sim's launches (path 4), H5 the live-alignment
    # sim's (path 7), H6 and H7 the AEONS sim's (path 11)
    counts = dict(sl["launches"], seed_topn=live["launches"]["seed_topn"],
                  seed_candidates=aeons["launches"]["seed_candidates"],
                  aeons_strategy=aeons["launches"]["aeons_strategy"])
    table = {"kernels": [
        {"name": k, "route": "cuda", "source": f"bossruns_torch/{src}", "replaces": rep,
         "launches": counts[k], "max_abs_err": res[k]["max_abs_err"],
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
