"""The live update after mapping, back to back (``RunsEngine``).

The chain ``models/experiment.BossRuns.process_reads`` runs once reads are
mapped: ``step_from_numpy`` (pack the batch into pinned staging, one
upload, the step), ``pull_aux``, and, when the strategy updated,
``strat_dict`` and ``write_strategy_npz``. Set-up draws the genome and a
dense mid-run coverage on the device from the seed, ``files`` files of
``reads_per_file`` mapped reads on the host, builds the program's layout,
engine and batches (``split_runs``, the port's host data plane), and runs
``warm_passes`` passes over the files, so that every batch's graph tier is
captured. A cycle is one update with one file's reads, the files taken in
turn. Before each pass over the files the harness copies the saved
mid-run state back on the device (a ``restore`` span inside the window,
left out of the window's time and of the device's busy time), so the
work of a cycle repeats with its file and does not drift with the number
of cycles a run reaches; the saved copy is left out of
``device_peak_gib``.

The check runs the reference's pass over the files from the same state
and holds against it every cycle's threshold, the published strategy of
cycles drawn from the seed and of the file the program left, and the
program's state at the window's close.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter

import numpy as np
import torch

from benchmark import compare, work
from benchmark.harness import Run
from benchmark.reference.layout import Genome
from benchmark.reference.runs import Reference
from benchmark.traffic import generate

#: the CCL pieces and time cost of the conformance drives (a 3.5 kb read
#: distribution), the step's parameters in every cycle
CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
TIME_COST = 5300.0


def inputs(env) -> dict:
    """The cell's inputs from the seed: genome, dense coverage, the files
    of reads."""
    cfg, tr, dev = env.config, env.traffic, env.device
    contigs = generate.chrom_genome(cfg["contigs"],
                                    torch.Generator(device=dev).manual_seed(env.seed), dev)
    genome = Genome(contigs, n_barcodes=1)
    rng = np.random.default_rng(env.seed)
    r = tr["reads"]
    files = [generate.chrom_reads(rng, contigs, tr["reads_per_file"], r["mean_len"],
                                  r["sd_len"], r["min_len"], r["max_len"], tuple(tr["hot"]),
                                  tr["hot_share"], r["error_rate"])
             for _ in range(tr["files"])]
    return dict(contigs=contigs, genome=genome, files=files)


def dense_state(env, genome: Genome) -> torch.Tensor:
    gen = torch.Generator(device=env.device).manual_seed(env.seed + 1)
    valid = torch.as_tensor(genome.site_valid, device=env.device)
    seq = torch.as_tensor(genome.seq, device=env.device)
    return generate.dense_coverage(valid, seq, gen)


def program_batch(layout, reads: dict) -> dict:
    """The program's host batch of the raw reads: match runs and explicit
    observations (``split_runs``, padded) and the accepted reads' read-start
    rows, as the live path's packer builds them."""
    from bossruns_torch.io.coo_native import pad_split, split_runs
    from bossruns_torch.models.layout import FHAT_WINDOW

    cid, start, n, strand = reads["cid"], reads["start"], reads["length"], reads["strand"]
    split = split_runs(layout, reads["sym"], np.full(reads["sym"].shape[0], 40, np.int8),
                       layout.offsets[cid] + start, n.astype(np.int32),
                       reads["bc"].astype(np.int32))
    pos = np.where(strand == 1, start + n, start)
    wf = layout.lengths[cid] // FHAT_WINDOW
    ok = (wf > 0) & (pos <= FHAT_WINDOW * wf)
    rows = (layout.fhat_offsets[cid] + np.minimum(pos // FHAT_WINDOW, wf - 1))[ok]
    m = 512
    while m < rows.shape[0]:
        m *= 2
    rs_row, rs_strand, rs_w = (np.zeros(m, np.int32), np.zeros(m, np.int32),
                               np.zeros(m, np.float32))
    rs_row[: rows.shape[0]] = rows
    rs_strand[: rows.shape[0]] = strand[ok]
    rs_w[: rows.shape[0]] = 1.0
    return dict(pad_split(split), rs_row=rs_row, rs_strand=rs_strand, rs_w=rs_w)


def reference_pass(env, genome: Genome, files: list, score_dtype, strat_at: set,
                   state_at: int, on_state) -> dict:
    """The reference's pass over the files from the cell's mid-run state:
    the threshold after each file, the published strategy after the files
    in ``strat_at``, ``on_state(state)`` after file ``state_at``, and the
    work of each update (observations changed, sites contracted)."""
    dev = env.device
    R = Reference(genome, env.config["ploidy"], dev, score_dtype=score_dtype)
    state = R.init_state()
    state["coverage"].copy_(dense_state(env, genome).to(torch.int32))
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    out = dict(thresholds=[], strats={}, changed=[], contracted=[], on_state=None,
               len_b=R.len_b, len_g=R.phi.shape[1])
    for k, reads in enumerate(files):
        n = t(reads["length"])
        first = t(genome.offsets[reads["cid"]] + reads["start"]).repeat_interleave(n)
        within = (torch.arange(int(n.sum()), device=dev)
                  - (torch.cumsum(n, 0) - n).repeat_interleave(n))
        bc = t(reads["bc"]).repeat_interleave(n)
        obs = (bc * 5 + t(reads["sym"]).long()) * genome.G + first + within
        pos = np.where(reads["strand"] == 1, reads["start"] + reads["length"], reads["start"])
        rows = genome.fhat_row(reads["cid"], pos)
        thr = R.step(state, obs, t(rows), t(reads["strand"]),
                     torch.ones(rows.shape[0], dtype=torch.float64, device=dev), CCL,
                     float(np.float32(TIME_COST)))
        out["thresholds"].append(thr)
        if k in strat_at:
            out["strats"][k] = R.strat_dict(state)
        if k == state_at:
            out["on_state"] = on_state(state)
        cov = state["coverage"]
        out["changed"].append(int(torch.unique(obs).numel()))
        out["contracted"].append(int(((cov[:, :R.len_b] != 0).any(dim=1)
                                      & (cov.sum(dim=1) < 30) & R.site_valid[None]).sum()))
    del R, state
    return out


def drive(env) -> Run:
    from bossruns_torch.models.layout import build_layout
    from bossruns_torch.models.runs import RunsConfig, RunsEngine
    from bossruns_torch.ops.model import make_model
    from bossruns_torch.utils.misc import read_strategy_npz, write_strategy_npz

    cfg, tr, dev = env.config, env.traffic, env.device
    inp = inputs(env)
    genome, files = inp["genome"], inp["files"]
    dense = dense_state(env, genome)
    env.reset_peak()
    layout = build_layout(inp["contigs"], n_barcodes=1)
    engine = RunsEngine(layout, make_model(ploidy=cfg["ploidy"]), RunsConfig(), device=dev)
    batches = [program_batch(layout, reads) for reads in files]
    period = len(batches)
    state = engine.init_state()
    state.coverage.copy_(dense)
    saved = [dense] + [t.clone() for t in state[1:]]
    harness_bytes = sum(t.numel() * t.element_size() for t in saved)
    out_dir = env.work / "live"
    wire_bytes = [work.batch_bytes(b) for b in batches]

    def restore():
        for t, s in zip(state, saved):
            t.copy_(s)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def cycle(spans, batch):
        with spans("step"):
            params = engine.make_params(CCL, TIME_COST)
            _, aux = engine.step_from_numpy(state, batch, params)
        with spans("pull"):
            ah = engine.pull_aux(aux)
        strat = None
        with spans("mask"):
            if ah.updated:
                strat = engine.strat_dict(state)
                write_strategy_npz(out_dir, strat)
        return ah, strat

    for _ in range(tr["warm_passes"]):
        restore()
        for batch in batches:
            cycle(lambda name: contextlib.nullcontext(), batch)
    graphs0 = engine.graphs.stats() if engine.graphs is not None else None
    rng = np.random.default_rng(env.seed)
    sampled = set(int(k) for k in rng.integers(0, tr["check_among_first"], tr["check_cycles"]))
    cycles, thresholds, updated, kept = [], [], [], {}
    with env.window() as w:
        k, last_end = 0, None
        while last_end is None or last_end < w.due:
            if k % period == 0:
                with env.span("restore"):
                    restore()
            t0 = time.perf_counter()
            ah, strat = cycle(env.span, batches[k % period])
            last_end = time.perf_counter()
            cycles.append((t0, last_end, int(files[k % period]["length"].shape[0])))
            thresholds.append(ah.threshold)
            updated.append(ah.updated)
            if k in sampled:
                kept[k] = strat
            k += 1
        w.close(last_end)
    counters = {}
    if engine.graphs is not None:
        g1 = engine.graphs.stats()
        counters = {key: sum(g1[key].values()) - sum(graphs0[key].values())
                    for key in ("replays", "eager")}
    final_state = engine.state_numpy(state)
    final_phase = (len(cycles) - 1) % period
    published = read_strategy_npz(out_dir / "masks" / "boss.npz")
    del engine, state, saved, dense, batches, layout
    extra = dict(cycle_kinds=[i % period for i in range(len(cycles))])

    def check(control: bool):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        lim = env.limits
        strat_at = {k % period for k in kept} | {final_phase}
        host = lambda st: {key: v.to("cpu", copy=True).numpy() for key, v in st.items()}
        ref = reference_pass(env, genome, files, torch.float64, strat_at, final_phase,
                             host if control else
                             lambda st: compare.state_mismatch(final_state, st,
                                                               genome.n_buckets, genome.n_fhat))
        least = []
        for k in range(period):
            n_bytes = work.update_bytes(genome.G, 1, genome.Gd, genome.n_buckets,
                                        genome.n_fhat, wire_bytes[k], ref["changed"][k])
            flops, sfu = work.score_ops(ref["contracted"][k], ref["len_b"], ref["len_g"])
            least.append(work.least_time_s(n_bytes, flops, sfu))
        extra["work"] = dict(least=(float(np.mean([x[0] for x in least])),
                                    Counter(x[1] for x in least).most_common(1)[0][0]))
        total = sum(v.size for v in ref["strats"][final_phase].values())

        def numbers(strats, thrs, st):
            """strats: [(phase, strategy)], thrs: [(phase, threshold)]."""
            worst = max(compare.strat_rows_differ(s, ref["strats"][p])[0] for p, s in strats)
            gap = max(compare.rel_gap(x, ref["thresholds"][p]) for p, x in thrs)
            return [("state_mismatch", float(st), lim["state_mismatch"]),
                    ("strat_mismatch_share", worst / total, lim["strat_mismatch_share"]),
                    ("threshold_rel_gap", gap, lim["threshold_rel_gap"])]

        st = (compare.state_mismatch(final_state, ref["on_state"], genome.n_buckets,
                                     genome.n_fhat) if control else ref["on_state"])
        strats = ([(k % period, s if s is not None else {}) for k, s in kept.items()]
                  + [(final_phase, published)])
        checks = numbers(strats, [(i % period, x) for i, x in enumerate(thresholds)], st)
        checks.append(("cycles_not_updated", float(len(updated) - sum(updated)),
                       lim["cycles_not_updated"]))
        ctl = None
        if control:
            ref_state = ref["on_state"]
            c = reference_pass(env, genome, files, torch.bfloat16, strat_at, final_phase,
                               lambda s: compare.state_mismatch(ref_state, host(s),
                                                                genome.n_buckets, genome.n_fhat))
            ctl = numbers(sorted(c["strats"].items()), list(enumerate(c["thresholds"])),
                          c["on_state"])
        return checks, ctl

    return Run(cycles=cycles, counters=counters, check=check, harness_device_bytes=harness_bytes,
               extra=extra)
