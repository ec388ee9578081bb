"""Consecutive simulated experiments over precomputed PAFs (``BossRunsSim``).

Set-up writes the corpus once per checkout (the traffic file's pool of
reads, with full and truncated PAFs), runs ``batches_per_epoch - 1``
batches of one experiment as the warm-up (every kernel and graph tier of
a batch, short of the tenth batch's checkpoint, which compiles nothing)
and reads the pool's files once. The window then runs experiments back to
back, each a new ``BossRunsSim`` through its public constructor, whose
sampler draws its batches from the pool by the program's own shuffle
(``io/sampler.FastqStream``, ``shuffle=True``) with a seed drawn from the
run's ``--seed``: every seed samples batches of the same pool's reads, in
another order and mix. Each experiment runs ``batches_per_epoch`` batches
of ``batchsize`` reads and then ``cleanup()`` (the read dumps' flush), as
``BossRunsSim.run`` does. A cycle is one ``process_batch``: the batch is
handed to the program, decided, stepped, its strategy published and,
every tenth batch, the state checkpointed. The constructors and the
flushes lie inside the window, which ends with the first experiment that
ends ``--seconds`` or more after it began: whole experiments only, so
that every run holds the same share of checkpointed batches.

The check replays one experiment of the window, drawn from the seed,
through the reference (``reference/dataplane.py`` and ``reference/runs.py``)
from its reads (the sampler's plan, taken before its first batch) and the
program's decisions, read back from the read dumps the program wrote:
after each batch the published strategy and threshold, after the tenth the
checkpointed state, and each decision against the reference's own
strategy.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import compare
from benchmark.harness import CACHE, Run
from benchmark.reference import dataplane as dp
from benchmark.reference.layout import Genome
from benchmark.reference.runs import Reference
from benchmark.traffic import generate


def drive(env) -> Run:
    from bossruns_torch.io.sampler import FastqStream
    from bossruns_torch.models.runs_sim import BossRunsSim

    cfg, tr, dev = env.config, env.traffic, env.device
    paths = generate.write_corpus(CACHE / "corpus", cfg, tr)
    env.reset_peak()
    E, bs = tr["batches_per_epoch"], tr["batchsize"]
    rng = np.random.default_rng(env.seed)
    out = env.work / "sim"

    def make(tag: str):
        """A new experiment whose sampler shuffles the pool with a seed
        drawn from the run's; with the sampler's plan of offsets."""
        s = 1 + int(rng.integers(2 ** 31 - 2))
        sim = BossRunsSim(ref=paths["ref"], fq=paths["fq"], paf_full=paths["paf_full"],
                          paf_trunc=paths["paf_trunc"], name="sim", batchsize=bs, maxb=E,
                          out_base=out / tag, seed=s, ploidy=cfg["ploidy"], device=dev)
        sim.sampler.fq_stream = FastqStream(paths["fq"], batchsize=bs, maxbatch=E, seed=s,
                                            shuffle=True)
        return sim, sim.sampler.fq_stream.offsets.copy()

    warm, _ = make("warm")
    for _ in range(E - 1):
        warm.process_batch()
    warm.cleanup()
    del warm
    shutil.rmtree(out / "warm", ignore_errors=True)
    # every experiment reads the pool at random: all of it into the page
    # cache, as a long experiment would have it
    for key in ("fq", "paf_full", "paf_trunc"):
        with open(paths[key], "rb") as fh:
            while fh.read(1 << 24):
                pass
    check_epoch = int(rng.integers(tr["check_among_first"]))

    cycles, epochs, kept = [], [], {}
    sim = None
    with env.window() as w:
        e, last_end, done = 0, None, False
        while not done:
            with env.span("epoch"):
                sim, plan = make(f"e{e}")
            for b in range(E):
                t0 = time.perf_counter()
                sim.process_batch()
                last_end = time.perf_counter()
                cycles.append((t0, last_end, bs))
                if e == check_epoch:
                    kept[b] = sim.strat_host
            epochs.append(dict(tag=f"e{e}", plan=plan, batches=E, graphs=_graph_stats(sim)))
            with env.span("cleanup"):
                sim.cleanup()
            last_end = time.perf_counter()
            sim = None
            done = last_end >= w.due and e >= check_epoch
            e += 1
        w.close(last_end)

    phases = []
    for ep in epochs:
        lines = (out / ep["tag"] / "out_sim" / "metrics" / "batches.jsonl").read_text()
        phases += [json.loads(x)["phases"] for x in lines.splitlines()[: ep["batches"]]]
    counters = {"replays": sum(sum(ep["graphs"]["replays"].values()) for ep in epochs
                               if ep["graphs"]),
                "eager": sum(sum(ep["graphs"]["eager"].values()) for ep in epochs
                             if ep["graphs"])}
    written = _bytes_under(out)
    print(f"sim: {len(epochs)} experiments, {len(cycles)} batches; {written / 2**30:.3f} GiB "
          f"under the run's output directory at the window's close", flush=True)
    ep = epochs[check_epoch]

    def check(control: bool):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res = _check(env, paths, ep["plan"], out / ep["tag"], kept, control)
        shutil.rmtree(out, ignore_errors=True)
        return res

    return Run(cycles=cycles, counters=counters, check=check,
               extra=dict(phases=phases, phase_spans=_phase_spans(cycles, phases)))


def _graph_stats(sim) -> dict | None:
    graphs = getattr(sim.engine, "graphs", None)
    return None if graphs is None else graphs.stats()


def _bytes_under(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _phase_spans(cycles, phases) -> list:
    """The sim's own phases of each cycle as host-clock spans, from the
    cycle's start; what follows ``write`` (the metrics line and the periodic
    checkpoint) is ``checkpoint``."""
    out = []
    for (t0, t1, _), ph in zip(cycles, phases):
        t = t0
        for name in ("sample", "align", "decide", "coo", "overlap", "device", "write"):
            d = float(ph.get(name, 0.0))
            if d > 0:
                out.append((name, t, t + d))
            t += d
        out.append(("checkpoint", t, t1))
    return out


def _dumped_lengths(reads_dir: Path) -> dict[str, int]:
    """rid -> length of the decided sequence in the program's read dumps."""
    out = {}
    for f in sorted(reads_dir.glob("boss_*.fa")):
        with open(f, "rb") as fh:
            for head in fh:
                seq = fh.readline()
                out[head[1:].split(b".", 1)[0].decode()] = len(seq.rstrip(b"\n"))
    return out


def _check(env, paths: dict, plan: np.ndarray, epoch_dir: Path, kept: dict, control: bool):
    cfg, tr, lim, dev = env.config, env.traffic, env.limits, env.device
    mu = tr["mu"]
    sim_dir = epoch_dir / "out_sim"
    logged = [json.loads(x) for x in
              (sim_dir / "metrics" / "batches.jsonl").read_text().splitlines()]
    n_batches = len(kept)
    fq, at = dp.read_fastq(paths["fq"], offsets=True)
    full = dp.read_paf(paths["paf_full"])
    trunc = dp.read_paf(paths["paf_trunc"])
    dumped = _dumped_lengths(epoch_dir / "00_reads")
    # batch b holds the reads at the plan's row b (the sampler reads each
    # batch's records in the order of their offsets)
    batches = [[at[int(o)] for o in np.sort(plan[b])] for b in range(n_batches)]
    genome = Genome(dp.read_fasta(paths["ref"]), n_barcodes=1)
    index = {n: (i, int(genome.lengths[i])) for i, n in enumerate(genome.names)}
    # the program's decisions: a rejected read was cut to mu bases; a read
    # without a truncated mapping is rejected whatever its dump says
    prog_acc = {r: r in trunc and dumped.get(r, -1) == len(fq[r])
                for batch in batches for r in batch}
    ckpt_at = 10 if n_batches >= 10 else None
    ckpt = None
    if ckpt_at is not None:
        with np.load(sim_dir / "checkpoint" / "state.npz") as z:
            ckpt = {k: z[k] for k in ("coverage", "zeroed", "bucket_on", "read_starts")}

    def replay(score_dtype):
        R = Reference(genome, cfg["ploidy"], dev, score_dtype=score_dtype)
        state = R.init_state()
        strat = R.strat_dict(state)
        rl = dp.ReadLengthDist(mu=mu)
        outs = []
        for b in range(n_batches):
            batch = batches[b]
            looked = {r: dp.decide(trunc.get(r), strat) for r in batch}
            recs, seqs, acc_len, rs_c, rs_s, rs_strand = [], [], [], [], [], []
            for r in batch:
                if prog_acc[r]:
                    if r in full:
                        f = full[r]
                        recs.append(f)
                        seqs.append(fq[r])
                        acc_len.append(f[0])
                        rs_c.append(index[f[4]][0])
                        rs_s.append(f[6] if f[3] else f[5])
                        rs_strand.append(int(f[3]))
                elif r in trunc:
                    recs.append(trunc[r])
                    seqs.append(fq[r][:mu])
            cid, site, sym = dp.expand(recs, seqs, index)
            obs = torch.as_tensor(sym * genome.G + genome.offsets[cid] + site, device=dev)
            rl.update(acc_len)
            rs_row = genome.fhat_row(np.asarray(rs_c, np.int64), np.asarray(rs_s, np.int64))
            t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
            thr = R.step(state, obs, t(rs_row, torch.int64), t(rs_strand, torch.int64),
                         t(np.ones(len(rs_strand)), torch.float64), rl.approx_ccl,
                         float(np.float32(rl.time_cost)))
            strat = R.strat_dict(state)
            outs.append(dict(looked=looked, strat=strat, threshold=thr,
                             state=({k: v.to("cpu", copy=True) for k, v in state.items()}
                                    if b + 1 == ckpt_at else None)))
        del R, state
        return outs

    def numbers(outs, ref=None):
        """Judge ``outs`` (the program's when ``ref`` is None, whose
        published outputs come from the run) against the reference's."""
        base = ref if ref is not None else reference
        n_dec = bad_dec = 0
        worst_rows, worst_thr, st = 0.0, 0.0, 0
        for b in range(n_batches):
            looked = base[b]["looked"]
            mine = outs[b]["looked"] if ref is not None else {r: prog_acc[r] for r in looked}
            n_dec += len(looked)
            bad_dec += sum(mine[r] != looked[r] for r in looked)
            strat = outs[b]["strat"] if ref is not None else kept[b]
            bad, total = compare.strat_rows_differ(strat, base[b]["strat"])
            worst_rows = max(worst_rows, bad / total)
            thr = outs[b]["threshold"] if ref is not None else float(logged[b]["threshold"])
            worst_thr = max(worst_thr, compare.rel_gap(thr, base[b]["threshold"]))
            if b + 1 == ckpt_at:
                prog_state = ({k: v.numpy() for k, v in outs[b]["state"].items()}
                              if ref is not None else ckpt)
                st = compare.state_mismatch(prog_state, base[b]["state"], genome.n_buckets,
                                            genome.n_fhat)
        return [("state_mismatch", float(st), lim["state_mismatch"]),
                ("strat_mismatch_share", worst_rows, lim["strat_mismatch_share"]),
                ("threshold_rel_gap", worst_thr, lim["threshold_rel_gap"]),
                ("decision_mismatch_share", bad_dec / max(n_dec, 1),
                 lim["decision_mismatch_share"])]

    reference = replay(torch.float64)
    checks = numbers(None)
    ctl = numbers(replay(torch.bfloat16), ref=reference) if control else None
    return checks, ctl

