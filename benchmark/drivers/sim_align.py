"""Consecutive simulated experiments that map their reads live (``BossRunsSim``
without PAFs, the classic flow).

The pool is ``sim_epochs``' corpus (the configuration's ``pool`` names the
configuration it is written for, so a checkout holds it once); its PAFs
are never given to the program. Each experiment is a new ``BossRunsSim``
through its public constructor with ``paf_full`` and ``paf_trunc`` left
out, so the sim builds the port's aligner (``TorchAligner``: seeding
kernel H5 on the card, the host banded DP) with its own settings, which
the driver holds to the configuration's ``mapping`` (k, w, min_votes, mu
and min_len = mu / 2). Its sampler draws the batches from the pool by the
program's own shuffle with a seed drawn from the run's ``--seed``, as in
``sim_epochs``. A batch maps its reads' mu-base prefixes, decides, maps
the accepted reads at full length, steps, publishes the strategy and,
every tenth batch, checkpoints. Set-up runs ``batches_per_epoch - 1``
batches of one experiment (the first run on a checkout also builds the
index's cache beside the pool's FASTA and the kernels); the window then
runs experiments back to back and ends with the first experiment that
ends ``--seconds`` or more after it began.

The check replays one experiment of the window, drawn from the seed. The
plain reference aligner (``reference/align.py``) maps every read's prefix
and the reads the program accepted (read from its dumps) at full length;
its mappings, written as PAF files, then go through ``sim_epochs``'
replay: the program's decisions, each batch's strategy and threshold, the
tenth batch's checkpointed state and each decision judged against the
reference's own strategy. ``mapped_mismatch`` sums over the batches how
far the number of reads the program logged as mapped is from the number
whose prefix the reference maps. Under ``--trace 1`` the run also keeps
each seeding call's reads and length bucket (the program's
``align.dispatch`` spans) and H5's device time in the window, for
``seed_roofline_pct``.
"""
from __future__ import annotations

import json
import shutil
import sys
import time

import numpy as np
import torch

from benchmark.harness import CACHE, Run, load_module
from benchmark.reference import dataplane as dp
from benchmark.reference.align import RefAligner, best_paf
from benchmark.reference.layout import Genome
from benchmark.traffic import generate

_epochs = load_module("drivers", "sim_epochs")
#: H5's kernel in the device trace
H5_KERNEL = "seed_vote"


def drive(env) -> Run:
    from bossruns_torch.io.sampler import FastqStream
    from bossruns_torch.models.runs_sim import BossRunsSim

    cfg, tr, dev = env.config, env.traffic, env.device
    mp = cfg["mapping"]
    paths = generate.write_corpus(CACHE / "corpus", {**cfg, "name": cfg["pool"]}, tr)
    env.reset_peak()
    E, bs = tr["batches_per_epoch"], tr["batchsize"]
    rng = np.random.default_rng(env.seed)
    out = env.work / "sim"
    want = (mp["k"], mp["w"], mp["min_votes"], mp["mu"], tr["mu"], mp["min_len"])

    def make(tag: str):
        """A new experiment mapping live, whose sampler shuffles the pool
        with a seed drawn from the run's; with the sampler's plan."""
        s = 1 + int(rng.integers(2 ** 31 - 2))
        sim = BossRunsSim(ref=paths["ref"], fq=paths["fq"], name="sim", batchsize=bs, maxb=E,
                          out_base=out / tag, seed=s, ploidy=cfg["ploidy"], device=dev)
        al = sim.aligner
        got = None if al is None else (al.index.k, al.index.w, al.min_votes, al.mu, sim.mu,
                                       al.mu // 2)
        if got != want:
            raise RuntimeError(f"the sim maps with (k, w, min_votes, mu, mu, min_len) {got}, "
                               f"the configuration states {want}")
        sim.sampler.fq_stream = FastqStream(paths["fq"], batchsize=bs, maxbatch=E, seed=s,
                                            shuffle=True)
        return sim, sim.sampler.fq_stream.offsets.copy()

    warm, _ = make("warm")
    n_keys = int(warm.aligner.dev_index.keys.numel())
    for _ in range(E - 1):
        warm.process_batch()
    warm.cleanup()
    del warm
    shutil.rmtree(out / "warm", ignore_errors=True)
    with open(paths["fq"], "rb") as fh:  # the pool into the page cache
        while fh.read(1 << 24):
            pass
    check_epoch = int(rng.integers(tr["check_among_first"]))

    cycles, epochs, kept = [], [], {}
    sim = first = None
    with env.window() as w:
        e, last_end, done = 0, None, False
        while not done:
            with env.span("epoch"):
                sim, plan = make(f"e{e}")
            if e == check_epoch:
                first = sim.strat_host
            for b in range(E):
                t0 = time.perf_counter()
                sim.process_batch()
                last_end = time.perf_counter()
                cycles.append((t0, last_end, bs))
                if e == check_epoch:
                    kept[b] = sim.strat_host
            epochs.append(dict(tag=f"e{e}", plan=plan, batches=E,
                               graphs=_epochs._graph_stats(sim)))
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
    print(f"sim: {len(epochs)} experiments, {len(cycles)} batches; "
          f"{_epochs._bytes_under(out) / 2**30:.3f} GiB under the run's output directory at "
          f"the window's close", flush=True)
    extra = dict(phases=phases, phase_spans=_epochs._phase_spans(cycles, phases),
                 seed_calls=_seed_calls(env), n_keys=n_keys,
                 h5_device_s=_device_s(env.profile, H5_KERNEL))
    ep = epochs[check_epoch]

    def check(control: bool):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res = _check(env, paths, ep["plan"], out / ep["tag"], first, kept, control)
        shutil.rmtree(out, ignore_errors=True)
        return res

    return Run(cycles=cycles, counters=counters, check=check, extra=extra)


def _seed_calls(env) -> list:
    """(reads, length bucket) of every seeding call in the window, from the
    program's ``align.dispatch`` spans (none where it has no such span)."""
    try:
        from bossruns_torch.utils import spans
    except ImportError:
        return []
    return [tuple(c) for r in spans.recorded()
            if isinstance(r, spans.Span) and r.name == "align.dispatch" and r.attrs
            and env.window_start <= r.t0 < env.window_end for c in r.attrs.get("calls", ())]


def _device_s(prof, kernel: str) -> float | None:
    """Seconds the traced window's device spent in kernels named ``kernel``."""
    if prof is None:
        return None
    total = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += float(getattr(ev, "self_device_time_total", 0.0) or 0.0)
    return total / 1e6 if total > 0 else None


def _paf_lines(records: dict) -> str:
    return "".join(
        f"{rid}\t{r['qlen']}\t{r['qstart']}\t{r['qend']}\t{'-' if r['rev'] else '+'}\t"
        f"{r['tname']}\t{r['tlen']}\t{r['tstart']}\t{r['tend']}\t{r['nmatch']}\t"
        f"{r['blocklen']}\t{r['mapq']}\ttp:A:P\tAS:i:{r['align_score']}\tcg:Z:{r['cigar']}\n"
        for rid, recs in records.items() for r in recs)


def _check(env, paths: dict, plan: np.ndarray, epoch_dir, first: dict, kept: dict,
           control: bool):
    cfg, tr, lim, dev = env.config, env.traffic, env.limits, env.device
    mp = cfg["mapping"]
    t0 = time.perf_counter()
    n_batches = len(kept)
    fq, at = dp.read_fastq(paths["fq"], offsets=True)
    batches = [[at[int(o)] for o in np.sort(plan[b])] for b in range(n_batches)]
    reads = [r for batch in batches for r in batch]
    ref = RefAligner(Genome(dp.read_fasta(paths["ref"]), n_barcodes=1), mp["k"], mp["w"],
                     mp["min_votes"], dev, mu=mp["mu"])
    trunc_recs = ref.map({r: fq[r] for r in reads}, trunc=True, min_len=mp["min_len"])
    trunc = best_paf(trunc_recs)
    logged = [json.loads(x) for x in
              (epoch_dir / "out_sim" / "metrics" / "batches.jsonl").read_text().splitlines()]
    mapped_mismatch = sum(abs(int(logged[b]["n_mapped"]) - sum(r in trunc for r in batches[b]))
                          for b in range(n_batches))
    # the program's decisions: its read dumps hold an accepted read at full
    # length and a rejected one cut to mu bases; a read of at most mu bases
    # reads the same either way, and is decided here from the strategy the
    # program published before its batch
    dumped = _epochs._dumped_lengths(epoch_dir / "00_reads")
    published = [first] + [kept[b] for b in range(n_batches - 1)]
    accepted = [r for b, batch in enumerate(batches) for r in batch if r in trunc and (
        dumped.get(r, -1) == len(fq[r]) if len(fq[r]) > mp["mu"]
        else dp.decide(trunc[r], published[b]))]
    full_recs = ref.map({r: fq[r] for r in accepted}, trunc=False, min_len=mp["min_len"])
    del ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    truth = dp.read_paf(paths["paf_trunc"])
    judged = [r for r in reads if r in truth]
    on_locus = sum(r in trunc and trunc[r][3] == truth[r][3] and trunc[r][4] == truth[r][4]
                   and trunc[r][5] < truth[r][6] and truth[r][5] < trunc[r][6] for r in judged)
    print(f"reference aligner: {len(trunc)} of {len(reads)} prefixes mapped, "
          f"{on_locus / max(len(judged), 1):.4f} of {len(judged)} on their true locus; "
          f"{len(full_recs)} accepted reads, {len(best_paf(full_recs))} mapped at full length; "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    ref_paths = dict(paths, paf_full=str(env.work / "reference_full.paf"),
                     paf_trunc=str(env.work / "reference_trunc.paf"))
    with open(ref_paths["paf_full"], "w") as fh:
        fh.write(_paf_lines(full_recs))
    with open(ref_paths["paf_trunc"], "w") as fh:
        fh.write(_paf_lines(trunc_recs))
    # sim_epochs' replay reads the decisions from the dumps: it is given the
    # program's metrics and checkpoint beside dumps of the accepted reads alone
    decided = env.work / "decided"
    (decided / "00_reads").mkdir(parents=True)
    (decided / "out_sim").symlink_to(epoch_dir / "out_sim")
    with open(decided / "00_reads" / "boss_1.fa", "wb") as fh:
        fh.writelines(b">%s.0\n%s\n" % (r.encode(), fq[r]) for r in accepted)
    checks, ctl = _epochs._check(env, ref_paths, plan, decided, kept, control)
    checks.append(("mapped_mismatch", float(mapped_mismatch), lim["mapped_mismatch"]))
    if ctl is not None:  # the control's reference maps as the reference does
        ctl.append(("mapped_mismatch", 0.0, lim["mapped_mismatch"]))
    return checks, ctl
