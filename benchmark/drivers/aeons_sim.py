"""Passes of the reference-free sim (``BossAeonsSim``) from one assembled
state, at the upstream's AEONS defaults.

The pool is ``sim_epochs``' corpus (the configuration's ``pool`` names the
configuration it is written for, so a checkout holds it once); neither its
reference nor its PAFs is given to the program. Set-up builds the state
after the initial assembly once per checkout: a ``BossAeonsSim`` through
its public constructor, with the configuration's settings, draws
``binit`` batches in the corpus's order (not from ``--seed``), assembles
them, and the program's own ``save_checkpoint`` writes the state under
``CACHE`` beside the pool, keyed by the settings and a digest of the
program's sources. The device's peak counts from after that state. A resumed sim then runs one warm batch (the
card's kernels and the program's minimizer memo), out of the window.

A pass is a new ``BossAeonsSim`` resumed from that checkpoint (the
constructor with ``resume``, inside the harness's ``restore`` span, which
the window leaves out), whose sampler draws the reads the initial
assembly did not see in an order shuffled with a seed drawn from
``--seed``, as ``sim_epochs`` shuffles. It runs ``batches_per_pass``
batches back to back (binit + 1 to binit + batches_per_pass; the tenth
writes the program's checkpoint). A cycle is one ``process_batch`` of
``batchsize`` reads, closed loop. The window runs passes and ends with the
first batch that ends ``--seconds`` or more after it began (and not
before the checked batches have run).

The check covers ``check_among_first`` batches of the first pass, at
positions drawn from the seed. For them the driver keeps what the timed
path took in and gave out (references; the coverage the strategy read is
copied, as the pool adds to it in place): the batch's reads and the
program's decisions with the contigs and strategy in force when it
decided, each ``find_overlaps`` call's queries, pool and merged rows,
``contig_strategies``' contigs, coverage, ccl and lam with its mask and
threshold, and hard links of the ``contigs/aeons.fa`` and
``masks/boss.npz`` it wrote (the program renames new files over them).
``reference/aeons.py`` then recomputes the overlaps, the strategy and the
decisions, and reads the published files back. The link store's
classification, the containment increments and the unitig walk are taken
as the program produced them: they are the JAX package's host code,
copied, and held to it on the CPU. The control sums the strategy in
float32 over one prefix sum of the pool.

AEONS results depend on ``PYTHONHASHSEED`` (the pool and assembly code
iterate over sets of ids), so under ``python -m benchmark`` the driver
first re-executes the process with the same arguments and
``PYTHONHASHSEED=0`` unless it is already 0 (``hashseed.py``); ``setup_s``
then counts from the second process's start.

Under ``--trace 1`` the run also keeps the seeding calls (``ava.seed``),
the strategies' sizes (``aeons.strategy``) and H6's and H7's device time
in the window, for ``cand_roofline_pct`` and
``aeons_strategy_roofline_pct``, and hands ``trace.py`` the stage spans.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import CACHE, Run, load_module
from benchmark.hashseed import fix_hash_seed, main_is_benchmark
from benchmark.reference import aeons as RAE
from benchmark.traffic import generate

_align = load_module("drivers", "sim_align")
#: H6's kernel, and H7's four, in the device trace
H6_KERNEL, H7_KERNEL = "cand_vote", "aeons_"
#: the program's spans that make up a batch, for ``trace.py``
STAGES = ("aeons.draw", "aeons.decide", "aeons.ava", "aeons.graph", "aeons.assemble",
          "aeons.strategy", "aeons.write", "aeons.checkpoint")
NAME = "aeons"
#: the configuration's settings that are ``BossConfig.optional``'s
OPTIONAL = ("min_seq_len", "min_contig_len", "lowcov", "temperature", "min_s1", "min_map_len",
            "tetra", "filter_repeats")


def _args(cfg: dict, fq: str, maxb: int, resume: bool):
    from bossruns_torch.config import BossConfig

    a, opt = cfg["aeons"], BossConfig()
    opt.general.name = NAME
    opt.simulation.fq = fq
    opt.simulation.batchsize = a["batchsize"]
    opt.simulation.binit = a["binit"]
    opt.simulation.maxb = maxb
    for key in OPTIONAL:
        setattr(opt.optional, key, a[key])
    opt.optional.resume = resume
    return opt


def _check_settings(sim, cfg: dict) -> None:
    """Raise unless the sim runs at the configuration's settings (the
    decision mapper's are checked where a kept batch built it)."""
    rc = sim.read_cache
    got = dict(batchsize=sim.args.simulation.batchsize, binit=sim.args.simulation.binit,
               mu=rc.mu, alpha=rc.alpha, rho=rc.rho,
               **{k: getattr(sim.args.optional, k) for k in OPTIONAL})
    if got != cfg["aeons"]:
        raise RuntimeError(f"the sim runs at {got}, the configuration states {cfg['aeons']}")


def _program_digest() -> str:
    """A digest of the program's sources, which build the assembled state."""
    import bossruns_torch

    root = Path(bossruns_torch.__file__).parent
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.suffix in (".py", ".cu", ".cpp", ".h") and "_build" not in p.parts:
            h.update(p.relative_to(root).as_posix().encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _initial_state(cfg: dict, paths: dict, dev) -> Path:
    """The directory whose ``out_aeons/checkpoint/pool.pkl`` holds the state
    after the initial assembly, built once per checkout and program."""
    from bossruns_torch.aeons.simulation import BossAeonsSim

    key = json.dumps({"aeons": cfg["aeons"], "fq": Path(paths["fq"]).parent.name,
                      "hash_seed": os.environ.get("PYTHONHASHSEED"),
                      "program": _program_digest()}, sort_keys=True)
    root = CACHE / "aeons" / hashlib.sha256(key.encode()).hexdigest()[:12]
    done = root / ".complete"
    if done.exists() and done.read_text() == key:
        return root
    shutil.rmtree(root, ignore_errors=True)
    sim = BossAeonsSim(_args(cfg, paths["fq"], 1, False), out_base=root, device=dev)
    sim.save_checkpoint()
    print(f"aeons: initial assembly of {cfg['aeons']['binit']} batches: "
          f"{len(sim.pool.sequences)} sequences, "
          f"{len(sim.pool.declare_contigs(cfg['aeons']['min_contig_len']).sequences)} contigs",
          file=sys.stderr, flush=True)
    done.write_text(key)
    return root


class _Keep:
    """While entered, wraps what the sim's batch calls so that the inputs
    and outputs of its overlaps, strategy and decisions are kept."""

    def __init__(self, sim):
        from bossruns_torch.aeons import core

        self.sim, self.core = sim, core
        self.overlaps, self.targets = [], {}
        self.strategy = self.decide = None

    def __enter__(self):
        sim, core = self.sim, self.core
        self.orig = (core.find_overlaps, core.contig_strategies)
        find, strat = self.orig
        index = sim._pool_index
        decide = sim.make_decisions

        def pool_index(seqs):
            pidx = index(seqs)
            self.targets[id(pidx)] = seqs
            return pidx

        def find_overlaps(queries, pidx, **kw):
            rows = find(queries, pidx, **kw)
            self.overlaps.append((queries, self.targets.pop(id(pidx)), rows, kw))
            return rows

        def contig_strategies(contigs, ccl, lam, lowcov, **kw):
            out = strat(contigs, ccl=ccl, lam=lam, lowcov=lowcov, **kw)
            self.strategy = dict(
                contigs=[(h, s.cov.copy(), s.cap_l, s.cap_r) for h, s in contigs.items()],
                seqs={h: s.seq for h, s in contigs.items()}, ccl=np.array(ccl),
                lam=float(lam), lowcov=lowcov, kw=kw, strat=out[0], thr=out[1])
            return out

        def make_decisions(reads, *a, **kw):
            contigs = sim.pool.declare_contigs(sim.args.optional.min_contig_len).seqdict()
            strat = sim.strat
            out = decide(reads, *a, **kw)
            al = getattr(sim, "_decide_aligner", None) if strat else None
            self.decide = dict(reads=reads, out=out, contigs=contigs, strat=strat,
                               rejected=sim.reject_count, unmapped=sim.unmapped_count,
                               mapper=None if al is None else dict(
                                   k=al.index.k, w=al.index.w, min_votes=al.min_votes,
                                   mu=al.mu))
            return out

        core.find_overlaps, core.contig_strategies = find_overlaps, contig_strategies
        sim._pool_index, sim.make_decisions = pool_index, make_decisions
        return self

    def __exit__(self, *exc):
        self.core.find_overlaps, self.core.contig_strategies = self.orig
        del self.sim._pool_index, self.sim.make_decisions
        # what is kept is host data: the sim (and its device buffers) is
        # freed with its pass
        self.sim = self.core = self.orig = None
        return False


def drive(env) -> Run:
    if main_is_benchmark() and os.environ.get("PYTHONHASHSEED") != "0":
        os.rmdir(env.work)
        fix_hash_seed([sys.executable, "-m", "benchmark", *sys.argv[1:]])
    from bossruns_torch.aeons.simulation import BossAeonsSim
    from bossruns_torch.io.sampler import scan_fastq_offsets
    from bossruns_torch.utils import spans

    cfg, tr, dev = env.config, env.traffic, env.device
    E, bs, binit = tr["batches_per_pass"], cfg["aeons"]["batchsize"], cfg["aeons"]["binit"]
    paths = generate.write_corpus(CACHE / "corpus", {**cfg, "name": cfg["pool"]}, tr)
    state = _initial_state(cfg, paths, dev) / f"out_{NAME}" / "checkpoint" / "pool.pkl"
    gc.collect()
    # the peak from here on, whether or not this run built the state
    env.reset_peak()
    unseen = scan_fastq_offsets(paths["fq"])[binit * bs:]
    rng = np.random.default_rng(env.seed)
    out = env.work / "sim"

    def make(tag: str):
        """A sim resumed from the assembled state, drawing the unseen reads
        in an order shuffled with a seed drawn from the run's."""
        s = 1 + int(rng.integers(2 ** 31 - 2))
        ckpt = out / tag / f"out_{NAME}" / "checkpoint"
        ckpt.mkdir(parents=True)
        os.link(state, ckpt / "pool.pkl")
        sim = BossAeonsSim(_args(cfg, paths["fq"], E, True), out_base=out / tag, device=dev)
        if sim.batch != binit:
            raise RuntimeError(f"resumed at batch {sim.batch}, not {binit}")
        order = unseen.copy()
        np.random.default_rng(s).shuffle(order)
        sim.sampler.fq_stream.offsets = order[: E * bs].reshape(E, bs)
        return sim

    warm = make("warm")
    warm.process_batch()
    _check_settings(warm, cfg)
    del warm
    gc.collect()
    shutil.rmtree(out / "warm", ignore_errors=True)
    with open(paths["fq"], "rb") as fh:  # the pool into the page cache
        while fh.read(1 << 24):
            pass
    checked = sorted(int(b) for b in rng.choice(E, size=tr["check_among_first"],
                                                replace=False))
    kept, cycles, n_pass = [], [], 0
    links = env.work / "published"
    links.mkdir()
    with env.window() as w:
        last_end, done = None, False
        while not done:
            with env.span("restore"):
                gc.collect()    # the last pass's sim and its device buffers
                sim = make(f"p{n_pass}")
            for b in range(E):
                keep = _Keep(sim) if n_pass == 0 and b in checked else None
                t0 = time.perf_counter()
                if keep is None:
                    sim.process_batch()
                else:
                    with keep:
                        sim.process_batch()
                last_end = time.perf_counter()
                cycles.append((t0, last_end, bs))
                if keep is not None:
                    pub = [links / f"b{b}_aeons.fa", links / f"b{b}_boss.npz"]
                    os.link(sim.out_dir / "contigs" / "aeons.fa", pub[0])
                    os.link(sim.out_dir / "masks" / "boss.npz", pub[1])
                    kept.append((keep, pub))
                done = last_end >= w.due and len(kept) == len(checked)
                if done:
                    break
            sim = None
            n_pass += 1
        w.close(last_end)

    print(f"aeons: {n_pass} passes, {len(cycles)} batches; "
          f"{sum(p.stat().st_size for p in out.rglob('*') if p.is_file()) / 2**30:.3f} GiB "
          f"under the run's output directory at the window's close", flush=True)
    # every batch launches its own mix of kernels (its searches' seeding
    # calls): each cycle is a kind of its own for trace.py's lost-event test
    extra = dict(phase_spans=_stage_spans(spans, env), cycle_kinds=list(range(len(cycles))))
    if env.trace:
        _print_batches(spans, env)
        extra.update(ava_calls=_attrs(spans, env, "ava.seed", "calls"),
                     strategy_sizes=[(a.get("chunks", 0), a.get("contigs", 0))
                                     for a in _attrs(spans, env, "aeons.strategy")],
                     h6_device_s=_align._device_s(env.profile, H6_KERNEL),
                     h7_device_s=_align._device_s(env.profile, H7_KERNEL))

    def check(control: bool):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res = _check(env, kept, control)
        shutil.rmtree(out, ignore_errors=True)
        return res

    return Run(cycles=cycles, counters={}, check=check, extra=extra)


def _records(spans, env, name: str) -> list:
    return [r for r in spans.recorded() if isinstance(r, spans.Span) and r.name == name
            and env.window_start <= r.t0 < env.window_end]


def _stage_spans(spans, env) -> list:
    """(name, start, end) of the program's stage spans in the window (none
    where the program has no such span)."""
    return sorted(((r.name, r.t0, r.t1) for n in STAGES for r in _records(spans, env, n)),
                  key=lambda s: s[1])


#: spans below a batch's stages that its line on standard error adds up too
INNER = ("ava.seed", "align.index", "align.map")


def _print_batches(spans, env) -> None:
    """Each traced batch's stages (ms; the overlap searches by stage, and
    the seeding and the decision aligner's index and mapping inside them)
    and the pool after it, one line a batch on standard error."""
    recs = spans.recorded()
    for b in _records(spans, env, "aeons.batch"):
        ms = {}
        for r in recs:
            if isinstance(r, spans.Span) and (r.parent == b.id or (
                    r.name in INNER and b.t0 <= r.t0 < b.t1)):
                key = r.name + (f".{r.attrs['stage']}" if r.attrs and "stage" in r.attrs else "")
                ms[key] = round(ms.get(key, 0.0) + 1e3 * (r.t1 - r.t0), 1)
        counts = {}
        for r in recs:
            if isinstance(r, spans.Count) and b.t0 <= r.t <= b.t1:
                counts[r.name] = counts.get(r.name, 0) + r.n
        print("aeons batch: " + json.dumps(dict(ms=round(1e3 * (b.t1 - b.t0), 1), stages=ms,
                                                counts=counts)), file=sys.stderr, flush=True)


def _attrs(spans, env, name: str, key: str | None = None) -> list:
    """The attrs of the window's spans of ``name`` (or each attr ``key``'s
    items, concatenated)."""
    recs = [r.attrs or {} for r in _records(spans, env, name)]
    if key is None:
        return recs
    return [tuple(c) for a in recs for c in a.get(key, ())]


def _check(env, kept: list, control: bool):
    lim, dev = env.limits, env.device
    t0 = time.perf_counter()
    mu = env.config["aeons"]["mu"]
    dm = env.config["decision_mapper"]
    ovl = mapped = dec_bad = n_reads = pub = 0
    strat_bad = strat_rows = ctl_bad = 0
    thr_gap = ctl_gap = 0.0
    for keep, (fasta, npz) in kept:
        for queries, pool, rows, kw in keep.overlaps:
            if not kw.get("merge") or set(kw) - {"merge"}:
                raise RuntimeError(f"find_overlaps was called with {kw}")
            got = [tuple(rows[f][i] for f in RAE.FIELDS) for i in range(len(rows["qname"]))]
            ovl += RAE.row_mismatch(got, RAE.overlaps(queries, pool, dev))
        d = keep.decide
        if d["mapper"] not in (None, dict(dm, mu=mu)):
            raise RuntimeError(f"the sim decided with {d['mapper']}, the configuration "
                               f"states {dict(dm, mu=mu)}")
        accept, n_mapped = RAE.decisions(d["reads"], d["contigs"], d["strat"], dev,
                                         k=dm["k"], w=dm["w"], min_votes=dm["min_votes"],
                                         mu=mu)
        reads, out = d["reads"], d["out"]
        mapped += abs((len(reads) - d["unmapped"]) - n_mapped)
        # a read of at most mu bases reads the same either way: such reads
        # are compared by the count the program rejected
        long = [r for r in reads if len(reads[r]) > mu]
        dec_bad += sum((len(out[r]) == len(reads[r])) != accept[r] for r in long)
        short_rej = d["rejected"] - sum(len(out[r]) < len(reads[r]) for r in long)
        dec_bad += abs(short_rej - sum(not accept[r] for r in reads if len(reads[r]) <= mu))
        n_reads += len(reads)
        s = keep.strategy
        if s is None:
            raise RuntimeError("the checked batch computed no strategy")
        for dtype in (torch.float64, torch.float32) if control else (torch.float64,):
            ref, thr = RAE.strategy(s["contigs"], s["ccl"], s["lam"], s["lowcov"], mu=mu,
                                    dtype=dtype)
            bad, rows = RAE.strat_mismatch(s["strat"], ref)
            gap = abs(s["thr"] - thr) / max(abs(thr), 1e-300)
            if dtype == torch.float64:
                strat_bad, strat_rows, thr_gap = strat_bad + bad, strat_rows + rows, max(
                    thr_gap, gap)
            else:
                ctl_bad, ctl_gap = ctl_bad + bad, max(ctl_gap, gap)
        pub += RAE.publication(str(fasta), str(npz), s["seqs"], s["strat"])
    print(f"reference: {len(kept)} batches, {sum(len(k.overlaps) for k, _ in kept)} overlap "
          f"searches, {n_reads} reads decided, {strat_rows} strategy rows; "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)

    def numbers(sbad, gap):
        return [("overlap_mismatch", float(ovl), lim["overlap_mismatch"]),
                ("mapped_mismatch", float(mapped), lim["mapped_mismatch"]),
                ("decision_mismatch_share", dec_bad / max(n_reads, 1),
                 lim["decision_mismatch_share"]),
                ("strat_mismatch_share", sbad / max(strat_rows, 1), lim["strat_mismatch_share"]),
                ("threshold_rel_gap", gap, lim["threshold_rel_gap"]),
                ("publish_mismatch", float(pub), lim["publish_mismatch"])]

    return numbers(strat_bad, thr_gap), numbers(ctl_bad, ctl_gap) if control else None
