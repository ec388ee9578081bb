"""The port's span and counter recorder (``bossruns_torch.utils.spans``).

* off (no profiler on the thread): nothing is recorded, ``span`` returns
  the shared no-op, ``carry`` hands back the function itself;
* on, under ``torch.profiler``: a gated sim records every span with its
  parent (the prefetch worker's job under the batch that submitted it),
  the chromosome's live chain (``step_from_numpy``, ``pull_aux``,
  ``strat_dict``, ``write_strategy_npz``) its engine and mask spans, and
  the byte counters equal hand counts;
* a main-thread span's ``bossruns.<name>`` annotation in the exported
  trace matches its record, also once placed through a marker;
* spans change no result: masks, metrics lines and state are equal bit for
  bit with and without them;
* the live-alignment sim (no PAFs): the aligner's spans nest under
  ``sim.align`` within ``sim.batch``, its counters equal hand counts of a
  batch's reads, bases, DP jobs, cells and seed pulls, nothing records
  with the profiler off, and the gated flow records none of them;
* on the card (marker ``cuda``): a replayed step's launch is recorded as a
  replay, and the strategy's pinned pull counts its bytes.

This file imports no JAX: the ``cuda`` case runs on the card with
``python -m pytest tests/test_torch_spans.py -m cuda -q --noconftest``.
"""
import json
import os
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from bossruns_torch.aligner import TorchAligner, bucket_of
from bossruns_torch.aligner import native as tnative
from bossruns_torch.io import coo_native
from bossruns_torch.io.coo_native import pad_split, split_runs
from bossruns_torch.models import runs as truns
from bossruns_torch.models.convert import state_to_numpy
from bossruns_torch.models.graphs import GraphCache
from bossruns_torch.models.layout import build_layout
from bossruns_torch.models.runs_sim import BossRunsSim
from bossruns_torch.utils import spans
from bossruns_torch.utils.datagen import write_corpus
from bossruns_torch.utils.misc import read_strategy_npz, write_strategy_npz
from bossruns_torch.utils.staging import PinnedStaging

torch.set_num_threads(2)

CCL = np.array([30000, 20000, 14000, 10000, 7000, 5000, 3500, 2200, 1200, 400])
SIM_SPANS = {"sim.batch", "sim.prefetch", "sim.draw", "sim.paf", "sim.coo", "coo.build",
             "engine.pack",
             "engine.upload", "engine.params", "engine.launch", "engine.pull_aux", "mask.pull",
             "mask.split", "mask.write", "checkpoint.pull", "checkpoint.write"}
CHAIN_SPANS = ["engine.params", "engine.pack", "engine.upload", "engine.launch",
               "engine.pull_aux", "mask.pull", "mask.split", "mask.write"]
ALIGN_SPANS = {"align.map", "align.encode", "align.dispatch", "align.pull", "align.plan",
               "align.extend"}
LIVE_SPANS = (SIM_SPANS - {"sim.paf"}) | ALIGN_SPANS | {
    "sim.align", "sim.decide"}


def profiling():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def since(n: int) -> list:
    return spans.recorded()[n:]


def span_records(recs) -> list:
    return [r for r in recs if isinstance(r, spans.Span)]


def counted(recs, name: str) -> int:
    return sum(r.n for r in recs if isinstance(r, spans.Count) and r.name == name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("spans_corpus"), rng=np.random.default_rng(7),
                        contig_lengths={"contigA": 220_000, "contigB": 130_000},
                        n_reads=1200, mean_len=5000.0)


def _sim(corpus, out: Path, **kw) -> BossRunsSim:
    sim = BossRunsSim(ref=corpus["ref"], fq=corpus["fq"], paf_full=corpus["paf_full"],
                      paf_trunc=corpus["paf_trunc"], name="s", batchsize=200, maxb=3,
                      out_base=out, seed=5, device=kw.pop("device", "cpu"), **kw)
    sim.checkpoint_every = 2
    return sim


def _batch(rng, lay, n_reads: int = 300, read_len: int = 400) -> dict:
    """A host batch of reads drawn from the layout's sequence, 5% of their
    symbols changed, with their read-start rows."""
    cid = rng.integers(0, lay.n_contigs, n_reads)
    start = rng.integers(0, lay.lengths[cid] - read_len)
    g = (lay.offsets[cid] + start).astype(np.int64)
    sym = lay.seq_int[g[:, None] + np.arange(read_len)].astype(np.int8)
    flip = rng.random(sym.shape) < 0.05
    sym[flip] = rng.integers(0, 5, int(flip.sum()))
    split = split_runs(lay, sym.ravel(), np.full(sym.size, 40, np.int8), g,
                       np.full(n_reads, read_len, np.int32), np.zeros(n_reads, np.int32))
    return dict(pad_split(split),
                rs_row=rng.integers(0, lay.n_fhat, 512).astype(np.int32),
                rs_strand=rng.integers(0, 2, 512).astype(np.int32),
                rs_w=np.ones(512, np.float32))


def _layout():
    rng = np.random.default_rng(4)
    return build_layout({"a": rng.integers(0, 4, 150_000).astype(np.uint8),
                         "b": rng.integers(0, 4, 120_000).astype(np.uint8)})


class Rerun:
    """Stand-in for models.graphs.CudaGraph on the CPU: capture records the
    body, replay reruns it."""

    def __init__(self, pool):
        self.fn = None

    @staticmethod
    def new_pool():
        return None

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class HostStaging(PinnedStaging):
    """Stand-in for PinnedStaging on the CPU: plain buffers, no event."""

    @staticmethod
    def _buffer(n_words):
        return torch.empty(n_words, dtype=torch.int32)

    @staticmethod
    def _new_event():
        return None


def _chain(engine, state, batch, out: Path):
    """The live update after mapping, as ``BossRuns.process_reads`` runs it,
    under a profiler: (state, the records it made, the strategy file)."""
    n = len(spans.recorded())
    with profiling():
        state, aux = engine.step_from_numpy(state, batch, engine.make_params(CCL, 5300.0))
        engine.strat_to_host_async(state)
        engine.pull_aux(aux)
        path = write_strategy_npz(out, engine.strat_dict(state))
    return state, since(n), path


def _check_chain(engine, out: Path) -> list:
    """Three steps of one shape tier through the chain: the engine and mask
    spans in order, and the bytes each step copies from the device and
    writes; returns each step's launch mode."""
    lay = engine.layout
    state = engine.init_state()
    rng = np.random.default_rng(9)
    aux_bytes = 4 * torch.finfo(engine.dtype).bits // 8
    strat_bytes = state.strat.numel() * state.strat.element_size()
    modes = []
    for _ in range(3):
        state, recs, path = _chain(engine, state, _batch(rng, lay), out)
        got = span_records(recs)
        assert [r.name for r in got] == CHAIN_SPANS
        assert all(r.parent is None for r in got)
        modes.append(got[3].attrs["mode"])
        assert counted(recs, "bytes.d2h") == aux_bytes + strat_bytes
        assert counted(recs, "bytes.disk") == os.path.getsize(path)
    return modes


# ------------------------------------------------------------------- off ---

def test_off_records_nothing(corpus, tmp_path):
    assert not torch.autograd._profiler_enabled()
    n = len(spans.recorded())
    assert spans.span("sim.batch") is spans.span("engine.launch", mode="x")
    with spans.span("mask.write") as sp:
        sp.attr("mode", "replay")
    spans.count("bytes.d2h", 10)
    spans.count_files(tmp_path / "absent")  # no size is read
    f = lambda: 1  # noqa: E731
    assert spans.carry(f) is f
    sim = _sim(corpus, tmp_path)
    for _ in range(3):
        sim.process_batch()
    sim.cleanup()
    assert len(spans.recorded()) == n


def test_a_worker_thread_records_only_under_a_carried_cause():
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        def job():
            with spans.span("sim.draw"):
                return threading.get_ident()

        n = len(spans.recorded())
        with profiling():
            with spans.span("sim.batch"):
                pool.submit(job).result()          # the profiler's state is per thread
                tid = pool.submit(spans.carry(job)).result()
        recs = span_records(since(n))
        assert [r.name for r in recs] == ["sim.draw", "sim.batch"]
        draw, batch = recs
        assert draw.thread == tid != batch.thread and draw.parent == batch.id
        assert batch.parent is None
    finally:
        pool.shutdown(wait=True)


# -------------------------------------------------------------------- on ---

def test_gated_sim_records_every_span_with_its_parent(corpus, tmp_path):
    n = len(spans.recorded())
    t0 = time.perf_counter()
    with profiling():
        sim = _sim(corpus, tmp_path)
        main = threading.get_ident()
        for _ in range(3):
            sim.process_batch()
        sim.cleanup()
    recs = since(n)
    got = span_records(recs)
    assert {r.name for r in got} == SIM_SPANS
    by_id = {r.id: r for r in got}
    parent = lambda r: by_id[r.parent].name if r.parent in by_id else None  # noqa: E731
    names = Counter(r.name for r in got)
    assert names["sim.batch"] == 3 and names["checkpoint.write"] == 1
    # every batch takes one prefetch, and the last submits one more: the
    # sampler holds maxb + 1 batches, as the reference's does
    assert names["sim.prefetch"] == 4
    prefetch = [r for r in got if r.name == "sim.prefetch"]
    assert all(parent(r) == "sim.batch" for r in prefetch)
    assert prefetch[0].thread == main                       # the first, inline
    assert all(r.thread != main for r in prefetch[1:])      # on the worker
    for r in got:
        if r.name in ("sim.draw", "sim.paf", "sim.coo", "engine.pack", "engine.upload"):
            assert parent(r) == "sim.prefetch", r
        if r.name in ("engine.params", "engine.launch", "engine.pull_aux",
                      "checkpoint.pull", "checkpoint.write"):
            assert parent(r) == "sim.batch", r
        if r.name in ("mask.pull", "mask.split", "mask.write"):  # the first: the constructor's
            assert parent(r) == ("sim.batch" if r.t0 > prefetch[0].t0 else None), r
        if r.name == "engine.launch":
            assert r.attrs == {"mode": "eager"}   # the CPU has no graphs
        elif r.name == "checkpoint.write":   # the npz writer's pool and pieces
            assert set(r.attrs) == {"workers", "chunks"}
            assert r.attrs["workers"] >= 1 and r.attrs["chunks"] >= 1
        elif r.name == "coo.build":          # the coverage rows' pass
            assert parent(r) == "sim.coo", r
        else:
            assert r.attrs is None
        assert r.t0 <= r.t1
    # window() sums what starts inside it; under= follows parents across threads
    w = spans.window(t0, time.perf_counter())
    assert w.n == dict(names)
    assert w.seconds["sim.paf"] == pytest.approx(sum(r.t1 - r.t0 for r in got
                                                     if r.name == "sim.paf"))
    under = spans.window(t0, time.perf_counter(), under="sim.prefetch")
    assert set(under.n) == {"sim.draw", "sim.paf", "sim.coo", "coo.build", "engine.pack",
                            "engine.upload"}
    assert spans.window(t0, t0).n == {}

    # the counters against hand counts
    out = sim.out_dir
    aux_bytes = 4 * torch.finfo(sim.engine.dtype).bits // 8
    strat_bytes = sim.state.strat.numel() * sim.state.strat.element_size()
    ckpt = np.load(out / "checkpoint" / "state.npz")
    fields = sum(ckpt[k].nbytes for k in truns.GenomeState._fields)
    assert counted(recs, "bytes.d2h") == (names["engine.pull_aux"] * aux_bytes
                                          + names["mask.pull"] * strat_bytes + fields)
    dumps = [p for p in (tmp_path / "00_reads").glob("*.fa")]
    disk = (names["mask.write"] * os.path.getsize(out / "masks" / "boss.npz")
            + os.path.getsize(out / "checkpoint" / "state.npz")
            + os.path.getsize(out / "checkpoint" / "state_meta.json")
            + os.path.getsize(out / "metrics" / "batches.jsonl")
            + sum(os.path.getsize(p) for p in dumps))
    assert any(os.path.getsize(p) for p in dumps)
    assert counted(recs, "bytes.disk") == disk


def test_coo_build_records_its_pass_under_sim_coo(corpus, tmp_path):
    """Each traced gated batch builds its two record sets' rows in one
    ``coo.build`` each, under its ``sim.coo``: the full set (200 reads of
    ~5 kb, above twice ``CHUNK_BASES``) in chunks on the pool, the
    truncated set (200 prefixes of at most mu bases) as one chunk on the
    calling thread."""
    n = len(spans.recorded())
    with profiling():
        sim = _sim(corpus, tmp_path)
        sim.process_batch()
        sim.cleanup()
    got = span_records(since(n))
    by_id = {r.id: r for r in got}
    coo = [r for r in got if r.name == "sim.coo"]
    builds = [r for r in got if r.name == "coo.build"]
    assert len(builds) == 2 * len(coo) >= 2
    for r in builds:
        assert by_id[r.parent].name == "sim.coo" and by_id[r.parent].t0 <= r.t0 <= r.t1
        assert set(r.attrs) == {"records", "bases", "chunks", "workers"}
        assert 0 < r.attrs["records"] <= 200 and r.attrs["bases"] > 0
        assert 1 <= r.attrs["chunks"] <= r.attrs["records"]
        assert (r.attrs["workers"] == 1) == (r.attrs["chunks"] == 1)
    for full, trunc in zip(builds[::2], builds[1::2]):
        assert full.attrs["bases"] >= 2 * coo_native.CHUNK_BASES and full.attrs["chunks"] > 1
        assert full.attrs["workers"] == len(os.sched_getaffinity(0))
        assert trunc.attrs["bases"] <= 200 * sim.mu
        assert trunc.attrs["chunks"] == 1 and trunc.attrs["workers"] == 1


def test_the_live_chain_records_engine_and_mask_spans(tmp_path):
    assert _check_chain(truns.RunsEngine(_layout(), device="cpu"), tmp_path) == ["eager"] * 3


def test_the_launch_span_tells_a_capture_and_a_replay(tmp_path):
    """Through the graph cache (a stand-in graph on the CPU): the first step
    of a tier runs eagerly, the second captures, the third replays."""
    eng = truns.RunsEngine(_layout(), device="cpu")
    eng.graphs, eng._staging = GraphCache("cpu", graph=Rerun), HostStaging()
    assert _check_chain(eng, tmp_path) == ["eager", "capture", "replay"]


def test_annotation_lasts_as_long_as_its_record(tmp_path):
    n = len(spans.recorded())
    with profiling() as prof:
        with torch.profiler.record_function("bench.window"):
            marker_t = time.perf_counter()
            time.sleep(0.002)
            with spans.span("mask.write"):
                time.sleep(0.02)
    rec = span_records(since(n))[0]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    mask = next(e for e in ann if e["name"] == "bossruns.mask.write")
    marker = next(e for e in ann if e["name"] == "bench.window")
    assert abs(float(mask["dur"]) - 1e6 * (rec.t1 - rec.t0)) < 1e3
    # placed on the trace's clock from the marker's start (benchmark/trace.py)
    placed = float(marker["ts"]) + 1e6 * (rec.t0 - marker_t)
    assert abs(placed - float(mask["ts"])) < 1e3


def test_spans_change_no_result(corpus, tmp_path):
    def run(out: Path, traced: bool):
        sim = _sim(corpus, out)
        masks = []
        for _ in range(3):
            if traced:
                with profiling():
                    sim.process_batch()
            else:
                sim.process_batch()
            masks.append(read_strategy_npz(sim.out_dir / "masks" / "boss.npz"))
        sim.cleanup()
        lines = [json.loads(x) for x in
                 (sim.out_dir / "metrics" / "batches.jsonl").read_text().splitlines()]
        with np.load(sim.out_dir / "checkpoint" / "state.npz") as z:
            ckpt = {k: z[k] for k in z}
        return masks, lines, ckpt, state_to_numpy(sim.state)

    n = len(spans.recorded())
    off = run(tmp_path / "off", False)
    assert len(spans.recorded()) == n
    on = run(tmp_path / "on", True)
    assert len(spans.recorded()) > n
    for a, b in zip(off[0], on[0]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(off[1], on[1]):
        assert list(a["phases"]) == list(b["phases"])
        assert {k: v for k, v in a.items() if k != "phases"} == {
            k: v for k, v in b.items() if k != "phases"}
    for a, b in ((off[2], on[2]), (off[3], on[3])):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ----------------------------------------------------- live alignment ---

def _live_sim(corpus, out: Path) -> BossRunsSim:
    sim = BossRunsSim(ref=corpus["ref"], fq=corpus["fq"], name="s", batchsize=150, maxb=2,
                      out_base=out, seed=5, device="cpu")
    sim.checkpoint_every = 2
    return sim


def test_live_sim_nests_the_aligners_spans_under_sim_align(corpus, tmp_path):
    n = len(spans.recorded())
    with profiling():
        sim = _live_sim(corpus, tmp_path)
        for _ in range(2):
            sim.process_batch()
        sim.cleanup()
    got = span_records(since(n))
    assert {r.name for r in got} == LIVE_SPANS | {"align.index"}
    by_id = {r.id: r for r in got}
    parent = lambda r: by_id[r.parent].name if r.parent in by_id else None  # noqa: E731
    names = Counter(r.name for r in got)
    assert names["sim.batch"] == names["sim.align"] == names["sim.decide"] == 2
    assert names["align.map"] == 4 and names["align.index"] == 1      # two passes a batch
    assert names["align.pull"] == names["align.plan"] == names["align.extend"] >= 4
    assert parent(next(r for r in got if r.name == "align.index")) is None  # the constructor
    for r in got:
        if r.name in ("sim.align", "sim.decide", "sim.coo"):
            assert parent(r) == "sim.batch", r
        if r.name == "align.map":
            assert parent(r) == "sim.align" and set(r.attrs) == {"trunc", "reads"}, r
        if r.name in ALIGN_SPANS - {"align.map"}:
            assert parent(r) == "align.map", r
        if r.name == "align.dispatch":
            assert all(L == bucket_of(L) for _, L in r.attrs["calls"])
    maps = [r for r in got if r.name == "align.map"]
    assert [r.attrs["trunc"] for r in maps] == [True, False] * 2
    assert [r.attrs["reads"] for r in maps][::2] == [150, 150]
    # the five pieces of a map call lie inside it, one after another
    for m in maps:
        inside = sorted((r for r in got if r.parent == m.id), key=lambda r: r.t0)
        assert all(a.t1 <= b.t0 for a, b in zip(inside, inside[1:]))
        assert m.t0 <= inside[0].t0 and inside[-1].t1 <= m.t1


def test_aligner_counters_equal_hand_counts(corpus, monkeypatch):
    from bossruns_torch.models.runs_sim import load_reference_contigs

    lay = build_layout(load_reference_contigs(corpus["ref"]))
    al = TorchAligner(lay, k=13, w=5, min_votes=3, device="cpu")
    rng = np.random.default_rng(3)
    seqs = {}
    with open(corpus["fq"]) as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1 and rng.random() < 0.2:
                seqs[f"r{i}"] = line.strip()
    jobs = []
    orig = tnative.align_batch

    def hand(q_cat, q_off, target, ws, we, pad, half, threads=8):
        jobs.append((np.diff(q_off), half.astype(np.int64)))
        return orig(q_cat, q_off, target, ws, we, pad, half, threads)

    monkeypatch.setattr(tnative, "align_batch", hand)
    for trunc in (True, False):
        jobs.clear()
        n = len(spans.recorded())
        with profiling():
            al.map_sequences(seqs, trunc=trunc)
        recs = since(n)
        lens = np.array([min(len(s), al.mu) if trunc else len(s) for s in seqs.values()])
        assert counted(recs, "align.reads") == len(seqs)
        assert counted(recs, "align.bases") == int(np.minimum(lens, 32768).sum())
        assert counted(recs, "align.jobs") == sum(len(m) for m, _ in jobs) > 0.8 * len(seqs)
        assert counted(recs, "align.dp_cells") == sum(int((m * (2 * h + 1)).sum())
                                                      for m, h in jobs)
        # each call pulls its [24, rows] int32 seeds
        assert counted(recs, "bytes.d2h") == 24 * 4 * len(seqs)


def test_live_sim_off_records_nothing(corpus, tmp_path):
    assert not torch.autograd._profiler_enabled()
    n = len(spans.recorded())
    sim = _live_sim(corpus, tmp_path)
    sim.process_batch()
    sim.cleanup()
    assert len(spans.recorded()) == n


def test_gated_flow_records_no_aligner_span(corpus, tmp_path):
    n = len(spans.recorded())
    with profiling():
        sim = _sim(corpus, tmp_path)
        sim.process_batch()
        sim.cleanup()
    recs = since(n)
    got = {r.name for r in span_records(recs)}
    assert got <= SIM_SPANS and not got & (ALIGN_SPANS | {"sim.align", "sim.decide",
                                                           "align.index"})
    assert not {r.name for r in recs if isinstance(r, spans.Count)} - {
        "bytes.d2h", "bytes.disk", "scores.full", "scores.tiled"}


# ------------------------------------------------------------------ card ---

@pytest.mark.cuda
def test_replayed_step_and_pinned_pull_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    eng = truns.RunsEngine(_layout(), device="cuda")
    assert _check_chain(eng, tmp_path) == ["eager", "capture", "replay"]
