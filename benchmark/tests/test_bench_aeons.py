"""The reference-free cell (``zymo-aeons-sim``) run small on the CPU: its
traced run correct with its control failing, its line's metrics within the
cell's allowed set, and three faults of the program judged not correct (an
overlap row dropped in ``find_overlaps``, one strategy bit flipped after
H7, one decision flipped); on the card (marker ``cuda``), the cell small.

The small size lives here (``conftest.SMALL`` holds the cells its
parametrised tests run): two contigs of 150 and 120 kb, batches of 100
reads of mean 5 kb from a pool of 2,000, binit 4, at the cell's own
limits (exact but the threshold's, so one row or decision fails at any
size).
"""
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import SEED

CELL = "zymo-aeons-sim"
AEONS = dict(harness.load_json("configs", "zymo-aeons")["aeons"], batchsize=100, binit=4)
SMALL = dict(seconds=1.0, overrides={
    "config": {"contigs": {"cA": 150_000, "cB": 120_000}, "aeons": AEONS},
    "traffic": {"corpus": {"n_reads": 2000, "mean_len": 5000.0, "sd_len": 2000.0}}})
SPAN_METRICS = {"decide_ms.aeons", "ava_ms.aeons", "graph_ms.aeons", "assemble_ms.aeons",
                "strategy_ms.aeons"}


def run(trace=False, control=False, device="cpu"):
    return harness.run_cell(CELL, SEED, SMALL["seconds"], trace, device=device,
                            overrides=SMALL["overrides"], control=control)


def test_traced_run_correct_with_its_control_failing():
    line, checks, control = run(trace=True, control=True)
    assert line["correct"], checks
    got = {n: v for n, v, _ in checks}
    assert set(got) == set(harness.load_json("cells", CELL)["limits"])
    assert got["overlap_mismatch"] == got["mapped_mismatch"] == got["publish_mismatch"] == 0
    assert got["decision_mismatch_share"] == got["strat_mismatch_share"] == 0
    assert not all(harness._within(v, lim) for _, v, lim in control), control
    assert line["attempted"] >= 2 and line["failed"] == 0
    allowed = {m["name"] for m in harness.spec()["per_layer"]
               if CELL in m.get("workloads", [CELL])}
    assert SPAN_METRICS <= set(line["metrics"]) <= allowed   # no H6 or H7 on the CPU
    assert all(line["metrics"][m]["value"] > 0 for m in SPAN_METRICS)


def _drop_row(orig):
    def find_overlaps(*a, **kw):
        rows = orig(*a, **kw)
        return {k: v[1:] for k, v in rows.items()} if rows["qname"] else rows
    return find_overlaps


def _flip_bit(orig):
    def contig_strategies(*a, **kw):
        strat, thr = orig(*a, **kw)
        name = next(iter(strat))
        m = strat[name].copy()
        m[0, 0] = ~m[0, 0]
        return {**strat, name: m}, thr
    return contig_strategies


def _flip_decision(orig):
    def make_decisions(self, reads, *a, **kw):
        out = orig(self, reads, *a, **kw)
        rid = next(r for r in reads if len(reads[r]) > 400)
        if len(out[rid]) == len(reads[rid]):
            out[rid] = reads[rid][:400]
            self.reject_count += 1
        else:
            out[rid] = reads[rid]
            self.reject_count -= 1
        return out
    return make_decisions


def _faults():
    from bossruns_torch.aeons import core
    from bossruns_torch.aeons.simulation import BossAeonsSim

    return {"overlap_row": (core, "find_overlaps", _drop_row, "overlap_mismatch"),
            "strategy_bit": (core, "contig_strategies", _flip_bit, "strat_mismatch_share"),
            "decision": (BossAeonsSim, "make_decisions", _flip_decision,
                         "decision_mismatch_share")}


@pytest.mark.parametrize("fault", ["overlap_row", "strategy_bit", "decision"])
def test_a_program_fault_is_not_correct(fault, monkeypatch):
    where, name, wrap, number = _faults()[fault]
    monkeypatch.setattr(where, name, wrap(getattr(where, name)))
    line, checks, _ = run()
    got = {n: v for n, v, _ in checks}
    assert not line["correct"]
    assert got[number] > 0, got


@pytest.mark.cuda
def test_cell_small_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    line, checks, _ = run(trace=True, device="cuda")
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu"
    for m in ("cand_roofline_pct", "aeons_strategy_roofline_pct"):
        assert 0 < line["metrics"][m]["value"] <= 100, line["metrics"]
