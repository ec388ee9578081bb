"""The live-alignment cell (``zymo-align-sim``) run small on the CPU: its
traced run correct with 0 mismatches and its control failing, and the
check refusing a reference aligner that maps otherwise than the program.

The small size lives here (``conftest.SMALL`` holds the cells its
parametrised tests run): two contigs, ten batches of 50 reads (the tenth
checkpoints, so the state is compared too) from a pool of 2,000 reads of
mean 1,500 bases, and the strategy rows' limit of ``zymo-paf-sim``'s
small size (2,200 rows here against the cell's 309,000)."""
import pytest

from benchmark import harness
from benchmark.reference import align as RA
from benchmark.tests.conftest import SEED

CELL = "zymo-align-sim"
SMALL = dict(seconds=1.0, overrides={
    "config": {"contigs": {"cA": 120_000, "cB": 100_000}},
    "traffic": {"batchsize": 50, "check_among_first": 1,
                "corpus": {"n_reads": 2000, "mean_len": 1500.0, "sd_len": 800.0}},
    "limits": {"strat_mismatch_share": 1e-3}})
SPAN_METRICS = {"align_ms.sim", "encode_ms.sim", "seed_wait_ms.sim", "dp_ms.sim",
                "dp_gcells.sim"}


def run(trace=False, control=False):
    return harness.run_cell(CELL, SEED, SMALL["seconds"], trace, device="cpu",
                            overrides=SMALL["overrides"], control=control)


def test_traced_run_correct_with_its_control_failing():
    line, checks, control = run(trace=True, control=True)
    assert line["correct"], checks
    got = {n: v for n, v, _ in checks}
    assert got["state_mismatch"] == got["mapped_mismatch"] == got["decision_mismatch_share"] == 0
    assert set(got) == set(harness.load_json("cells", CELL)["limits"])
    assert not all(harness._within(v, lim) for _, v, lim in control), control
    assert line["attempted"] >= 10 and line["failed"] == 0
    allowed = {m["name"] for m in harness.spec()["per_layer"]
               if CELL in m.get("workloads", [CELL])}
    assert SPAN_METRICS <= set(line["metrics"]) <= allowed   # no H5 on the CPU
    assert all(line["metrics"][m]["value"] > 0 for m in SPAN_METRICS)


def _gaps_left(orig):
    """A DP whose walk back puts a tied deletion one base further left: the
    same costs and ends, other CIGARs."""
    def align(*a, **k):
        cost, ts, te, runs = orig(*a, **k)
        moved = []
        for lens, ops in runs:
            lens = lens.copy()
            for i in range(1, len(ops) - 1):
                if ops[i] == 2 and ops[i - 1] == 0 and ops[i + 1] == 0 and lens[i - 1] > 1:
                    lens[i - 1] -= 1
                    lens[i + 1] += 1
            moved.append((lens, ops))
        return cost, ts, te, moved
    return align


def _w10(orig):
    def init(self, genome, k, w, *a, **kw):
        orig(self, genome, k, 10, *a, **kw)
    return init


FAULTS = {"gaps_left": (RA, "banded_align", _gaps_left),
          "w10": (RA.RefAligner, "__init__", _w10)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_reference_that_maps_otherwise_is_not_correct(fault, monkeypatch):
    where, name, wrap = FAULTS[fault]
    monkeypatch.setattr(where, name, wrap(getattr(where, name)))
    line, checks, _ = run()
    got = {n: v for n, v, _ in checks}
    assert not line["correct"]
    assert got["state_mismatch"] > 0 or got["mapped_mismatch"] > 0, got
    spec = harness.spec()
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]
                                    if CELL in m.get("workloads", [CELL])}
