"""The per-layer metrics that read the program's own spans and counters
(``bossruns_torch.utils.spans``), on each cell's small traced run on the
CPU, and on runs that hold nothing to read."""
import types

import pytest

from benchmark import harness
from benchmark.tests.conftest import SEED, SMALL

#: the metrics that read ``bossruns_torch.utils.spans``
SPAN_METRICS = ("draw_ms.sim", "paf_ms.sim", "coo_ms.sim", "stage_ms.sim", "checkpoint_ms.sim",
                "pack_ms.update", "launch_ms.update", "aux_wait_ms.update", "mask_ms",
                "mask_write_ms", "d2h_mib", "disk_mib")


@pytest.fixture(scope="module")
def traced():
    """Each cell's small traced run, once: {cell: result line}."""
    out = {}
    for cell, s in SMALL.items():
        line, _, _ = harness.run_cell(cell, SEED, s["seconds"], True, device="cpu",
                                      overrides=s["overrides"])
        out[cell] = line
    return out


def test_every_span_metric_is_declared():
    per_layer = {m["name"]: m for m in harness.spec()["per_layer"]}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] in ("program_span", "program_counter") and m["better"] == "lower"
        assert m["moves"] == "reads_per_s"


def test_each_metric_in_its_cells_traced_line(traced, cell):
    """The small runs do every span's work (a whole experiment of ten
    batches holds the sim's checkpoint), so each metric reads a value
    above 0 in each cell it lists."""
    line = traced[cell]
    assert line["correct"]
    for m in harness.spec()["per_layer"]:
        if m["name"] in SPAN_METRICS and cell in m["workloads"]:
            assert m["name"] in line["metrics"], m["name"]
            assert line["metrics"][m["name"]]["value"] > 0, m["name"]


def test_engine_spans_add_up_to_the_harness_step(traced):
    """The engine's spans cover what the harness's ``step`` and ``pull``
    spans hold around the calls into the engine."""
    got = traced["chr1-dense-update"]["metrics"]
    parts = sum(got[k]["value"] for k in ("pack_ms.update", "launch_ms.update",
                                          "aux_wait_ms.update"))
    whole = got["step_ms.update"]["value"]
    assert abs(parts - whole) <= 0.1 * whole, (parts, whole)


def test_sim_checkpoint_and_mask_make_the_write_tail(traced):
    """``write_ms.sim`` (the cycle's end less the sim's rounded phases
    before its mask) is the mask's publication, the metrics line and the
    checkpoint: the two span metrics make it up, within 5% or 10 ms."""
    got = traced["zymo-paf-sim"]["metrics"]
    parts = got["checkpoint_ms.sim"]["value"] + got["mask_ms"]["value"]
    whole = got["write_ms.sim"]["value"]
    assert abs(parts - whole) <= max(0.05 * whole, 10.0), (parts, whole)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_reports_nothing_without_spans(name):
    """No cycles (the env is not touched), or cycles in a window that holds
    no record: nothing, never 0."""
    reader = harness.load_module("metrics", name)
    empty = harness.Run(cycles=[], counters={}, check=lambda c: ([], None))
    assert reader.read(dict(env=None, run=empty, trace=None, e2e={})) is None
    run = harness.Run(cycles=[(0.0, 1.0, 10)], counters={}, check=lambda c: ([], None))
    env = types.SimpleNamespace(window_start=-2.0, window_end=-1.0)
    assert reader.read(dict(env=env, run=run, trace=None, e2e={})) is None
