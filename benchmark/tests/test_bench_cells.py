"""Each cell run small on the CPU through the plain paths: correct, the
result line's form, the control and the faults of the timed path judged
not correct. The run on the card is one test that skips without one."""
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import SEED, SMALL

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(cell, trace=False, control=False, device="cpu"):
    s = SMALL[cell]
    return harness.run_cell(cell, SEED, s["seconds"], trace, device=device,
                            overrides=s["overrides"], control=control)


def test_cell_correct_with_its_control_failing(cell):
    line, checks, control = run(cell, control=True)
    assert line["correct"], checks
    assert set(line) == KEYS and list(line)[-1] == "checks"
    spec = harness.spec()
    want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "device_peak_gib")
    # the control (float64 reference with bfloat16 scores) fails a number
    assert not all(harness._within(v, lim) for _, v, lim in control), control


def test_traced_line(cell):
    line, _, _ = run(cell, trace=True)
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    spec = harness.spec()
    allowed = {m["name"] for m in spec["per_layer"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= allowed
    assert line["correct"]


# --------------------------------------------------- faults of the timed path --

def _unchanged(orig):
    def step(self, state, *a, **k):
        saved = [t.clone() for t in state]
        out = orig(self, state, *a, **k)
        for t, s in zip(state, saved):
            t.copy_(s)
        return out
    return step


def _half_batch(orig):
    def cut(rows):
        if rows is None:
            return None
        mr_len, ex_g = rows.mr_len.clone(), rows.ex_g.clone()
        mr_len[mr_len.shape[0] // 2:] = 0
        ex_g.view(torch.int32)[ex_g.shape[0] // 2:] = -1  # EX_PAD: padding
        return rows._replace(mr_len=mr_len, ex_g=ex_g)

    def step(self, state, full, trunc, *a, **k):
        return orig(self, state, cut(full), cut(trunc), *a, **k)
    return step


def _altered(orig):
    def strat_dict(self, state):
        d = orig(self, state)
        first = next(iter(d))
        d[first] = ~d[first]
        return d
    return strat_dict


FAULTS = {"state_unchanged": ("_step", _unchanged), "half_batch": ("_step", _half_batch),
          "answer_altered": ("strat_dict", _altered)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from bossruns_torch.models.runs import RunsEngine

    name, wrap = FAULTS[fault]
    monkeypatch.setattr(RunsEngine, name, wrap(getattr(RunsEngine, name)))
    line, checks, _ = run(cell)
    assert not line["correct"], checks


@pytest.mark.cuda
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line, checks, _ = run(cell, trace=True, device="cuda")
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert np.isfinite(line["device"]["memory_peak_bytes"])
