"""BENCHMARK.json against the contract's form, and every file it names
found by name."""
import json
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    s = harness.spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in s[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in s["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
    assert len(json.dumps(s)) < 64 * 1024


def test_every_file_found_by_name():
    s = harness.spec()
    for c in s["configs"]:
        cfg = harness.load_json("configs", c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in s["workloads"]:
        traffic = harness.load_json("traffic", w["traffic"])
        driver = harness.load_module("drivers", traffic["driver"])
        assert callable(driver.drive)
        assert set(harness.load_json("cells", w["name"])["limits"])
    for m in s["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        for w in m["workloads"]:
            harness.find(s["workloads"], w)


def test_readers_report_nothing_without_input():
    """A reader that finds nothing to read returns nothing, never 0."""
    run = harness.Run(cycles=[], counters={}, check=lambda c: ([], None))
    ctx = dict(env=None, run=run, trace=None, e2e={})
    for m in harness.spec()["per_layer"]:
        if m["name"] == "step_ms.update":
            continue  # reads the harness's spans of a run
        assert harness.load_module("metrics", m["name"]).read(ctx) is None, m["name"]
