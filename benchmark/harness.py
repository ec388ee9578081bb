"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` is what ``python -m benchmark`` calls once it has found the
card; the tests call it on the CPU at small sizes. Everything particular
to a cell is found by name: the workload in ``BENCHMARK.json``, its
configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``),
the limits of its check in ``cells/<workload>.json`` and each per-layer
metric's reader in ``metrics/<metric>.py``.

A driver's ``drive(env)`` builds the program and its inputs, warms up,
measures inside ``env.window()`` and returns a ``Run``: the cycles it
timed, the counters it read, and a ``check`` that, once the window has
closed, frees the program's state and returns the numbers compared, each
with its limit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: inputs kept between runs (the sim's corpus); a run's outputs go to a
#: directory of its own under TMPDIR, removed when it ends
CACHE = ROOT / ".bench_torch_cache" / "benchmark"
#: spans of the harness's own work inside the window (a driver's state
#: restore): left out of the window's time and of the device's busy time
HARNESS_SPANS = ("restore",)
#: modules no run may hold once its window has closed (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "bossruns_tpu")
GIB = 2 ** 30


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(entries: list[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a driver hands back once its window has closed."""

    cycles: list          # (host start, host end, reads) of every timed cycle
    counters: dict        # program counters over the window (graph replays, ...)
    #: check(control) -> ([(name, value, limit)], the same of the control or
    #: None), after freeing the program
    check: Callable[[bool], tuple]
    harness_device_bytes: int = 0  # what the harness itself holds on the device
    extra: dict = dataclasses.field(default_factory=dict)  # for the metric readers


class Env:
    """What a driver is given."""

    def __init__(self, workload: dict, config: dict, traffic: dict, limits: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device, work: Path):
        self.workload, self.config, self.traffic, self.limits = workload, config, traffic, limits
        self.seed, self.seconds, self.trace, self.device, self.work = (
            seed, seconds, trace, device, work)
        self.spans: list = []        # (name, host start, host end)
        self.window_start = self.window_end = self.marker_t = None
        self.profile = None

    def reset_peak(self) -> None:
        """Start the device's peak memory here: a driver calls it once its
        inputs are made and before it builds the program."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def window(self):
        """The measured window. Under ``--trace 1`` a profiler records the
        device (and the harness's window marker) for exactly this span. The
        driver calls ``close()`` on what it yields with the time its last
        cycle ended."""
        prof = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        marker = torch.profiler.record_function("bench.window") if self.trace else None
        if marker is not None:
            marker.__enter__()
            self.marker_t = time.perf_counter()  # the host clock at the marker's start
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_start = time.perf_counter()
        w = _Window(self.window_start + self.seconds)
        try:
            yield w
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.window_end = w.end if w.end is not None else time.perf_counter()
            if marker is not None:
                marker.__exit__(None, None, None)
            if prof is not None:
                prof.__exit__(None, None, None)
                self.profile = prof


class _Window:
    def __init__(self, due: float):
        self.due = due
        self.end = None

    def close(self, t_end: float) -> None:
        self.end = t_end


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, t_process: float | None = None,
             control: bool = False) -> tuple[dict, list, list | None]:
    """One run: (the result line's object, the numbers compared, and with
    ``control`` the same numbers of the control: the reference one
    precision below the configuration's, judged like the program)."""
    t_process = time.perf_counter() if t_process is None else t_process
    s = spec()
    w = find(s["workloads"], workload)
    over = overrides or {}
    config = {**load_json("configs", w["config"]), **over.get("config", {})}
    traffic = merged(load_json("traffic", w["traffic"]), over.get("traffic"))
    limits = {**load_json("cells", workload)["limits"], **over.get("limits", {})}
    dev = torch.device(device)
    work = Path(tempfile.mkdtemp(prefix=f"bench-{workload}-"))
    try:
        env = Env(w, config, traffic, limits, seed, seconds, trace, dev, work)
        driver = load_module("drivers", traffic["driver"])
        run = driver.drive(env)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        summary = None
        if trace:
            from . import trace as trace_mod

            summary = trace_mod.summarize(env, run)
            env.profile = None
            print(f"trace: {summary['n_device_events']} device events in the window, "
                  f"{summary['kernels_per_cycle']} kernels and memsets in most cycles, "
                  f"{summary['cycles_lost_events']} cycles with fewer, "
                  f"{summary['harness_events_cut']} launched by the harness's "
                  f"{summary['harness_calls']} runtime calls cut out",
                  file=sys.stderr)
        checks, control_checks = run.check(control)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    correct = all(_within(v, lim) for _, v, lim in checks)

    cycles = run.cycles
    window_s = env.window_end - env.window_start - harness_seconds(env)
    e2e = {
        "reads_per_s": sum(c[2] for c in cycles) / window_s,
        "cycle_p95_ms": float(np.percentile([1e3 * (c[1] - c[0]) for c in cycles], 95)),
        "device_peak_gib": (peak - run.harness_device_bytes) / GIB,
        "setup_s": env.window_start - t_process,
    }
    metrics = {}
    if not trace:
        for m in s["end_to_end"]:
            if workload in m.get("workloads", [workload]) and m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(env=env, run=run, trace=summary, e2e=e2e)
        for m in s["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    line = {"correct": bool(correct), "attempted": len(cycles), "failed": 0,
            "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line, checks, control_checks


def harness_seconds(env) -> float:
    return sum(b - a for n, a, b in env.spans if n in HARNESS_SPANS)


def _within(value: float, limit: float) -> bool:
    return bool(np.isfinite(value)) and value <= limit
