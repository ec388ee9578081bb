"""The traced window, reduced: device busy time, top operations, idle gaps.

The profiler (CPU and CUDA activities) records the window; its chrome
trace gives every kernel, copy and memset on the device and the
harness's ``bench.window`` marker on the host, on one clock. Host-clock
spans (the harness's and, where a driver gives them, the program's own
phases) are placed on that clock from the marker's start, and each idle
gap on the device is shared out over the spans it overlaps.

A trace on that machine has been seen to lose device events. Every cycle
of one kind (a driver may label its cycles, such as the batch a cycle
takes) launches the same kernels, so the cycles whose kernel count falls
below the most common count of their kind lost events: their device time
is taken as the median of their kind's complete cycles', and the busy
time is raised by the difference. The summary says how many cycles that
touched.

The harness's own spans inside the window (``harness.HARNESS_SPANS``, a
state restore) are cut out: the device work launched in them (by its
runtime call's time on the host clock, so that an offset between the
device's clock and the host's does not matter) is not busy time, and
their length is not part of the window.
"""
from __future__ import annotations

import bisect
import json
import statistics
from collections import Counter, defaultdict

from .harness import HARNESS_SPANS

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
COMPUTE_CATS = ("kernel", "gpu_memset")


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(env, run) -> dict:
    path = env.work / "trace.json"
    env.profile.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    path.unlink()
    events = data["traceEvents"] if isinstance(data, dict) else data
    marker = next(e for e in events if e.get("name") == "bench.window"
                  and e.get("cat") == "user_annotation")
    m0 = float(marker["ts"])

    def to_trace(t):
        return m0 + 1e6 * (t - env.marker_t)

    w0, w1 = to_trace(env.window_start), to_trace(env.window_end)
    # each device event's launch on the host clock, by its runtime call
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"], e["cat"],
            launched.get(e.get("args", {}).get("correlation"), float(e["ts"])))
           for e in events if e.get("cat") in DEVICE_CATS and "ts" in e]

    cut = _union([(to_trace(a), to_trace(b)) for n, a, b in env.spans if n in HARNESS_SPANS])
    cut_starts = [a for a, _ in cut]

    def in_cut(t):
        i = bisect.bisect_right(cut_starts, t) - 1
        return i >= 0 and t < cut[i][1]

    n_cut = sum(1 for a, b, _, _, at in dev if b > w0 and a < w1 and in_cut(at))
    n_calls_cut = sum(1 for at in launched.values() if in_cut(at))
    dev = [(max(a, w0), min(b, w1), n, c) for a, b, n, c, at in dev
           if b > w0 and a < w1 and not in_cut(at)]
    busy = _union([(a, b) for a, b, _, _ in dev])
    busy_us = sum(b - a for a, b in busy)

    by_name = defaultdict(float)
    for a, b, n, _ in dev:
        by_name[n] += (b - a) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # each cycle's kernels (and memsets): what it launched between its start and end
    cyc = [(to_trace(t0), to_trace(t1)) for t0, t1, _ in run.cycles]
    per_cycle_us = [0.0] * len(cyc)
    per_cycle_n = [0] * len(cyc)
    starts = [c[0] for c in cyc]
    for a, b, _, c in dev:
        if c not in COMPUTE_CATS:
            continue
        i = bisect.bisect_right(starts, a) - 1
        if 0 <= i < len(cyc) and a < cyc[i][1]:
            per_cycle_us[i] += b - a
            per_cycle_n[i] += 1
    kinds = run.extra.get("cycle_kinds") or [0] * len(cyc)
    lost, modes, device_us = [], Counter(), []
    for kind in sorted(set(kinds)):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        mode = Counter(per_cycle_n[i] for i in idx).most_common(1)[0][0]
        modes[mode] += len(idx)
        complete = [per_cycle_us[i] for i in idx if per_cycle_n[i] >= mode > 0]
        if not complete:
            continue
        med = statistics.median(complete)
        for i in idx:
            if per_cycle_n[i] < mode:
                lost.append(i)
                busy_us += max(0.0, med - per_cycle_us[i])
                device_us.append(max(med, per_cycle_us[i]))
            else:
                device_us.append(per_cycle_us[i])
    cycle_us = statistics.fmean(device_us) if device_us else None

    spans = [(n, to_trace(a), to_trace(b)) for n, a, b in env.spans]
    spans += [(n, to_trace(a), to_trace(b)) for n, a, b in run.extra.get("phase_spans", [])]
    spans.sort(key=lambda s: s[1])
    span_starts = [s[1] for s in spans]
    longest = max((b - a for _, a, b in spans), default=0.0)
    gaps = defaultdict(float)
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            # the gap [prev, a] shared out over the spans it overlaps (spans
            # of one kind do not overlap one another); the rest is "other"
            left = a - prev
            i = bisect.bisect_left(span_starts, a) - 1
            while i >= 0 and span_starts[i] >= prev - longest:
                name, s0, s1 = spans[i]
                part = min(s1, a) - max(s0, prev)
                if part > 0:
                    if name not in HARNESS_SPANS:
                        gaps[name] += part / 1e6
                    left -= part
                i -= 1
            if left > 0:
                gaps["other"] += left / 1e6
        prev = max(prev, b)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    window_s = (w1 - w0 - sum(b - a for a, b in cut)) / 1e6
    return dict(busy_s=min(busy_us / 1e6, window_s), window_s=window_s,
                device_ops=[[n, s] for n, s in device_ops],
                idle_gaps=[[n, s] for n, s in idle_gaps],
                cycle_device_s=None if cycle_us is None else cycle_us / 1e6,
                kernels_per_cycle=modes.most_common(1)[0][0] if modes else 0,
                harness_events_cut=n_cut, harness_calls=n_calls_cut,
                cycles_lost_events=len(lost),
                n_device_events=len(dev))
