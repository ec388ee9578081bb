"""Device time on the card: one call's time and its split by launch.

``time_ms`` times one call with CUDA events around it, host work in the
call included where the card waits for it; ``queued_ms`` times one call as
the card runs it (calls queued behind a
sleeping kernel, so no host gap falls between them); ``device_split``
breaks the same calls down by launch with torch.profiler. Both need a
CUDA device; ``chip_smoke.py`` and ``python -m bossruns_torch.tools.
profile_step`` use them.
"""
from __future__ import annotations

import statistics
from collections import Counter

import torch


def short_name(name: str) -> str:
    """A device event's name without namespace, template and argument list
    ("(anonymous namespace)::row_sums(RowArgs)" -> "row_sums")."""
    n = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return n.split("(")[0].split("<")[0].strip() or name


def time_ms(fn, reps: int = 15, warm: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def queued_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Device time of one fn() call: the median over ``reps`` calls of CUDA
    events around each, with all calls queued behind a sleeping kernel, so
    the card runs them one after another without waiting for the host
    (launch gaps on the card included, host time not). fn must not
    synchronise."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    torch.cuda._sleep(50_000_000)  # ~30 ms, longer than the host takes to queue the calls
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


#: the kernel of ``torch.cuda._sleep``, which marks the measured calls
MARK = "spin_kernel"
#: markers launched before and after the measured calls: a trace may lose
#: launches, markers included
MARKS = 16


def _trace(fn, reps: int, lead: int = 2) -> tuple[list | None, str]:
    """(the device events of ``reps`` fn() calls in start order, or None;
    what the trace held). On the machine of an NVIDIA H100 80GB HBM3 at
    700 W a trace lost some device events (3 of 5 or 8 of 10 calls of one
    kernel kept; with one marker each side, now and then a marker). So a
    sleeping kernel (10^6 cycles), ``lead``
    calls and ``MARKS`` short
    ``torch.cuda._sleep`` kernels run first inside the trace and ``MARKS``
    more after the measured calls, and the host waits 10 ms before the
    trace ends: the events kept are those between the last two runs of
    markers. The profiler keeps its events across cycles (``acc_events``)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        torch.cuda._sleep(1_000_000)
        for _ in range(lead):
            fn()
        for _ in range(MARKS):
            torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        for _ in range(MARKS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.01)
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(evs) if short_name(e.name).endswith(MARK)]
    runs = [[i] for i in marks[:1]]
    for i in marks[1:]:
        if i == runs[-1][-1] + 1:
            runs[-1].append(i)
        else:
            runs.append([i])
    held = f"{len(evs)} device events, {len(marks)} of {2 * MARKS + 1} markers in {len(runs)} runs"
    if len(runs) < 2:
        return None, held
    return evs[runs[-2][-1] + 1: runs[-1][0]], held


def device_split(fn, reps: int = 10, warm: int = 2, band: tuple | None = None,
                 log=print) -> dict | None:
    """Device time of one fn() call by launch, in ms: torch.profiler (CPU
    and CUDA activities) over ``reps`` back-to-back calls (``_trace``),
    each device event's duration summed under its short name and divided
    by ``reps``.
    A memset is named after the kernel that follows it ("memset>row_sums"),
    so the memsets of one entry point stay apart from another's. A trace
    holds the device work of every thread (a sim's prefetch thread adds
    its copies), and a trace may lack some of fn's events; so a launch
    name counts only when it occurs a multiple of ``reps`` times, and the
    trace only when the split's sum falls in ``band`` (lowest, highest ms;
    highest None for no ceiling), e.g. around the queued time of the same
    calls. A split that left launch names out is partial and lists them
    under "dropped". After three traces that fail, ``log`` gets each
    one's reason and the split is None (not measured)."""
    for _ in range(warm):
        fn()
    reasons = []
    for _ in range(3):
        evs, held = _trace(fn, reps)
        if evs is None:
            reasons.append(held)
            continue
        names = [short_name(e.name) for e in evs]
        for i, n in enumerate(names):
            if n.lower().startswith("memset"):
                nxt = next((m for m in names[i + 1:] if not m.lower().startswith("memset")), "end")
                names[i] = f"memset>{nxt}"
        counts = Counter(names)
        whole = {n for n, c in counts.items() if c % reps == 0}
        split: dict[str, float] = {}
        for e, n in zip(evs, names):
            if n in whole:
                split[n] = split.get(n, 0.0) + e.time_range.elapsed_us() / 1000.0 / reps
        total = sum(split.values())
        if split and (band is None or (band[0] <= total and (band[1] is None or total <= band[1]))):
            dropped = sorted(set(names) - whole)
            if dropped:
                split["dropped"] = dropped
            return split
        partial = {n: c for n, c in counts.items() if n not in whole}
        reasons.append(f"{held}; {len(evs)} measured, sum {total:.4f} ms of whole launches "
                       f"(band {band}), counts not a multiple of {reps}: {partial}")
    log("# torch.profiler: three traces in a row failed the checks; split not measured: "
        + " | ".join(reasons))
    return None
