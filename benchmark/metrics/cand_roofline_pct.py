"""H6's least time on the card over its device time in the window (%).

The least time is ``work_aeons.py``'s: each seeding call's packed reads,
the index keys and packed occurrences its minimizers can look up (at most
the whole index) and its clusters, once a call, over the HBM rate, for the H6 calls the driver read from the program's
``ava.seed`` spans in the window (the host-seeded ultralong bucket left
out). The device time is the traced window's time in H6's kernel
(``cand_vote``): the driver's sum over the profile, else the trace
summary's top operations."""


def read(ctx):
    run, tr = ctx["run"], ctx["trace"]
    calls = run.extra.get("ava_calls")
    if tr is None or not calls:
        return None
    dev_s = run.extra.get("h6_device_s")
    if not dev_s:
        dev_s = sum(s for name, s in tr.get("device_ops", []) if "cand_vote" in name)
    if not dev_s:
        return None
    from benchmark.work_aeons import cand_least_s

    return 100.0 * cand_least_s(calls) / dev_s
