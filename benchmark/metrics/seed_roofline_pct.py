"""H5's least time on the card over its device time in the window (%).

The least time is ``work_align.py``'s: each seeding call's packed reads,
the index's keys and packed occurrences and its result, once a call, over
the HBM rate, for the calls the driver read from the program's
``align.dispatch`` spans in the window. The device time is the traced
window's time in H5's kernel (``seed_vote``): the driver's sum over the
profile, else the trace summary's top operations."""


def read(ctx):
    run, tr = ctx["run"], ctx["trace"]
    calls, n_keys = run.extra.get("seed_calls"), run.extra.get("n_keys")
    if tr is None or not calls or not n_keys:
        return None
    dev_s = run.extra.get("h5_device_s")
    if not dev_s:
        dev_s = sum(s for name, s in tr.get("device_ops", []) if "seed_vote" in name)
    if not dev_s:
        return None
    from benchmark.work_align import seed_least_s

    return 100.0 * seed_least_s(calls, n_keys) / dev_s
