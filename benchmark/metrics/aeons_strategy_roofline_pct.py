"""H7's least time on the card over its device time in the window (%).

The least time is ``work_aeons.py``'s: each strategy's chunk means,
contig descriptors, score table and mask, once a call, over the HBM rate,
for the strategies the driver read from the program's ``aeons.strategy``
spans (attrs ``chunks``, ``contigs``) in the window. The device time is
the traced window's time in H7's four kernels (``aeons_scan``,
``aeons_windows``, ``aeons_bins``, ``aeons_mask``): the driver's sum over
the profile, else the trace summary's top operations."""


def read(ctx):
    run, tr = ctx["run"], ctx["trace"]
    sizes = run.extra.get("strategy_sizes")
    if tr is None or not sizes:
        return None
    dev_s = run.extra.get("h7_device_s")
    if not dev_s:
        dev_s = sum(s for name, s in tr.get("device_ops", []) if "aeons_" in name)
    if not dev_s:
        return None
    from benchmark.work_aeons import strategy_least_s

    return 100.0 * strategy_least_s(sizes) / dev_s
