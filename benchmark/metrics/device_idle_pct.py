"""The share of the traced window in which no kernel, copy or memset ran
on the card (%), from the profiler's timeline (``trace.py``; cycles that
lost device events count at the complete cycles' median)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
