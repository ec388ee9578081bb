"""Mean per cycle of the ``bytes.d2h`` counter (MiB): bytes the program
copied from the device (the step"s scalars, the strategy, the
checkpointed state)."""

NAMES = ("bytes.d2h",)


def read(ctx):
    run = ctx["run"]
    if not run.cycles:
        return None
    try:
        from bossruns_torch.utils import spans
    except ImportError:  # a program without the recorder
        return None
    env = ctx["env"]
    w = spans.window(env.window_start, env.window_end)
    if not any(n in w.counts for n in NAMES):
        return None
    return 2.0 ** -20 * sum(w.counts.get(n, 0) for n in NAMES) / len(run.cycles)
