"""Mean per cycle of the engine"s ``engine.pull_aux`` spans (ms): the one
copy of the step"s scalars, which waits for the step on the device."""

NAMES = ("engine.pull_aux",)


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
    if not any(n in w.seconds for n in NAMES):
        return None
    return 1e3 * sum(w.seconds.get(n, 0.0) for n in NAMES) / len(run.cycles)
