"""Mean per cycle of the engine"s ``engine.params``, ``engine.upload`` and
``engine.launch`` spans (ms): the step"s parameters, the wire"s async
copy and the graph"s input copy and replay (or a capture, or the eager
body)."""

NAMES = ("engine.params", "engine.upload", "engine.launch")


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
