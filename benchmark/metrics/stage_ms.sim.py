"""Mean per batch of the engine"s ``engine.pack`` and ``engine.upload``
spans inside the sim"s prefetch (``sim.prefetch``) (ms): packing the
gated wire into pinned staging, with the wait for a free staging buffer,
and the async copy"s host side."""

NAMES = ("engine.pack", "engine.upload")


def read(ctx):
    run = ctx["run"]
    if not run.cycles:
        return None
    try:
        from bossruns_torch.utils import spans
    except ImportError:  # a program without the recorder
        return None
    env = ctx["env"]
    w = spans.window(env.window_start, env.window_end, under="sim.prefetch")
    if not any(n in w.seconds for n in NAMES):
        return None
    return 1e3 * sum(w.seconds.get(n, 0.0) for n in NAMES) / len(run.cycles)
