"""Mean per cycle of the ``mask.write`` spans (ms): writing the strategy
file the readfish side reads (``np.savez`` and the rename)."""

NAMES = ("mask.write",)


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
