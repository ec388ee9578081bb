"""Mean per cycle of the ``bytes.disk`` counter (MiB): bytes the program
wrote to files (the strategy file, the checkpoint, the metrics lines,
the read dumps)."""

NAMES = ("bytes.disk",)


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
