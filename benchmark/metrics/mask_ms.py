"""Mean per cycle of the strategy"s publication, ``mask.pull``,
``mask.split`` and ``mask.write`` spans (ms): its copy to the host, the
per-contig arrays and the file the readfish side reads; a sim"s
constructor"s first mask counts in its batches" share."""

NAMES = ("mask.pull", "mask.split", "mask.write")


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
