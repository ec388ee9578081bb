"""Mean per batch of the sim's ``sim.align`` spans (ms): the classic flow's
live alignment, the prefixes' mapping, the decisions and the accepted
reads' mapping; spans under the window's ``sim.batch``."""

NAMES = ("sim.align",)


def read(ctx):
    run = ctx["run"]
    if not run.cycles:
        return None
    try:
        from bossruns_torch.utils import spans
    except ImportError:  # a program without the recorder
        return None
    env = ctx["env"]
    w = spans.window(env.window_start, env.window_end, under="sim.batch")
    if not any(n in w.seconds for n in NAMES):
        return None
    return 1e3 * sum(w.seconds.get(n, 0.0) for n in NAMES) / len(run.cycles)
