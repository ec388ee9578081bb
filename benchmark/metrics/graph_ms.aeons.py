"""A batch's ``aeons.graph`` spans summed, averaged over the window's
batches (ms): the link store's classification of each search's records,
the containment increments, the trims and the removals."""

NAME = "aeons.graph"


def read(ctx):
    run = ctx["run"]
    if not run.cycles:
        return None
    try:
        from bossruns_torch.utils import spans
    except ImportError:  # a program without the recorder
        return None
    env = ctx["env"]
    w = spans.window(env.window_start, env.window_end, under="aeons.batch")
    if NAME not in w.seconds:
        return None
    return 1e3 * w.seconds[NAME] / len(run.cycles)
