"""Mean per batch of the AEONS sim's ``aeons.strategy`` spans (ms): the
contig descriptors, H7 and the mask's pull."""

NAME = "aeons.strategy"


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
