"""Mean per batch of the AEONS sim's ``aeons.decide`` spans (ms): the
decision aligner's rebuild over the contigs in force (its ``align.index``),
the mapping of the reads' mu-base prefixes, the strategy's lookups and
the pseudotime; spans under the window's ``aeons.batch``."""

NAME = "aeons.decide"


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
