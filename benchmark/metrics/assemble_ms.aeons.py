"""Mean per batch of the AEONS sim's ``aeons.assemble`` spans (ms): the
unitig walk and the frozen reads' removal (the unitigs' re-ingest counts
under ``ava_ms.aeons`` and ``graph_ms.aeons``)."""

NAME = "aeons.assemble"


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
