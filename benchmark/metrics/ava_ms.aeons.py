"""A batch's ``aeons.ava`` spans summed, averaged over the window's
batches (ms): each overlap search of the batch (new reads, contigs,
trimmed sequences, unitigs), the pool's index, the seeding (H6 on the
card, the ultralong bucket on the host), the records and their merge."""

NAME = "aeons.ava"


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
