"""Steps of the window whose scores stage rescored every site, over all
its steps (%), from the program's ``scores.full`` and ``scores.tiled``
counters (one a step of the single engine): the rest rescored only the
tiles their batch touched."""

NAMES = ("scores.full", "scores.tiled")


def read(ctx):
    run = ctx["run"]
    if not run.cycles:
        return None
    try:
        from bossruns_torch.utils import spans
    except ImportError:  # a program without the recorder
        return None
    env = ctx["env"]
    c = spans.window(env.window_start, env.window_end).counts
    n = sum(c.get(k, 0) for k in NAMES)
    if n == 0:
        return None
    return 100.0 * c.get("scores.full", 0) / n
