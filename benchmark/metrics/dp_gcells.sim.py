"""The host DP's rate (billions of cells a second): the ``align.dp_cells``
counter over the window (each job's query bases times its band's width)
over the seconds of the ``align.extend`` spans under the window's
``sim.batch`` (the DP and the records' assembly)."""


def read(ctx):
    run = ctx["run"]
    if not run.cycles:
        return None
    try:
        from bossruns_torch.utils import spans
    except ImportError:  # a program without the recorder
        return None
    env = ctx["env"]
    cells = spans.window(env.window_start, env.window_end).counts.get("align.dp_cells")
    secs = spans.window(env.window_start, env.window_end,
                        under="sim.batch").seconds.get("align.extend")
    if not cells or not secs:
        return None
    return cells / secs / 1e9
