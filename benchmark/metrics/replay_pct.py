"""Steps of the window replayed from a captured CUDA graph, over all its
steps (%), from ``RunsEngine.graphs.stats()``; a step run eagerly (a
shape's first, or any on a path the graphs do not take) counts against."""


def read(ctx):
    c = ctx["run"].counters
    n = c.get("replays", 0) + c.get("eager", 0)
    if n == 0:
        return None
    return 100.0 * c["replays"] / n
