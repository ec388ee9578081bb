"""Mean over the window's batches of the cycle's end (host clock, the
harness's) minus the end of the sim's ``device`` phase (ms): the mask's
publication, the metrics line and the periodic checkpoint."""

BEFORE_WRITE = ("sample", "align", "decide", "coo", "overlap", "device")


def read(ctx):
    run = ctx["run"]
    phases = run.extra.get("phases")
    if not phases:
        return None
    tails = [(t1 - t0) - sum(float(p.get(k, 0.0)) for k in BEFORE_WRITE)
             for (t0, t1, _), p in zip(run.cycles, phases)]
    return 1e3 * sum(tails) / len(tails)
