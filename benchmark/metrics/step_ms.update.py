"""Mean per cycle of the harness's host-clock spans around the step
(``make_params``, ``step_from_numpy``) and the aux pull that waits for it
(ms)."""


def read(ctx):
    env, run = ctx["env"], ctx["run"]
    total = sum(b - a for n, a, b in env.spans if n in ("step", "pull"))
    if not run.cycles or total == 0:
        return None
    return 1e3 * total / len(run.cycles)
