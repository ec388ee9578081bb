"""Mean of the simulation's own ``sample`` phase over the window's batches
(ms): the critical-path wait for the prefetched batch (sampling, PAF
parse, coverage rows, packing and upload), read from the metrics lines
the sim writes (``metrics/batches.jsonl``)."""


def read(ctx):
    phases = ctx["run"].extra.get("phases")
    if not phases:
        return None
    return 1e3 * sum(float(p["sample"]) for p in phases) / len(phases)
