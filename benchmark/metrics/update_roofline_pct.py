"""The update's least time on the card over its device time (%).

The least time is ``work.py``'s: the bytes the state transition needs at
the cell's shapes over the HBM rate, or its arithmetic over the peaks
where that is larger, the mean over the cell's batches. The device time
is the mean over the traced window's cycles of the kernels and memsets
each cycle ran (copies left out: the batch's upload is a host-to-device
transfer, not HBM time)."""


def read(ctx):
    tr, work = ctx["trace"], ctx["run"].extra.get("work")
    if tr is None or work is None or not tr.get("cycle_device_s"):
        return None
    least_s, _by = work["least"]
    return 100.0 * least_s / tr["cycle_device_s"]
