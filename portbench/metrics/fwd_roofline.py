"""The forward's share of its roofline, in %: the least time of the traced
forwards (their FLOPs at the TF32 peak or their bytes at HBM bandwidth,
whichever is larger, counted from the model's dims) over their device time."""

from portbench import flops


def read(run):
    t = run.trace
    if not (t.fwd_launches and t.fwd_device_s):
        return None
    rows = t.fwd_rows / t.fwd_launches
    return t.fwd_launches * flops.forward_least_seconds(rows, **t.cell) / t.fwd_device_s * 100.0
