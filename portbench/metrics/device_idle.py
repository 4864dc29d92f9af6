"""The share of the traced ticks' time, in %, in which no device operation ran."""


def read(run):
    t = run.trace
    return (1.0 - t.busy_s / t.window_s) * 100.0 if t.window_s and t.busy_s else None
