"""Device ms a traced tick of the forward's kernels, matched by name."""


def read(run):
    t = run.trace
    return t.fwd_device_s / t.ticks * 1e3 if t.ticks and t.fwd_device_s else None
