"""Device ms a traced tick of every operation that is not the forward's."""


def read(run):
    t = run.trace
    return t.other_device_s / t.ticks * 1e3 if t.ticks and t.other_device_s else None
