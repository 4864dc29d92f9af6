"""Device operations (kernels, copies, sets) a traced tick, from the profiler."""


def read(run):
    t = run.trace
    return t.device_ops / t.ticks if t.ticks and t.device_ops else None
