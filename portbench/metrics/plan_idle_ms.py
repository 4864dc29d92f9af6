"""Device idle ms a traced tick while the host was inside the ``plan`` span: the
idle a graph over the planner could close. Read under the profiler, which
stretches the host's tick."""


def read(run):
    spans = getattr(run.trace, "spans", None)
    return None if spans is None else spans.plan_idle_ms
