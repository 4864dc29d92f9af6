"""Device ms a traced tick of the operations launched inside the ``plan`` span
and outside the ``fwd.*`` spans: the planner's own device time, without the
forward, the draws and the plant's step."""


def read(run):
    spans = getattr(run.trace, "spans", None)
    return None if spans is None else spans.plan_device_ms
