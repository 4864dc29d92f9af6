"""The host's ms in the planner's ``plan`` span, the median over the untraced ticks."""


def read(run):
    spans = getattr(run.trace, "spans", None)
    return None if spans is None else spans.plan_host_ms
