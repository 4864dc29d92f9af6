"""The host's ms a tick in the forward's ``fwd.*`` spans, summed over a tick's
forwards, the median over the untraced ticks: the forward's host side,
with any wait inside a launch call."""


def read(run):
    spans = getattr(run.trace, "spans", None)
    return None if spans is None else spans.fwd_issue_ms
