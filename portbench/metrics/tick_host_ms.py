"""The host's ms in the program's ``tick`` span (one lockstep tick of an episode,
one ``Controller.step``), the median over the untraced ticks: the in-program
counterpart of ``host_issue_ms``."""


def read(run):
    spans = getattr(run.trace, "spans", None)
    return None if spans is None else spans.tick_host_ms
