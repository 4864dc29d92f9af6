"""The host's ms to issue one tick's work, the median over the ticks before
the trace starts (a profiler slows the host's eager ops after it has run)."""

import numpy as np


def read(run):
    ticks = run.window.host_tick_s
    return float(np.median(ticks)) * 1e3 if ticks else None
