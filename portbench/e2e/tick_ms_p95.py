"""The 95th percentile of every tick of the window, in ms, from the
observation handed in to the action back on the host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window.tick_s) * 1e3, 95)) if run.window.tick_s else None
