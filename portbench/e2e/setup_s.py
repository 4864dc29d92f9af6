"""Seconds from the process's start to the window's first tick: imports, the
kernel build where there is none, the weights, the planner, the warm-up."""


def read(run):
    return run.setup_s
