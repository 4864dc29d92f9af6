"""Rollouts planned per second: S K a tick over every tick of the whole
episode batches the window ran, over all the time of those batches."""


def read(run):
    return run.window.work / run.window.seconds
