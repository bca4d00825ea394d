"""Frames answered in the window over the window's whole time (host
clock, from the first step's start to the last step's rows on the
host)."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
