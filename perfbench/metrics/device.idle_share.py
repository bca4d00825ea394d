"""The share of the traced stretch, in percent, in which no operation
ran on the device."""


def read(run):
    if not run.trace or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
