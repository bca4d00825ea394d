"""Device milliseconds a step of the port's own kernels: the device time
under each outermost ``millieye::<name>`` op of the trace (every
hand-written kernel is called through such a custom op)."""


def read(run):
    if not run.trace or not run.trace.ops:
        return None
    return sum(op[4] for op in run.trace.ops) / run.trace.steps / 1e3
