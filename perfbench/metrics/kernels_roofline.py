"""The port's kernels' share of their roofline, in percent: the sum of
each launch's bound (``perfbench/roofline.py``, from the shapes the
trace recorded for its ``millieye::<name>`` op) over the sum of the
launches' device time."""
from perfbench.roofline import launch_bound_s


def read(run):
    if not run.trace:
        return None
    ops = [op for op in run.trace.ops if op[4] > 0]
    if not ops:
        return None
    bound = sum(launch_bound_s(name, shapes, dtypes, concrete)
                for name, shapes, dtypes, concrete, _ in ops)
    return 100.0 * bound / (sum(op[4] for op in ops) / 1e6)
