"""The program's float32 convolution kernel's share of its roofline, in
percent: over the traced ``millieye::conv2d_nhwc`` launches, the time
their operations take at the float32 peak (``perfbench/roofline.py:
F32_FLOP_S``) over their device time. A launch's operations
(``launch_flops``): 2 * N * Ho * Wo * Cout * Cin * kh * kw, from the
input's recorded shape [N, Cin, H, W], the packed weights' [kh, kw,
Cin, Cout padded to a multiple of 4], and the ints the op records: Cout,
the stride and the padding, Ho = (H + 2 * pad - kh) // stride + 1 (Wo
likewise). None where no launch ran, or where a launch's ints went
unrecorded (its operations cannot be counted exactly)."""
from perfbench.roofline import F32_FLOP_S

OP = "conv2d_nhwc"


def launch_flops(shapes, concrete):
    """Operations of one launch with inputs of ``shapes`` (x, w, cout,
    stride, pad) and ``concrete`` values (the ints at 2, 3 and 4), or
    None."""
    if concrete is None or len(concrete) < 5 or len(shapes) < 2:
        return None
    cout, stride, pad = concrete[2:5]
    if not all(isinstance(v, int) for v in (cout, stride, pad)) \
            or stride < 1:
        return None
    n, cin, h, w = shapes[0]
    kh, kw = shapes[1][:2]
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    return 2 * n * ho * wo * cout * cin * kh * kw


def read(run):
    if not run.trace:
        return None
    ops = [op for op in run.trace.ops if op[0] == OP and op[4] > 0]
    if not ops:
        return None
    flops = [launch_flops(shapes, concrete)
             for _, shapes, _, concrete, _ in ops]
    if any(f is None for f in flops):
        return None
    return 100.0 * (sum(flops) / F32_FLOP_S) / (sum(op[4] for op in ops) / 1e6)
