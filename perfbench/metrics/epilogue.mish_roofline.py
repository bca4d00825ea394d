"""The epilogue kernel's share of its roofline in its Mish mode, in
percent: over the traced ``millieye::conv_epilogue`` launches whose
activation argument is 2 (Mish), the time their bytes take at the HBM
bandwidth (``perfbench/roofline.py:HBM_BYTES_S``) over their device time.
A launch's bytes (``launch_bytes``): x read, the output written at the
widest of the inputs' types (the op writes the eager result's promotion
of x and its vectors), and the per-channel vectors read once. Where the
profiler records no dtypes (torch 2.11 keeps none), an element takes the
bytes of the configuration's peak (``run.peak_flop_s``, the one thing of
the configuration a reader is handed): 4 under the float32 peak, else 2.
That stands for the tails' dtype only where the two agree, as in
``yolov4-608`` (float32 both); a configuration with a 16-bit peak and
float32 tails would be counted at half its bytes. None where no launch
ran Mish: a model without it, or a program whose op takes a flag for
leaky alone."""
from perfbench.roofline import _ITEM, F32_FLOP_S, HBM_BYTES_S, _numel

MISH = 2


def launch_bytes(shapes, dtypes, item=2):
    """Bytes of one launch with inputs of ``shapes`` (x, bias, mean, inv,
    gamma; an absent vector records no shape) and ``dtypes`` (the
    profiler's names, or None: ``item`` bytes an element)."""
    sizes = [_ITEM.get(d, item) for d in dtypes or [None] * len(shapes)]
    present = [i for i in range(5) if shapes[i]]
    out = max(sizes[i] for i in present)
    vectors = sum(_numel(shapes[i]) * sizes[i] for i in present[1:])
    return _numel(shapes[0]) * (sizes[0] + out) + vectors


def read(run):
    if not run.trace:
        return None
    ops = [op for op in run.trace.ops if op[0] == "conv_epilogue"
           and op[3] is not None and len(op[3]) > 5 and op[3][5] == MISH
           and op[4] > 0]
    if not ops:
        return None
    item = 4 if getattr(run, "peak_flop_s", None) == F32_FLOP_S else 2
    bound_s = sum(launch_bytes(shapes, dtypes, item)
                  for _, shapes, dtypes, _, _ in ops) / HBM_BYTES_S
    return 100.0 * bound_s / (sum(op[4] for op in ops) / 1e6)
