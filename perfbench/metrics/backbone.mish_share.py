"""The share, in percent, of the backbone's Mish convolution blocks whose
tail (batch norm's affine step, then Mish) ran as the program's one-pass
epilogue kernel in its Mish mode: the program's counter
``darknet.epilogue_mish`` over ``darknet.mish``, through the traced
stretch. None for a program that keeps neither counter (one without
Mish)."""
from perfbench.program import counters


def read(run):
    c = counters(run)
    if not c or not c.get("darknet.mish"):
        return None
    return 100.0 * c.get("darknet.epilogue_mish", 0) / c["darknet.mish"]
