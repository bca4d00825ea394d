"""The share, in percent, of the backbone's plain convolution blocks whose
tail (batch norm's affine step or the bias, then the activation) ran as
the program's one-pass epilogue kernel: the program's counter
``darknet.epilogue`` over ``darknet.convs``, through the traced stretch.
None for a program that keeps neither counter."""
from perfbench.program import counters


def read(run):
    c = counters(run)
    if not c or not c.get("darknet.convs"):
        return None
    return 100.0 * c.get("darknet.epilogue", 0) / c["darknet.convs"]
