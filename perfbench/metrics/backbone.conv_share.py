"""The share, in percent, of the backbone's plain convolution blocks whose
convolution ran as the program's own implicit-GEMM kernel: the program's
counter ``darknet.conv_kernel`` over ``darknet.convs``, through the
traced stretch. None for a program that keeps neither counter."""
from perfbench.program import counters


def read(run):
    c = counters(run)
    if not c or not c.get("darknet.convs") or "darknet.conv_kernel" not in c:
        return None
    return 100.0 * c["darknet.conv_kernel"] / c["darknet.convs"]
