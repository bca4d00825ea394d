"""The share, in percent, of the NMS keep mask's candidate rows that it
keeps: the program's counter ``nms.kept`` (kept rows, before the
``max_det`` cut) over ``nms.live``, through the traced stretch."""
from perfbench.program import counters


def read(run):
    c = counters(run)
    if not c or not c.get("nms.live"):
        return None
    return 100.0 * c["nms.kept"] / c["nms.live"]
