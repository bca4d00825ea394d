"""Device milliseconds a step of the kernels launched under the forward
(``perfbench.forward``: the network, its decode and NMS, and the
heads)."""


def read(run):
    spans = run.trace.spans.get("forward") if run.trace else None
    if not spans:
        return None
    return sum(dev for _, dev in spans) / len(spans) / 1e3
