"""Host milliseconds a step spends in the call into the forward
(``perfbench.forward``: ``FusionNetwork.apply`` or ``Darknet.apply``
with its NMS) until it returns, before the copy back: the time the host
takes to launch the forward."""


def read(run):
    spans = run.trace.spans.get("forward") if run.trace else None
    if not spans:
        return None
    return sum(host for host, _ in spans) / len(spans) / 1e3
