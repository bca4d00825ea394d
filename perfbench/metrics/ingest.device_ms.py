"""Device milliseconds a step of the kernels launched under the batch
fetch and the radar rasterization (``perfbench.ingest``: the
``DeviceCache`` loader's gather and ``fusion_device_batch``)."""


def read(run):
    spans = run.trace.spans.get("ingest") if run.trace else None
    if not spans:
        return None
    return sum(dev for _, dev in spans) / len(spans) / 1e3
