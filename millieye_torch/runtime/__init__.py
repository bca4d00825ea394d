from millieye_torch.runtime.profiler import StageTimer, trace_annotation

# The engine and the stream import the models, and the models import the
# profiler's spans: they load on first use, so that a model imported
# first does not find this package half made.
_LAZY = {"FusionEngine": "engine", "StreamingPipeline": "stream",
         "FrameSource": "stream"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
