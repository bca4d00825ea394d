"""Config parsers and weight files (port of ``millieye_tpu/io``).

The names are re-exported lazily, on first access: the deployment
loader ``io/export.py:load_serving`` imports this package, and must load
torch and ``ops/library.py`` only, no weight reader."""
import importlib

_EXPORTS = {
    "parse_model_config": "config",
    "parse_data_config": "config",
    "load_classes": "config",
    "load_darknet_weights": "darknet_weights",
    "save_darknet_weights": "darknet_weights",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
