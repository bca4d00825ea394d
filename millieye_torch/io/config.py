"""Config-file readers (port of ``millieye_tpu/io/config.py``, a copy:
the port imports nothing of the JAX package).

Three text formats of the reference ecosystem:

* darknet ``.cfg`` model files (INI-like ``[block]`` sections), which
  drive the graph and keep ``.weights`` files loadable;
* ``.data`` dataset descriptors (``key=value`` lines);
* ``.names`` class-name lists (one per line).

``models/zoo.py`` declares the same block-dict schema in Python.
"""
from __future__ import annotations


def parse_model_config(path):
    """A darknet ``.cfg`` -> a list of block dicts ``{"type": ..., key:
    value, ...}``; convolutional blocks get ``batch_normalize`` "0" unless
    the file sets it."""
    blocks = []
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                block = {"type": line[1:line.index("]")].strip()}
                if block["type"] == "convolutional":
                    block["batch_normalize"] = "0"
                blocks.append(block)
            else:
                key, _, value = line.partition("=")
                blocks[-1][key.strip()] = value.strip()
    return blocks


def parse_data_config(path):
    """A ``.data`` descriptor -> dict, with the reference's ``gpus`` and
    ``num_workers`` defaults; a value with spaces becomes a list."""
    options = {"gpus": "0,1,2,3", "num_workers": "10"}
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition("=")
            value = value.strip()
            parts = value.split(" ")
            options[key.strip()] = parts if len(parts) > 1 else value
    return options


def load_classes(path):
    """Class names, one per line; the trailing empty line dropped."""
    with open(path) as fh:
        return fh.read().split("\n")[:-1]
