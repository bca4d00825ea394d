"""ctypes bindings of the repository's native host library (the
``me_dbscan`` and ``me_hungarian`` bindings of
``millieye_tpu/native/__init__.py``, copied: the port imports nothing of
the JAX package).

The library is ``native/libmillieye_native.so`` at the repository root,
built from ``native/millieye_native.cpp`` by ``native/Makefile`` on first
use where it is missing; both packages load the same file. Every caller
treats a failure to build or load it as "use the Python fallback", so
the radar chain runs without a compiler too.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_LIB_PATH = _NATIVE_DIR / "libmillieye_native.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        subprocess.run(["make", "-C", str(_NATIVE_DIR), "-s"], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.me_dbscan.restype = ctypes.c_int
    lib.me_dbscan.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.c_double, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.me_hungarian.restype = ctypes.c_int
    lib.me_hungarian.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    _lib = lib
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def dbscan_native(points, eps, min_samples):
    lib = _load()
    pts = np.ascontiguousarray(points, np.float64)
    n, d = pts.shape
    labels = np.empty(n, np.int64)
    lib.me_dbscan(_dptr(pts), n, d, float(eps), int(min_samples),
                  _lptr(labels))
    return labels


def hungarian_native(cost):
    lib = _load()
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    transposed = n > m
    if transposed:
        cost = np.ascontiguousarray(cost.T)
        n, m = m, n
    col = np.empty(n, np.int64)
    lib.me_hungarian(_dptr(cost), n, m, _lptr(col))
    rows = np.arange(n, dtype=np.int64)
    if transposed:
        rows, col = col, rows
    order = np.argsort(rows)
    return rows[order], col[order]
