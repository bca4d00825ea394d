"""ctypes bindings of the repository's native host library (the
``me_dbscan``, ``me_hungarian`` and ``me_parse_mmwave_frame`` bindings
of ``millieye_tpu/native/__init__.py``, copied: the port imports nothing
of the JAX package).

The source is ``native/millieye_native.cpp`` with its ``Makefile``. The
port builds its own copy, ``build/millieye_torch/native/
libmillieye_native.so`` at the repository root, on first use where it is
missing or older than the source: under an exclusive file lock, the two
files copied into a fresh temporary directory there, ``make`` run in it,
and the library moved into place with ``os.replace``. So processes that
start together (test workers) build it once, and none loads a file that
is still being written. (The JAX package builds ``native/
libmillieye_native.so`` in place, without a lock.) Every caller treats a
failure to build or load it as "use the Python fallback", so the radar
chain and the UART frame parser run without a compiler too.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_NATIVE_DIR = _ROOT / "native"
_BUILD_DIR = _ROOT / "build" / "millieye_torch" / "native"
_LIB_PATH = _BUILD_DIR / "libmillieye_native.so"
_SOURCES = ("Makefile", "millieye_native.cpp")
_lib = None


def _fresh():
    return _LIB_PATH.exists() and all(
        _LIB_PATH.stat().st_mtime >= (_NATIVE_DIR / f).stat().st_mtime
        for f in _SOURCES)


def _build():
    """Build the library into ``_LIB_PATH`` unless a fresh one is there,
    one process at a time."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh():
            return
        tmp = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
        try:
            for f in _SOURCES:
                shutil.copy2(_NATIVE_DIR / f, tmp / f)
            subprocess.run(["make", "-C", str(tmp), "-s"], check=True,
                           capture_output=True)
            os.replace(tmp / "libmillieye_native.so", _LIB_PATH)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _fresh():
        _build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.me_dbscan.restype = ctypes.c_int
    lib.me_dbscan.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.c_double, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.me_hungarian.restype = ctypes.c_int
    lib.me_hungarian.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long)]
    lib.me_parse_mmwave_frame.restype = ctypes.c_int
    lib.me_parse_mmwave_frame.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
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


def parse_mmwave_frame(buf, max_points=1024):
    """buf: bytes/bytearray. Returns (ok, xyzv [n, 4], frame_number,
    consumed_bytes)."""
    lib = _load()
    arr = np.frombuffer(bytes(buf), np.uint8)
    out = np.empty((max_points, 4), np.float32)
    n_pts = ctypes.c_long()
    frame_no = ctypes.c_long()
    consumed = ctypes.c_long()
    ok = lib.me_parse_mmwave_frame(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(arr),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_points,
        ctypes.byref(n_pts), ctypes.byref(frame_no), ctypes.byref(consumed))
    return bool(ok), out[:n_pts.value].copy(), frame_no.value, consumed.value
