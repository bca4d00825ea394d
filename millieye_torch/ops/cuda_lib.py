"""Build and load the port's CUDA kernels.

Each source under ``millieye_torch/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds. Libraries land in
``build/millieye_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and its flags, so an edited source is rebuilt and an
unchanged one is reused. ``build()``
starts one ``nvcc`` for each missing library, all at once.

Every kernel wrapper calls its ``torch.library`` op
``millieye::<name>`` (``kernel_op``), so that ``torch.export`` and other
tracers see one operator with an output shape instead of a ``ctypes``
call. The op's CUDA implementation asks ``takes_plain`` whether to run
the plain version instead: it does so only inside a ``plain_versions()``
block, unless the block keeps that wrapper's kernel (``keep``); a CPU
tensor always takes the plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "millieye_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# per-source flags: the NMS keep set must be bit-equal to the float32
# reference, so its IoU arithmetic may not be contracted into FMAs. No
# source is built with fast math: the quantizer's w / scale is IEEE.
SOURCES = {
    "nms": ("nms.cu", ("-fmad=false",)),
    "roi_align": ("roi_align.cu", ()),
    "stem": ("stem.cu", ()),
    "quantize": ("quantize.cu", ()),
    "epilogue": ("epilogue.cu", ()),
    "conv": ("conv.cu", ()),
}

# the kernel wrappers' names, as they ask takes_plain and as chip_smoke.py
# reports them
KERNELS = frozenset((
    "nms", "nms_full", "ps_roi_align", "ps_roi_align_vpu", "roi_align",
    "ps_roi_align_f32", "ps_roi_align_padded_f32", "stem_pair",
    "stem_pair_select", "stem_pair_packed", "stem_pair_s2d",
    "stem_pair_deep", "stem_stage", "fused_stem", "quantize_stochastic",
    "conv_epilogue", "conv2d_nhwc"))

_loaded = {}
# the namespace every kernel_op defines its op in
_OPS_LIB = torch.library.Library("millieye", "FRAGMENT")
_plain_on_cuda = False
_kept = frozenset()


@contextlib.contextmanager
def plain_versions(keep=()):
    """Inside this block every kernel wrapper runs its plain version on
    CUDA tensors too, and counts no launch: the on-card reference that
    ``chip_smoke.py`` holds the kernel path against. The wrappers named
    in ``keep`` (names from ``KERNELS``) still launch their kernels, so a
    path can be held to a run in which only those kernels ran."""
    global _plain_on_cuda, _kept
    keep = frozenset(keep)
    if not keep <= KERNELS:
        raise ValueError(f"plain_versions: unknown kernels "
                         f"{sorted(keep - KERNELS)}")
    prev = _plain_on_cuda, _kept
    _plain_on_cuda, _kept = True, keep
    try:
        yield
    finally:
        _plain_on_cuda, _kept = prev


def takes_plain(t, name):
    """Whether the kernel wrapper ``name`` given tensor ``t`` runs its
    plain version."""
    if name not in KERNELS:
        raise ValueError(f"takes_plain: unknown kernel {name!r}")
    return t.device.type == "cpu" or (_plain_on_cuda and name not in _kept)


def kernel_op(name, schema, plain, launch, fake, wrapper, contiguous=True):
    """Define the op ``millieye::<name>`` (``name`` from ``KERNELS``)
    with ``schema`` and return it. On the CPU it runs ``plain``; on the
    card ``launch``, counted on ``wrapper.launches``, or ``plain`` where
    ``takes_plain`` says so, read at each call (a replayed exported
    program too). ``fake`` gives the outputs' shapes and dtypes while
    tracing, and never touches a library. The plain outputs are made
    contiguous, as most kernels write theirs; with ``contiguous=False``
    they keep the layout ``plain`` gives them, which must be the
    kernel's. The op keeps ``plain``, ``launch`` and ``wrapper`` as
    attributes. The implementations are registered with the dispatcher
    directly (``torch.library.Library.impl``): a ``torch.library.
    custom_op`` wraps each call in Python autograd and aliasing checks
    that cost the host ~15 us a call, and these ops have no backward."""
    if name not in KERNELS:
        raise ValueError(f"kernel_op: unknown kernel {name!r}")

    def _plain(*args):
        out = plain(*args)
        if not contiguous:
            return out
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()

    def _cuda(*args):
        if takes_plain(args[0], name):
            return _plain(*args)
        out = launch(*args)
        wrapper.launches += 1
        return out

    _OPS_LIB.define(name + schema)
    _OPS_LIB.impl(name, _plain, "CPU")
    _OPS_LIB.impl(name, _cuda, "CUDA")
    torch.library.register_fake(f"millieye::{name}", fake, lib=_OPS_LIB)
    op = getattr(torch.ops.millieye, name).default
    op.plain, op.launch, op.wrapper = _plain, launch, wrapper
    return op


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name):
    src, extra = SOURCES[name]
    digest = hashlib.sha256((_CSRC / src).read_bytes())
    # the shared headers (tail.cuh) too: an edited one rebuilds them all
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None):
    """Compile every named library that is not built yet, one ``nvcc``
    process for each, all started together. Returns {name: ptxas log}
    for the libraries built by this call; raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        src, extra = SOURCES[n]
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(_CSRC / src)]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name):
    """The loaded ``ctypes`` library for ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.millieye_cuda_error_name.argtypes = [ctypes.c_int]
        lib.millieye_cuda_error_name.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib, rc, what):
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.millieye_cuda_error_name(rc).decode()})")


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
