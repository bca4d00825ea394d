"""The eval-mode tail of a convolution: kernel K14 and its plain version.

After an inference convolution ``Darknet.apply`` runs batch norm's affine
step with the running statistics (or the bias of a folded convolution),
then its activation (``ACTS``): nothing, LeakyReLU(0.1) or Mish.
``epilogue_eager`` is that sequence as eager PyTorch runs it, one
full-size pass an operation: ``(x - mean) * inv``, ``* gamma + beta``
(``inv = rsqrt(var + eps)``, computed by the caller on the ``[C]``
vector), or ``x + bias``; then ``leaky`` or ``mish``. ``conv_epilogue``
(K14, ``millieye_torch/csrc/epilogue.cu``)
computes the same bits in one pass over the convolution's output: it
replaces no TPU kernel (on the TPU, XLA fused this tail), and its bound
is the bytes it reads and writes once.

On a CPU tensor the op runs the plain version; on a CUDA tensor the
kernel, or it raises where the kernel cannot take the tensors
(``_kernel_form``), outside ``cuda_lib.plain_versions()``; it has no
backward. ``Darknet.apply`` chooses between the two (``models/
darknet.py:on_card``). The kernel writes the eager result's dtype: a
bfloat16 convolution with a float32 bias gives float32, computed from
the exact upcast. ``conv_epilogue.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from millieye_torch.ops import cuda_lib

# the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the activations a tail may end in (a darknet block's ``activation``);
# the op takes a name's index here as its code
ACTS = ("linear", "leaky", "mish")
_CODES = {name: code for code, name in enumerate(ACTS)}


def act_code(act):
    """The op's code of ``act``, a name of ``ACTS``."""
    try:
        return _CODES[act]
    except (KeyError, TypeError):
        raise ValueError(f"unknown activation {act!r} (have "
                         f"{', '.join(ACTS)})") from None


def leaky(x):
    """LeakyReLU(0.1) with the slope in x's dtype, as JAX's weakly typed
    ``0.1 * x`` rounds it (bf16(0.1) != float32(0.1))."""
    return torch.where(x > 0, x, x * torch.full((), 0.1, dtype=x.dtype,
                                                device=x.device))


def mish(x):
    """Mish, ``x * tanh(softplus(x))``, softplus with darknet's threshold
    20 (``F.softplus``'s: above it, x itself); three eager operations,
    each rounded to x's dtype."""
    return x * torch.tanh(F.softplus(x))


def activate(x, act):
    """The activation ``act``, a name of ``ACTS``, on x."""
    code = act_code(act)
    return x if code == 0 else leaky(x) if code == 1 else mish(x)


def epilogue_eager(x, bias, mean=None, inv=None, gamma=None, act="linear"):
    """The eager sequence on NCHW-indexed x: with ``mean`` (batch norm)
    ``(x - mean) * inv`` then ``* gamma + bias``, else ``x + bias``; then
    the activation ``act``, a name of ``ACTS``. The result has x's memory
    format and the dtypes' promotion."""
    if mean is not None:
        x = (x - mean[:, None, None]) * inv[:, None, None]
        x = x * gamma[:, None, None] + bias[:, None, None]
    else:
        x = x + bias[:, None, None]
    return activate(x, act)


def conv_epilogue(x, bias, mean=None, inv=None, gamma=None, act="linear"):
    """K14: ``epilogue_eager`` of a 4-D NCHW-indexed x in one pass, through
    the op (the plain version on the CPU); the output has x's memory
    format and the eager result's dtype."""
    return _op(x, bias, mean, inv, gamma, act_code(act))


def _out_dtype(x, vecs):
    out = x.dtype
    for v in vecs:
        if v.dtype != out:
            out = torch.promote_types(out, v.dtype)
    return out


def _kernel_form(x, bias, mean, inv, gamma):
    """What the kernel needs of its tensors: (the output dtype, the
    elements of one channel next to each other in memory: H * W in dense
    NCHW, 1 in channels_last, the vectors bias, mean, inv, gamma in the
    output dtype). Raises ValueError for tensors it cannot take."""
    bn = mean is not None
    if bn != (inv is not None) or bn != (gamma is not None):
        raise ValueError("conv_epilogue: batch norm takes mean, inv and "
                         "gamma together")
    vecs = (mean, inv, gamma, bias) if bn else (bias,)
    if x.dim() != 4 or x.dtype not in _DTYPES:
        inner = None
    elif x.is_contiguous(memory_format=torch.channels_last):
        inner = 1
    elif x.is_contiguous():
        inner = x.shape[2] * x.shape[3]
    else:
        inner = None
    if inner is None:
        raise ValueError(f"conv_epilogue: want a dense 4-D NCHW or "
                         f"channels_last float tensor, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    c, dev = x.shape[1], x.get_device()
    if any(v.dim() != 1 or v.shape[0] != c or v.get_device() != dev
           or v.dtype not in _DTYPES for v in vecs):
        got = [(tuple(v.shape), v.dtype, str(v.device)) for v in vecs]
        raise ValueError(f"conv_epilogue: want [{c}] float vectors on "
                         f"{x.device}, got {got}")
    out = _out_dtype(x, vecs)
    if out != x.dtype:
        # every operation rounds to one dtype: the first one's promotion
        # must already be the result's (the vectors upcast exactly)
        if torch.promote_types(x.dtype, vecs[0].dtype) != out:
            raise ValueError(f"conv_epilogue: {x.dtype} with vectors of "
                             f"{[v.dtype for v in vecs]} rounds in two "
                             f"dtypes")
    return out, inner, [v if v is None or v.dtype == out and v.stride(0) == 1
                        else v.to(out).contiguous()
                        for v in (bias, mean, inv, gamma)]


@functools.cache
def _lib():
    lib = cuda_lib.library("epilogue")
    lib.millieye_conv_epilogue.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p])
    lib.millieye_conv_epilogue.restype = ctypes.c_int
    return lib


@functools.cache
def _slope(dtype):
    """0.1 in ``dtype``, as ``leaky`` rounds it, as a Python float."""
    return torch.full((), 0.1, dtype=dtype).item()


def _launch(x, bias, mean, inv, gamma, act):
    # the layout is read here, at each call: a replayed exported program
    # may hand over another one than the trace saw
    out, inner, vecs = _kernel_form(x, bias, mean, inv, gamma)
    lib = _lib()
    y = torch.empty_like(x, dtype=out)
    # raw pointers and the current stream's handle as ints: the host's
    # time a call is most of this op's cost at small shapes
    rc = lib.millieye_conv_epilogue(
        x.data_ptr(), y.data_ptr(),
        *(None if v is None else v.data_ptr() for v in vecs),
        x.numel(), x.shape[1], inner, _DTYPES[x.dtype], _DTYPES[out],
        act, _slope(out),
        torch._C._cuda_getCurrentRawStream(x.get_device()))
    cuda_lib.check(lib, rc, "conv_epilogue")
    return y


def _plain(x, bias, mean, inv, gamma, code):
    if not 0 <= code < len(ACTS):
        raise ValueError(f"conv_epilogue: unknown activation code {code}")
    return epilogue_eager(x, bias, mean, inv, gamma, ACTS[code])


def _fake(x, bias, mean, inv, gamma, act):
    return torch.empty_like(x, dtype=_out_dtype(
        x, [v for v in (bias, mean, inv, gamma) if v is not None]))


conv_epilogue.launches = 0
_op = cuda_lib.kernel_op(
    "conv_epilogue", "(Tensor x, Tensor bias, Tensor? mean, Tensor? inv, "
    "Tensor? gamma, int act) -> Tensor", _plain, _launch,
    _fake, conv_epilogue, contiguous=False)
