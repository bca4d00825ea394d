"""The least time a launch of one of the port's kernels could take on an
H100: the larger of the bytes it must move over the HBM bandwidth and
the operations it must do over the peak of its arithmetic, from the
shapes the profiler records for the launch's ``millieye::<name>`` op.
The arithmetic of ``chip_smoke.py`` (``bound_ms`` and its cases' bytes
and operations), with the peaks of NVIDIA's H100 SXM data sheet (dense,
without sparsity, at the 700 W limit).

Shapes alone cannot see what depends on the data (an NMS's live rows, a
crop's nonzero support), and the profiler does not record a string
argument (the precision): so a bound here counts only what every launch
of those shapes must do, its operations at the bf16 tensor-core rate, a
float tensor whose type is not recorded at 2 bytes an element. Each
choice makes the bound smaller, never larger, so a share of it stays a
lower bound of the true roofline share. An op without a rule of its own
counts its inputs' bytes, read once."""
from __future__ import annotations

HBM_BYTES_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_S = 989e12           # dense bf16 tensor cores
F32_FLOP_S = 67e12             # float32 outside the tensor cores

# the peak a configuration's ``step.mfu`` divides by, by its precision
PEAKS = {"bfloat16": BF16_FLOP_S, "float16": BF16_FLOP_S,
         "float32": F32_FLOP_S}

# bytes an element, by the dtype names the profiler records
_ITEM = {"float": 4, "c10::Half": 2, "c10::BFloat16": 2, "double": 8,
         "long int": 8, "int": 4, "bool": 1, "signed char": 1,
         "unsigned char": 1, "c10::Float8_e4m3fn": 1}
# ScalarType codes an op's ``ScalarType`` argument is recorded as
_SCALAR = {5: 2, 6: 4, 15: 2, 7: 8}


def bound_s(nbytes, flops, flop_rate):
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _item(dtypes, i, default=2):
    if dtypes is None or i >= len(dtypes):
        return default
    return _ITEM.get(dtypes[i], default)


def _scalar_bytes(concrete, i, default=2):
    if concrete is None or i >= len(concrete):
        return default
    return _SCALAR.get(concrete[i], default)


def _stem_pair(shapes, dtypes, concrete):
    """K4 and its kin: x [N, H, W, Cin], w0 [C1, Cin, 3, 3], b0,
    w1 [C2, C1, 3, 3], b1 -> [N, H/4, W/4, C2] in the out dtype."""
    n, h, w, cin = shapes[0]
    c1, c2 = shapes[1][0], shapes[3][0]
    out = n * (h // 4) * (w // 4) * c2 * _scalar_bytes(concrete, 6)
    nbytes = (_numel(shapes[0]) * _item(dtypes, 0)
              + (_numel(shapes[1]) + _numel(shapes[3])) * 2 + out)
    flops = 2 * n * (h * w * c1 * 9 * cin + (h // 2) * (w // 2) * c2 * 9 * c1)
    return bound_s(nbytes, flops, BF16_FLOP_S)


def _stem_stage(shapes, dtypes, concrete):
    """K9: x [N, H, W, Cin], w [Cout, Cin, 3, 3] and b float32 ->
    [N, H/2, W/2, Cout] in the out dtype."""
    n, h, w, cin = shapes[0]
    cout = shapes[1][0]
    out = n * (h // 2) * (w // 2) * cout * _scalar_bytes(concrete, 4)
    nbytes = (_numel(shapes[0]) * _item(dtypes, 0)
              + (_numel(shapes[1]) + cout) * 4 + out)
    return bound_s(nbytes, 2 * n * h * w * cout * 9 * cin, BF16_FLOP_S)


def _nms(shapes, dtypes, concrete):
    """K1/K5: boxes [B, K, 4] float32, valid [B, K] -> keep [B, K]; the
    boxes of every row read once (the live rows are not seen)."""
    b, k = shapes[0][0], shapes[0][1]
    return bound_s(2 * b * k + 16 * b * k, 0, F32_FLOP_S)


def _ps_roi_align(shapes, dtypes, concrete):
    """K2: features [B, H, W, P*128] of which c_out*Q lanes of each 128
    are read, by [B, N, P, H], bx [B, N, Q, W] -> [B, N, P, Q, c_out]
    float32."""
    b, h, w, _ = shapes[0]
    _, n, p, _ = shapes[1]
    q = shapes[2][2]
    c_out = concrete[3] if concrete and len(concrete) > 3 and \
        isinstance(concrete[3], int) else 1
    used = b * h * w * p * c_out * q
    nbytes = ((used + _numel(shapes[1]) + _numel(shapes[2]))
              * _item(dtypes, 0) + b * n * p * q * c_out * 4)
    return bound_s(nbytes, 0, BF16_FLOP_S)


def _roi_align(shapes, dtypes, concrete):
    """K3: features [B, H, W, C], by, bx -> [B, N, P, Q, C] float32."""
    b, _, _, c = shapes[0]
    _, n, p, _ = shapes[1]
    q = shapes[2][2]
    nbytes = ((_numel(shapes[0]) + _numel(shapes[1]) + _numel(shapes[2]))
              * _item(dtypes, 0) + b * n * p * q * c * 4)
    return bound_s(nbytes, 0, BF16_FLOP_S)


def _inputs_read(shapes, dtypes, concrete):
    nbytes = sum(_numel(s) * _item(dtypes, i)
                 for i, s in enumerate(shapes) if s)
    return bound_s(nbytes, 0, BF16_FLOP_S)


RULES = {"stem_pair": _stem_pair, "stem_pair_select": _stem_pair,
         "stem_pair_packed": _stem_pair, "stem_pair_s2d": _stem_pair,
         "stem_stage": _stem_stage, "nms": _nms, "nms_full": _nms,
         "ps_roi_align": _ps_roi_align, "ps_roi_align_vpu": _ps_roi_align,
         "roi_align": _roi_align}


def launch_bound_s(op_name, shapes, dtypes=None, concrete=None):
    """The bound in seconds of one launch of ``millieye::<op_name>``
    with inputs of ``shapes`` (the profiler's ``input_shapes``),
    ``dtypes`` (its ``input_dtypes``, or None) and ``concrete`` (its
    ``concrete_inputs``, or None)."""
    rule = RULES.get(op_name, _inputs_read)
    return rule(shapes, dtypes, concrete)[0]
