"""The port's kernels as ``torch.library`` custom ops: importing this
module registers ``millieye::<name>`` for every name in
``cuda_lib.KERNELS`` (each op is defined beside its wrapper, with
``cuda_lib.kernel_op``; ``OPS`` maps each name to its op, which
keeps its plain version, its launch and the wrapper that counts its
launches as ``.plain``, ``.launch`` and ``.wrapper``).
A process that replays an exported program
(``io/export.py:load_serving``) needs this module and torch, nothing
else of the port's."""
from __future__ import annotations

import torch

from millieye_torch.ops import (conv, epilogue, nms_kernel, quantize,
                                roi_kernel, stem)

OPS = {"nms": nms_kernel._blocked_op, "nms_full": nms_kernel._full_op,
       "ps_roi_align": roi_kernel._k2_op,
       "ps_roi_align_vpu": roi_kernel._k2_vpu_op,
       "roi_align": roi_kernel._k3_op, "ps_roi_align_f32": roi_kernel._k6_op,
       "ps_roi_align_padded_f32": roi_kernel._k7_op,
       "stem_stage": stem._stage_op, "fused_stem": stem._nhwc_op,
       **stem._pair_ops, "quantize_stochastic": quantize._stochastic_op,
       "conv_epilogue": epilogue._op, "conv2d_nhwc": conv._op}


def op(name):
    """The registered op ``millieye::<name>``, as the dispatcher holds
    it."""
    if name not in OPS:
        raise ValueError(f"unknown kernel {name!r}")
    return getattr(torch.ops.millieye, name).default
