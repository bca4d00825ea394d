"""The CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip. This file imports
no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_kernels_gpu.py

Every kernel is bit-equal to its plain version: each plain version
repeats its kernel's operations in the kernel's order (products of bf16
operands are exact in float32, so the kernels' FMAs round like the plain
versions' adds).
"""
import numpy as np
import pytest
import torch

from millieye_torch.device import set_numerics
from millieye_torch.ops.nms_kernel import (nms_keep_mask_blocked,
                                           nms_keep_mask_blocked_plain)
from millieye_torch.ops.roi_align import _batched_prep
from millieye_torch.ops.roi_kernel import (ps_roi_align_padded_kernel,
                                           ps_roi_align_padded_plain,
                                           roi_align_kernel, roi_align_plain)
from millieye_torch.ops.stem import fused_stem_pair, fused_stem_pair_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_numerics()
    return torch.device("cuda")


@pytest.mark.parametrize("b,k", [(1, 128), (4, 256), (2, 1024)])
def test_nms_kernel_bit_equal(cuda, b, k):
    rng = np.random.default_rng(k)
    c = rng.uniform(0, 100, (b, k, 2))
    wh = rng.uniform(5, 60, (b, k, 2))
    boxes = torch.tensor(np.concatenate([c - wh / 2, c + wh / 2], -1),
                         dtype=torch.float32, device=cuda)
    boxes[:, 5] = boxes[:, 4]                    # an exact duplicate
    valid = torch.tensor(rng.random((b, k)) < 0.9, device=cuda)
    for t in (0.5, 0.3):
        before = nms_keep_mask_blocked.launches
        got = nms_keep_mask_blocked(boxes, valid, t)
        assert nms_keep_mask_blocked.launches == before + 1
        assert torch.equal(got, nms_keep_mask_blocked_plain(boxes, valid, t))


def _roi_inputs(cuda, rng, b, n, hw, c_feat, ps):
    feats = torch.tensor(rng.standard_normal((b, hw, hw, c_feat)),
                         dtype=torch.bfloat16, device=cuda)
    xy = rng.uniform(-20, 13 * hw, (b, n, 2))
    boxes = torch.tensor(np.concatenate(
        [xy, xy + rng.uniform(2, 10 * hw, (b, n, 2))], -1),
        dtype=torch.float32, device=cuda)
    by, bx = _batched_prep(boxes, hw, hw, (7, 7), 1 / 16,
                           -0.5 if ps else 0.0, 0.1 if ps else 1.0, -1, 4)
    return feats, by.to(torch.bfloat16), bx.to(torch.bfloat16)


@pytest.mark.parametrize("b,n,hw", [(1, 96, 26), (3, 20, 13)])
def test_roi_kernels_match_plain(cuda, b, n, hw):
    rng = np.random.default_rng(n)
    f, by, bx = _roi_inputs(cuda, rng, b, n, hw, 7 * 128, True)
    assert torch.equal(ps_roi_align_padded_kernel(f, by, bx, 10),
                       ps_roi_align_padded_plain(f, by, bx, 10))
    f, by, bx = _roi_inputs(cuda, rng, b, n, hw, 10, False)
    assert torch.equal(roi_align_kernel(f, by, bx),
                       roi_align_plain(f, by, bx))


@pytest.mark.parametrize("shape", [(1, 416, 416, 3, 16, 32),
                                   (2, 96, 96, 3, 16, 32),
                                   (1, 32, 48, 3, 8, 16)])
def test_stem_kernel_matches_plain(cuda, shape):
    n, h, w, cin, cmid, cout = shape
    g = torch.Generator(device="cpu").manual_seed(h)
    x = torch.rand((n, h, w, cin), generator=g).to(cuda)
    w0 = (0.3 * torch.randn((cmid, cin, 3, 3), generator=g)).to(cuda)
    b0 = (0.1 * torch.randn(cmid, generator=g)).to(cuda)
    w1 = (0.3 * torch.randn((cout, cmid, 3, 3), generator=g)).to(cuda)
    b1 = (0.1 * torch.randn(cout, generator=g)).to(cuda)
    assert torch.equal(fused_stem_pair(x, w0, b0, w1, b1),
                       fused_stem_pair_plain(x, w0, b0, w1, b1))


def test_wrappers_refuse_wrong_inputs(cuda):
    with pytest.raises(TypeError):
        nms_keep_mask_blocked(torch.zeros((1, 128, 4), dtype=torch.float16,
                                          device=cuda),
                              torch.ones((1, 128), dtype=torch.bool,
                                         device=cuda), 0.5)
    with pytest.raises(ValueError):
        nms_keep_mask_blocked(torch.zeros((1, 96, 4), device=cuda),
                              torch.ones((1, 96), dtype=torch.bool,
                                         device=cuda), 0.5)
    with pytest.raises(TypeError):
        fused_stem_pair(torch.zeros((1, 32, 32, 3), dtype=torch.float16,
                                    device=cuda),
                        *(torch.zeros(s, device=cuda) for s in
                          ((8, 3, 3, 3), (8,), (8, 8, 3, 3), (8,))))
