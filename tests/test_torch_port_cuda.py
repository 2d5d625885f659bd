"""The CUDA suppression kernel against its plain PyTorch version, on the card.

Marked `cuda`; skips without a card. This file imports no JAX, so it runs on
the card's machine, which has none (tests/conftest.py imports JAX, hence
`--noconftest`):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from yololite_tpu_torch.ops import cuda_nms
from yololite_tpu_torch.ops.nms import batched_nms


def _boxes(rng, b, k):
    cx, cy = rng.rand(2, b, k) * 500
    w, h = rng.rand(2, b, k) * 85 + 5
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 33, 256, 512, 1024])
def test_kernel_matches_reference(card, k):
    rng = np.random.RandomState(k)
    boxes = torch.from_numpy(_boxes(rng, 16, k)).cuda()
    valid = torch.from_numpy(rng.rand(16, k) > 0.1).cuda()
    before = cuda_nms.LAUNCHES
    got = cuda_nms.greedy_keep(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert cuda_nms.LAUNCHES == before + 1
    assert torch.equal(got, cuda_nms.greedy_keep_reference(boxes, valid, 0.5))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    boxes = torch.zeros(2, 1025, 4, device="cuda")
    with pytest.raises(ValueError, match="outside"):
        cuda_nms.greedy_keep(boxes, torch.ones(2, 1025, dtype=torch.bool, device="cuda"), 0.5)
    with pytest.raises(ValueError, match="float32"):
        cuda_nms.greedy_keep(boxes[:, :8].half(), torch.ones(2, 8, dtype=torch.bool,
                                                              device="cuda"), 0.5)
    rng = np.random.RandomState(0)
    b = torch.from_numpy(_boxes(rng, 2, 64)).cuda()
    s = torch.rand(2, 64, device="cuda")
    c = torch.zeros(2, 64, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError):
        batched_nms(b, s, c, use_diou=True)
