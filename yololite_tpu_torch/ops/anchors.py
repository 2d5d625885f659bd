"""Anchor-point grids for the anchor-free heads (port of `ops/anchors.py`).

Per level of grid (H, W): anchor points are cell indices (gx, gy), row-major
over (y, x); stride = img_size / max(H, W); levels concatenate in head order.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch


@lru_cache(maxsize=64)
def _make_anchors_np(level_hw: Tuple[Tuple[int, int], ...], img_size: int):
    pts, strides = [], []
    for (h, w) in level_hw:
        stride = img_size / float(max(h, w))
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1).astype(np.float32))
        strides.append(np.full((h * w,), stride, dtype=np.float32))
    return np.concatenate(pts, 0), np.concatenate(strides, 0)


@lru_cache(maxsize=64)
def _make_anchors_on(level_hw, img_size: int, device: str):
    pts, strides = _make_anchors_np(level_hw, img_size)
    # normal tensors even when first asked for under inference_mode (serving),
    # so training's autograd may use the cached ones too
    with torch.inference_mode(False):
        return torch.from_numpy(pts).to(device), torch.from_numpy(strides).to(device)


def make_anchors(level_hw: Sequence[Tuple[int, int]], img_size: int, device):
    """Return (anchor_points [N,2] float32 (gx,gy), strides [N] float32) on
    `device`, which callers name (no default, so no grid lands on the CPU
    unasked).

    Cached per device, so the serving loop does no host-to-device copy (and no
    host wait) for them after the first call. Callers must not write to them."""
    return _make_anchors_on(tuple(tuple(s) for s in level_hw), int(img_size),
                            str(device))


def level_shapes_for(img_size: int, fpn_strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Grid (H, W) per FPN level for a square input of side ``img_size``."""
    return tuple((int(np.ceil(img_size / s)), int(np.ceil(img_size / s)))
                 for s in fpn_strides)
