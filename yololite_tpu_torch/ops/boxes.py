"""Box geometry primitives (port of `ops/boxes.py`).

Same operation order and eps placement as the JAX version, so a discrete
decision taken on these values (an IoU threshold in NMS) comes out the same in
both packages. `bbox_ciou` waits for the training slice.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def box_area(xyxy: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [...] area with sides clamped >= 0."""
    w = torch.clamp(xyxy[..., 2] - xyxy[..., 0], min=0.0)
    h = torch.clamp(xyxy[..., 3] - xyxy[..., 1], min=0.0)
    return w * h


def box_iou_matrix(box1: torch.Tensor, box2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """IoU between all pairs. box1 [..., N, 4] x box2 [..., M, 4] -> [..., N, M]."""
    b1 = box1[..., :, None, :]
    b2 = box2[..., None, :, :]
    inter_w = torch.clamp(torch.minimum(b1[..., 2], b2[..., 2])
                          - torch.maximum(b1[..., 0], b2[..., 0]), min=0.0)
    inter_h = torch.clamp(torch.minimum(b1[..., 3], b2[..., 3])
                          - torch.maximum(b1[..., 1], b2[..., 1]), min=0.0)
    inter = inter_w * inter_h
    area1 = box_area(b1)
    area2 = box_area(b2)
    union = area1 + area2 - inter + eps
    return inter / union
