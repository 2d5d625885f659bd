"""Box geometry primitives (port of `ops/boxes.py`).

Same operation order and eps placement as the JAX version, so a discrete
decision taken on these values (an IoU threshold in NMS, a SimOTA cost
ranking) comes out the same in both packages. Everything broadcasts over
leading dims, so the loss runs batched without per-image loops.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-7


def xywh_to_xyxy(xywh: torch.Tensor) -> torch.Tensor:
    """[..., 4] (cx, cy, w, h) -> (x1, y1, x2, y2)."""
    x, y, w, h = xywh.unbind(-1)
    return torch.stack([x - w * 0.5, y - h * 0.5, x + w * 0.5, y + h * 0.5], -1)


def xyxy_to_xywh(xyxy: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x1, y1, x2, y2) -> (cx, cy, w, h); w/h clamped >= 0."""
    x1, y1, x2, y2 = xyxy.unbind(-1)
    w = torch.clamp(x2 - x1, min=0.0)
    h = torch.clamp(y2 - y1, min=0.0)
    return torch.stack([x1 + 0.5 * w, y1 + 0.5 * h, w, h], -1)


def box_area(xyxy: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [...] area with sides clamped >= 0."""
    w = torch.clamp(xyxy[..., 2] - xyxy[..., 0], min=0.0)
    h = torch.clamp(xyxy[..., 3] - xyxy[..., 1], min=0.0)
    return w * h


def box_iou_matrix(box1: torch.Tensor, box2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """IoU between all pairs. box1 [..., N, 4] x box2 [..., M, 4] -> [..., N, M]."""
    return box_iou_pairwise(box1[..., :, None, :], box2[..., None, :, :], eps)


def box_iou_pairwise(box1: torch.Tensor, box2: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Elementwise IoU for matched (or broadcast) pairs: [..., 4] x [..., 4] -> [...]."""
    inter_w = torch.clamp(torch.minimum(box1[..., 2], box2[..., 2])
                          - torch.maximum(box1[..., 0], box2[..., 0]), min=0.0)
    inter_h = torch.clamp(torch.minimum(box1[..., 3], box2[..., 3])
                          - torch.maximum(box1[..., 1], box2[..., 1]), min=0.0)
    inter = inter_w * inter_h
    union = box_area(box1) + box_area(box2) - inter + eps
    return inter / union


def bbox_ciou(pred_xyxy: torch.Tensor, target_xyxy: torch.Tensor,
              eps: float = EPS) -> torch.Tensor:
    """Complete IoU for matched pairs [..., 4] -> [...]: width/height clamped
    to >= eps, the trade-off weight alpha detached (JAX's stop_gradient)."""
    px1, py1, px2, py2 = pred_xyxy.unbind(-1)
    tx1, ty1, tx2, ty2 = target_xyxy.unbind(-1)

    pw = torch.clamp(px2 - px1, min=eps)
    ph = torch.clamp(py2 - py1, min=eps)
    tw = torch.clamp(tx2 - tx1, min=eps)
    th = torch.clamp(ty2 - ty1, min=eps)

    inter_w = torch.clamp(torch.minimum(px2, tx2) - torch.maximum(px1, tx1), min=0.0)
    inter_h = torch.clamp(torch.minimum(py2, ty2) - torch.maximum(py1, ty1), min=0.0)
    inter = inter_w * inter_h
    union = pw * ph + tw * th - inter + eps
    iou = inter / union

    pcx = (px1 + px2) * 0.5
    pcy = (py1 + py2) * 0.5
    tcx = (tx1 + tx2) * 0.5
    tcy = (ty1 + ty2) * 0.5
    center_dist = (pcx - tcx) ** 2 + (pcy - tcy) ** 2

    cw = torch.maximum(px2, tx2) - torch.minimum(px1, tx1)
    ch = torch.maximum(py2, ty2) - torch.minimum(py1, ty1)
    c2 = cw ** 2 + ch ** 2 + eps

    v = (4.0 / (math.pi ** 2)) * (torch.atan(tw / th) - torch.atan(pw / ph)) ** 2
    alpha = (v / (v - iou + 1.0 + eps)).detach()
    return iou - (center_dist / c2) - alpha * v
