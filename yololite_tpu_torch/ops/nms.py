"""Class-aware NMS with static shapes (port of `ops/nms.py`).

  1. conf mask, then top-k pre-selection of candidates by score,
  2. class-aware suppression via the coordinate-offset trick (boxes of
     different classes are translated apart by `coord_bound` so they never
     overlap),
  3. exact greedy suppression under IoU or DIoU: on CUDA tensors the
     hand-written kernel (`ops/cuda_nms.py`), on CPU tensors the plain
     fixpoint `_greedy_keep` over `_suppression_matrix`,
  4. top `max_det` outputs, padded (score 0, class -1).

Suppression is always exact greedy, equal to JAX `fixpoint_unroll=0`. The JAX
Predictor's `unroll=8` approximates that on suppression chains deeper than 8.

Top-k is a stable descending sort and a slice: `lax.top_k` puts the lower
index first among equal values, and every candidate under `conf_th` scores
exactly 0, so ties fill the padding; a stable sort reproduces its order and
`torch.topk`'s unspecified tie order would not.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from yololite_tpu_torch import native
from yololite_tpu_torch.ops import cuda_nms
from yololite_tpu_torch.ops.boxes import box_iou_matrix


def _suppression_matrix(boxes: torch.Tensor, use_diou: bool) -> torch.Tensor:
    """[..., k, 4] -> [..., k, k] pairwise overlap metric (IoU or DIoU)."""
    iou = box_iou_matrix(boxes, boxes)
    if not use_diou:
        return iou
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    center_dist = ((cx[..., :, None] - cx[..., None, :]) ** 2
                   + (cy[..., :, None] - cy[..., None, :]) ** 2)
    w = (torch.maximum(x2[..., :, None], x2[..., None, :])
         - torch.minimum(x1[..., :, None], x1[..., None, :]))
    h = (torch.maximum(y2[..., :, None], y2[..., None, :])
         - torch.minimum(y1[..., :, None], y1[..., None, :]))
    c2 = w ** 2 + h ** 2 + 1e-7
    return iou - center_dist / c2


def _greedy_keep(overlap: torch.Tensor, valid: torch.Tensor, iou_th: float,
                 unroll: int = 0) -> torch.Tensor:
    """Greedy-NMS keep mask by fixpoint iteration, batched over leading dims.

    `overlap` is [..., k, k] for score-descending boxes, `valid` [..., k].
    keep(i) = valid(i) and no j < i with keep(j) and overlap(j,i) > thr.
    unroll=0 iterates to convergence (exact); unroll=N takes N steps, as the
    JAX deploy graph does, and is inexact on chains deeper than N.
    """
    k = overlap.shape[-1]
    upper = torch.ones(k, k, dtype=torch.bool, device=overlap.device).triu(1)
    sup = (overlap > iou_th) & upper

    def step(keep):
        return valid & ~(sup & keep[..., :, None]).any(dim=-2)

    keep = valid
    if unroll > 0:
        for _ in range(unroll):
            keep = step(keep)
        return keep
    for _ in range(k):
        new = step(keep)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` along the last dim: descending, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_candidates(boxes, scores, classes, *, conf_th: float, k: int,
                      class_aware: bool, coord_bound: float = 8192.0):
    """Conf mask + top-k + gather. Returns (top_scores [B,k], idx [B,k] int32,
    boxes_k [B,k,4], cls_k [B,k], valid [B,k] bool, shifted [B,k,4])."""
    scores = torch.where(scores > conf_th, scores, torch.zeros_like(scores))
    top_scores, idx = _topk_stable(scores, k)
    boxes_k = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    cls_k = torch.gather(classes, 1, idx)
    valid = top_scores > 0.0
    if class_aware:
        shifted = boxes_k + (cls_k.to(boxes_k.dtype) * coord_bound)[..., None]
    else:
        shifted = boxes_k
    return top_scores, idx.to(torch.int32), boxes_k, cls_k, valid, shifted


def finalize_detections(keep, top_scores, idx, boxes_k, cls_k, *, max_det: int):
    """Top `max_det` of the kept candidates, padded to max_det."""
    k = top_scores.shape[-1]
    out_scores = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    m = min(max_det, k)
    final_scores, sel = _topk_stable(out_scores, m)
    final_boxes = torch.gather(boxes_k, 1, sel[..., None].expand(-1, -1, 4))
    final_cls = torch.gather(cls_k, 1, sel)
    final_idx = torch.gather(idx, 1, sel)
    final_valid = final_scores > 0.0
    final_cls = torch.where(final_valid, final_cls, torch.full_like(final_cls, -1))
    if m < max_det:
        pad = max_det - m
        final_boxes = torch.nn.functional.pad(final_boxes, (0, 0, 0, pad))
        final_scores = torch.nn.functional.pad(final_scores, (0, pad))
        final_cls = torch.nn.functional.pad(final_cls, (0, pad), value=-1)
        final_idx = torch.nn.functional.pad(final_idx, (0, pad))
        final_valid = torch.nn.functional.pad(final_valid, (0, pad))
    return final_boxes, final_scores, final_cls, final_valid, final_idx


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                *, iou_th: float = 0.65, conf_th: float = 0.001, max_det: int = 300,
                pre_nms_topk: int = 1024, class_aware: bool = True,
                use_diou: bool = False, coord_bound: float = 8192.0):
    """Batched class-aware NMS: boxes [B,N,4] f32, scores [B,N] f32, classes
    [B,N] int32 -> (boxes [B,max_det,4], scores [B,max_det], classes
    [B,max_det] int32 (-1 = padding), valid [B,max_det] bool, idx [B,max_det]
    int32 anchor index)."""
    k = min(pre_nms_topk, boxes.shape[1])
    top_scores, idx, boxes_k, cls_k, valid, shifted = select_candidates(
        boxes, scores, classes, conf_th=conf_th, k=k, class_aware=class_aware,
        coord_bound=coord_bound)
    keep = cuda_nms.greedy_keep(shifted.contiguous(), valid, iou_th, use_diou)
    return finalize_detections(keep, top_scores, idx, boxes_k, cls_k,
                               max_det=max_det)


def yolo_scores(obj_logits: torch.Tensor, cls_logits: torch.Tensor):
    """YOLO score = sigmoid(obj) * max(sigmoid(cls)); returns (scores, class
    idx int32; the first index among equal maxima)."""
    obj = torch.sigmoid(obj_logits)
    if cls_logits.shape[-1] == 0:
        return obj, torch.zeros(obj.shape, dtype=torch.int32, device=obj.device)
    cls_p = torch.sigmoid(cls_logits)
    return obj * cls_p.amax(dim=-1), cls_p.argmax(dim=-1).to(torch.int32)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_th: float) -> np.ndarray:
    """Greedy NMS on the host: kept indices by descending score (ties in
    index order), by the host C++ library (`native.nms`), as JAX's
    `nms_numpy` runs its native kernel."""
    return native.nms(boxes, scores, iou_th)
