"""COCO-protocol bbox and segm evaluator in numpy (port of `eval/coco.py`,
no pycocotools).

Returns {AP, AP50, AP75, APS, APM, APL, AR, ARS, ARM, ARL} with the official
semantics: IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1, area
ranges all/small/medium/large, maxDets 100, greedy per-(image, category)
matching with ignored-GT handling, 101-point interpolated precision averaged
over the categories present in GT. The matcher is the host C++ one
(`native.coco_match`, as JAX's `eval/coco.py` runs its native twin);
`native.coco_match_plain` is the same loop in Python. Inputs are the
reference's COCO list-of-dicts; an empty detection list gives zeros.
`iou_type="segm"` matches by mask IoU (float64) on full-resolution RLE
"segmentation" entries (or dense "mask" arrays) and bins GT areas by mask
area, as the JAX evaluator does.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from yololite_tpu_torch import native
from yololite_tpu_torch.ops.masks import rle_decode_np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100


def iou_xywh_matrix(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU between [D,4] and [G,4] xywh boxes."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :])
    ih = np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :])
    iw = np.maximum(iw, 0.0)
    ih = np.maximum(ih, 0.0)
    inter = iw * ih
    area_d = np.maximum(dt[:, 2] * dt[:, 3], 0.0)
    area_g = np.maximum(gt[:, 2] * gt[:, 3], 0.0)
    union = area_d[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _dense_masks(items) -> np.ndarray:
    """COCO ann/det dicts -> stacked binary masks [N, H, W], from an RLE
    under "segmentation" or a dense array under "mask"; one (image, class)
    group shares one resolution."""
    if not items:
        return np.zeros((0, 1, 1), bool)
    out = []
    for it in items:
        if "segmentation" in it:
            out.append(rle_decode_np(it["segmentation"]).astype(bool))
        else:
            out.append(np.asarray(it["mask"], bool))
    return np.stack(out)


def mask_iou_matrix(dt_masks: np.ndarray, gt_masks: np.ndarray) -> np.ndarray:
    """IoU between binary masks: [D,h,w] x [G,h,w] -> [D,G] (float64)."""
    if len(dt_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(dt_masks), len(gt_masks)), np.float64)
    d = dt_masks.reshape(len(dt_masks), -1).astype(np.float64)
    g = gt_masks.reshape(len(gt_masks), -1).astype(np.float64)
    inter = d @ g.T
    union = d.sum(1)[:, None] + g.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_img(dt_boxes, dt_scores, gt_boxes, gt_areas, area_rng, max_dets,
                  iou_matrix=None):
    """Match dets to GTs for one (image, category) over all IoU thresholds.
    `iou_matrix` [D,G] (unsorted det x gt order) replaces the box IoU (segm).
    Returns (dt_matches [T,D] (1=TP), dt_ignore [T,D], scores [D], npig)."""
    arng_lo, arng_hi = area_rng
    gt_ignore = (gt_areas < arng_lo) | (gt_areas > arng_hi)
    # sort GT: non-ignored first (COCOeval semantics)
    gorder = np.argsort(gt_ignore, kind="stable")
    gt_boxes = gt_boxes[gorder]
    gt_ignore = gt_ignore[gorder]

    dorder = np.argsort(-dt_scores, kind="stable")[:max_dets]
    dt_boxes = dt_boxes[dorder]
    dt_scores = dt_scores[dorder]

    if iou_matrix is not None:
        ious = np.asarray(iou_matrix, np.float64)[dorder][:, gorder]
    else:
        ious = iou_xywh_matrix(dt_boxes, gt_boxes)

    dtm, dt_ig = native.coco_match(ious, gt_ignore, IOU_THRS)
    # unmatched dets outside the area range are ignored
    d_areas = np.maximum(dt_boxes[:, 2] * dt_boxes[:, 3], 0.0)
    out_rng = (d_areas < arng_lo) | (d_areas > arng_hi)
    dt_ig = dt_ig | ((dtm == 0) & out_rng[None, :])
    npig = int(np.sum(~gt_ignore))
    return (dtm > 0) & ~dt_ig, dt_ig, dt_scores, npig


class COCOEvaluator:
    """Accumulates GT/DT lists and computes COCO stats."""

    @staticmethod
    def _area_scale(coco_images, img: int, mask_shape) -> float:
        """Mask pixels -> image pixels for segm area ranges (1 for
        full-resolution masks)."""
        for im in coco_images:
            if int(im["id"]) == img:
                w, h = im.get("width"), im.get("height")
                if w and mask_shape[1] > 0:
                    return (float(w) / mask_shape[2]) * (float(h) / mask_shape[1])
                break
        return 1.0

    def __init__(self, num_classes: Optional[int] = None,
                 iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type {iou_type!r}")
        self.num_classes = num_classes
        self.iou_type = iou_type

    def evaluate(self, coco_images: List[dict], coco_anns: List[dict],
                 coco_dets: List[dict]) -> Dict[str, float]:
        zeros = {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "APS": 0.0, "APM": 0.0,
                 "APL": 0.0, "AR": 0.0, "ARS": 0.0, "ARM": 0.0, "ARL": 0.0}
        if not coco_dets or not coco_anns:
            return zeros

        cats = sorted({int(a["category_id"]) for a in coco_anns})
        img_ids = sorted({int(im["id"]) for im in coco_images}) if coco_images \
            else sorted({int(a["image_id"]) for a in coco_anns} |
                        {int(d["image_id"]) for d in coco_dets})

        gt_by = defaultdict(list)
        for a in coco_anns:
            gt_by[(int(a["image_id"]), int(a["category_id"]))].append(a)
        dt_by = defaultdict(list)
        for d in coco_dets:
            dt_by[(int(d["image_id"]), int(d["category_id"]))].append(d)

        T, R = len(IOU_THRS), len(REC_THRS)
        K, A = len(cats), len(AREA_RNG)
        precision = -np.ones((T, R, K, A))
        recall = -np.ones((T, K, A))

        area_items = list(AREA_RNG.items())
        for ki, cat in enumerate(cats):
            # gather per-image match results once per area range
            for ai, (aname, arng) in enumerate(area_items):
                all_scores, all_tp, all_ig = [], [], []
                npig_total = 0
                for img in img_ids:
                    gts = gt_by.get((img, cat), [])
                    dts = dt_by.get((img, cat), [])
                    if not gts and not dts:
                        continue
                    gt_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
                    gt_areas = np.asarray([g.get("area", g["bbox"][2] * g["bbox"][3])
                                           for g in gts], np.float64)
                    dt_boxes = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
                    dt_scores = np.asarray([d["score"] for d in dts], np.float64)
                    iou_m = None
                    if self.iou_type == "segm":
                        gm, dm = _dense_masks(gts), _dense_masks(dts)
                        iou_m = mask_iou_matrix(dm, gm)
                        if len(gts):
                            gt_areas = gm.reshape(len(gm), -1).sum(1) * \
                                self._area_scale(coco_images, img, gm.shape)
                    tp, ig, scores, npig = _evaluate_img(dt_boxes, dt_scores,
                                                         gt_boxes, gt_areas,
                                                         arng, MAX_DETS, iou_m)
                    all_scores.append(scores)
                    all_tp.append(tp)
                    all_ig.append(ig)
                    npig_total += npig
                if npig_total == 0:
                    continue
                if all_scores:
                    scores = np.concatenate(all_scores)
                    order = np.argsort(-scores, kind="mergesort")
                    tp = np.concatenate(all_tp, axis=1)[:, order]
                    ig = np.concatenate(all_ig, axis=1)[:, order]
                else:
                    tp = np.zeros((T, 0), bool)
                    ig = np.zeros((T, 0), bool)
                fp = (~tp) & (~ig)
                tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
                fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
                for ti in range(T):
                    tps, fps = tp_cum[ti], fp_cum[ti]
                    nd = len(tps)
                    rc = tps / npig_total
                    pr = tps / np.maximum(tps + fps, np.spacing(1))
                    recall[ti, ki, ai] = rc[-1] if nd else 0.0
                    # make precision monotonically decreasing (backwards max)
                    q = np.zeros(R)
                    if nd:
                        pr = pr.copy()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        valid = inds < nd
                        q[valid] = pr[inds[valid]]
                    precision[ti, :, ki, ai] = q

        def _ap(t_slice=slice(None), area="all"):
            ai = list(AREA_RNG.keys()).index(area)
            p = precision[t_slice, :, :, ai]
            p = p[p > -1]
            # pycocotools summarize() returns -1 when no GT falls in the range
            return float(np.mean(p)) if p.size else -1.0

        def _ar(area="all"):
            ai = list(AREA_RNG.keys()).index(area)
            r = recall[:, :, ai]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        i50 = int(np.argmin(np.abs(IOU_THRS - 0.5)))
        i75 = int(np.argmin(np.abs(IOU_THRS - 0.75)))
        return {
            "AP": _ap(), "AP50": _ap(slice(i50, i50 + 1)), "AP75": _ap(slice(i75, i75 + 1)),
            "APS": _ap(area="small"), "APM": _ap(area="medium"), "APL": _ap(area="large"),
            "AR": _ar(), "ARS": _ar("small"), "ARM": _ar("medium"), "ARL": _ar("large"),
        }


def coco_eval_from_lists(coco_images, coco_anns, coco_dets, iouType="bbox",
                         num_classes=None) -> Dict[str, float]:
    """The reference's `_coco_eval_from_lists` (bbox), by the evaluator above
    (never pycocotools)."""
    return COCOEvaluator(num_classes, iouType).evaluate(coco_images, coco_anns, coco_dets)
