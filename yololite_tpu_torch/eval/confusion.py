"""Confusion matrix + per-class error stats (port of `eval/confusion.py`, the
same numpy code).

Parity with reference `create_confusion_matrix`
(scripts/helpers/evaluate.py:59-238): detections at score >= conf are greedily
matched to GTs at IoU >= 0.5 per image (class-agnostic candidate pool, label
compared after match); unmatched dets land in the background row (FP), missed
GTs in the background column (FN). Saves a row-normalized heatmap PNG and a
`confusion_stats.txt` with TP/FP/FN/precision/recall per class.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import List, Sequence

import numpy as np

from yololite_tpu_torch.eval.coco import iou_xywh_matrix


def create_confusion_matrix(coco_anns: List[dict], coco_dets: List[dict],
                            num_classes: int, conf: float = 0.25,
                            iou_th: float = 0.5, class_names=None,
                            out_dir: str = None) -> np.ndarray:
    """Returns [C+1, C+1] matrix; last row/col = background (FP / FN)."""
    C = int(num_classes)
    mat = np.zeros((C + 1, C + 1), np.int64)

    gts_by_img = defaultdict(list)
    for a in coco_anns:
        gts_by_img[int(a["image_id"])].append(a)
    dets_by_img = defaultdict(list)
    for d in coco_dets:
        if float(d.get("score", 0.0)) >= conf:
            dets_by_img[int(d["image_id"])].append(d)

    for img_id in set(gts_by_img) | set(dets_by_img):
        gts = gts_by_img.get(img_id, [])
        dets = sorted(dets_by_img.get(img_id, []),
                      key=lambda d: -float(d.get("score", 0.0)))
        g_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        g_cls = np.asarray([int(g["category_id"]) - 1 for g in gts], np.int64)
        matched = np.zeros(len(gts), bool)
        for d in dets:
            d_cls = int(d["category_id"]) - 1
            if len(gts):
                ious = iou_xywh_matrix(np.asarray([d["bbox"]], np.float64), g_boxes)[0]
                ious = np.where(matched, -1.0, ious)
                j = int(np.argmax(ious)) if len(ious) else -1
                if j >= 0 and ious[j] >= iou_th:
                    matched[j] = True
                    mat[g_cls[j], d_cls] += 1
                    continue
            mat[C, d_cls] += 1  # background predicted as d_cls (FP)
        for j in range(len(gts)):
            if not matched[j]:
                mat[g_cls[j], C] += 1  # missed GT (FN)

    if out_dir:
        save_confusion_artifacts(mat, class_names or [str(i) for i in range(C)],
                                 out_dir, conf)
    return mat


def save_confusion_artifacts(mat: np.ndarray, class_names: Sequence[str],
                             out_dir: str, conf: float):
    os.makedirs(out_dir, exist_ok=True)
    C = mat.shape[0] - 1
    names = list(class_names) + ["background"]

    # stats txt (evaluate.py `_stats.txt` parity)
    lines = [f"Confusion stats @ conf={conf:.3f}", ""]
    for c in range(C):
        tp = int(mat[c, c])
        fp = int(mat[:, c].sum() - tp)
        fn = int(mat[c, :].sum() - tp)
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        lines.append(f"{names[c]}: TP={tp} FP={fp} FN={fn} "
                     f"precision={prec:.4f} recall={rec:.4f}")
    with open(os.path.join(out_dir, "confusion_stats.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        row_sum = mat.sum(axis=1, keepdims=True)
        norm = mat / np.maximum(row_sum, 1)
        fig, ax = plt.subplots(figsize=(max(6, C), max(5, C * 0.8)))
        im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
        ax.set_xticks(range(C + 1), names, rotation=45, ha="right")
        ax.set_yticks(range(C + 1), names)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Ground truth")
        for i in range(C + 1):
            for j in range(C + 1):
                if mat[i, j]:
                    ax.text(j, i, str(int(mat[i, j])), ha="center", va="center",
                            color="white" if norm[i, j] > 0.5 else "black",
                            fontsize=8)
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "confusion_matrix.png"))
        plt.close(fig)
    except Exception:
        pass
