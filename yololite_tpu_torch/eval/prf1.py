"""P/R/F1 confidence sweep, vectorized (port of `eval/prf1.py`, the same numpy code).

Output parity with reference `build_curves_from_coco`
(scripts/data/p_r_f1.py:6-162): greedy per-(image,class) best-IoU matching of
score-ranked detections at IoU@0.5, a ranked PR curve, and a 201-step
confidence sweep returning best_f1/best_conf/fixed-conf stats + full curves.

The reference re-runs the greedy matching for every one of the 201 thresholds
(O(steps * dets) pure Python). Because the greedy match of a score-ranked
prefix never depends on later (lower-scored) detections, the sweep equals a
prefix-sum over the single ranked pass — one sort + cumsum, identical outputs.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict

import numpy as np

from yololite_tpu_torch.eval.coco import iou_xywh_matrix


def build_curves_from_coco(coco_images, coco_anns, coco_dets, out_dir=None,
                           iou: float = 0.50, steps: int = 201) -> Dict:
    gt_index: Dict = defaultdict(list)
    for a in coco_anns:
        gt_index[(int(a["image_id"]), int(a["category_id"]))].append(a["bbox"])
    total_gt = sum(len(v) for v in gt_index.values())

    dets_sorted = sorted(coco_dets, key=lambda x: float(x.get("score", 0.0)),
                         reverse=True)
    if len(dets_sorted) == 0:
        summary = {"iou": float(iou), "best_f1": 0.0, "best_conf": 0.0,
                   "precision_at_best": 0.0, "recall_at_best": 0.0}
        if out_dir:
            _save_artifacts(summary, out_dir)
        return summary

    # single ranked greedy pass (best unmatched IoU per det, per (img, cls))
    matched = {k: np.zeros(len(v), bool) for k, v in gt_index.items()}
    scores = np.asarray([float(d.get("score", 0.0)) for d in dets_sorted])
    tps = np.zeros(len(dets_sorted))
    for i, d in enumerate(dets_sorted):
        key = (int(d["image_id"]), int(d["category_id"]))
        gts = gt_index.get(key)
        if not gts:
            continue
        flags = matched[key]
        ious = iou_xywh_matrix(np.asarray([d["bbox"]], np.float64),
                               np.asarray(gts, np.float64))[0]
        ious = np.where(flags, -1.0, ious)
        j = int(np.argmax(ious))
        if ious[j] >= iou:
            flags[j] = True
            tps[i] = 1.0

    cum_tp = np.cumsum(tps)
    cum_fp = np.cumsum(1.0 - tps)
    recalls_rank = cum_tp / max(1, total_gt)
    precisions_rank = cum_tp / np.maximum(1, cum_tp + cum_fp)

    confs = np.linspace(0.0, 1.0, steps)
    # number of dets with score >= thr == prefix length (scores descending)
    counts = np.searchsorted(-scores, -confs, side="right")
    TP = np.where(counts > 0, cum_tp[np.maximum(counts - 1, 0)], 0.0)
    ALL = counts.astype(np.float64)
    FP = ALL - TP
    FN = total_gt - TP
    P_curve = np.where(ALL > 0, TP / np.maximum(ALL, 1e-12), 0.0)
    R_curve = np.where((TP + FN) > 0, TP / np.maximum(TP + FN, 1e-12), 0.0)
    F1_curve = np.where((P_curve + R_curve) > 0,
                        2 * P_curve * R_curve / np.maximum(P_curve + R_curve, 1e-12), 0.0)

    best_idx = int(np.argmax(F1_curve))
    fixed_conf = 0.50
    idx = int(np.argmin(np.abs(confs - fixed_conf)))
    summary = {
        "iou": float(iou),
        "best_f1": float(F1_curve[best_idx]),
        "best_conf": float(confs[best_idx]),
        "precision_at_best": float(P_curve[best_idx]),
        "recall_at_best": float(R_curve[best_idx]),
        "fixed_conf": fixed_conf,
        "precision_at_fixed_conf": float(P_curve[idx]),
        "recall_at_fixed_conf": float(R_curve[idx]),
        "f1_at_fixed_conf": float(F1_curve[idx]),
        "P_curve": P_curve, "R_curve": R_curve, "F1_curve": F1_curve,
        "confs": confs, "best_idx": best_idx,
        "precisions_rank": precisions_rank, "recalls_rank": recalls_rank,
    }
    if out_dir:
        _save_artifacts(summary, out_dir)
    return summary


def _save_artifacts(summary: Dict, out_dir: str):
    """CSV + PNG artifacts (reference saves pr_curve / p_r_f1 plots + csv)."""
    os.makedirs(out_dir, exist_ok=True)
    if "confs" not in summary:
        return
    with open(os.path.join(out_dir, "p_r_f1_curves.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["conf", "precision", "recall", "f1"])
        for c, p, r, f1 in zip(summary["confs"], summary["P_curve"],
                               summary["R_curve"], summary["F1_curve"]):
            w.writerow([f"{c:.4f}", f"{p:.6f}", f"{r:.6f}", f"{f1:.6f}"])
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for name, curve in [("precision", summary["P_curve"]),
                            ("recall", summary["R_curve"]),
                            ("f1", summary["F1_curve"])]:
            plt.figure()
            plt.plot(summary["confs"], curve, linewidth=2, label=name)
            plt.axvline(summary["best_conf"], linestyle="--", alpha=0.6,
                        label=f"best @ {summary['best_conf']:.3f}")
            plt.xlabel("Confidence")
            plt.ylabel(name)
            plt.xlim(0, 1)
            plt.ylim(0, 1)
            plt.grid(True, linestyle=":")
            plt.legend()
            plt.tight_layout()
            plt.savefig(os.path.join(out_dir, f"{name}_vs_conf.png"))
            plt.close()
        plt.figure()
        plt.plot(summary["recalls_rank"], summary["precisions_rank"], linewidth=2)
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.title(f"PR curve @ IoU {summary['iou']:.2f}")
        plt.xlim(0, 1)
        plt.ylim(0, 1)
        plt.grid(True, linestyle=":")
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, "pr_curve.png"))
        plt.close()
    except Exception:
        pass
