"""Full-dataset evaluation (port of `eval/evaluate.py`).

Loop the val loader -> `Trainer.eval_step` on the device (decode + NMS, the
suppression in the `nms_suppress` kernel on the card) -> COCO stats -> P/R/F1
confidence sweep -> confusion matrix at best_conf -> forward latency on the
device (CUDA events) and on a CPU copy of the model -> summary PNG (skipped
without matplotlib) -> eval_results.json. For a segmentation model each
detection carries its mask upsampled to `img_size` (`cv2.resize` INTER_LINEAR
on floats, `data/imgops.resize_f32`), binarized at 0.5 and stored as RLE;
GT masks are the dataset's full-resolution RLEs (or the bit-packed
prototype-resolution masks), and `coco_segm` holds the mask-IoU stats.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from yololite_tpu_torch.data.imgops import resize_f32
from yololite_tpu_torch.eval.coco import COCOEvaluator, coco_eval_from_lists
from yololite_tpu_torch.eval.confusion import create_confusion_matrix
from yololite_tpu_torch.eval.prf1 import build_curves_from_coco
from yololite_tpu_torch.ops.masks import rle_area, rle_encode_np


def dets_to_coco(det_batch: Dict[str, np.ndarray], first_img_id: int,
                 nvalid: int, add_one: bool = True,
                 mask_size: Optional[int] = None) -> List[dict]:
    """Fixed-shape NMS outputs -> COCO det dicts (xywh, 1-based category).

    With "masks" (prototype-resolution probabilities) each det carries its
    mask: upsampled to `mask_size` and stored as RLE under "segmentation",
    or, with no `mask_size`, the binary proto-res mask under "mask"."""
    out = []
    boxes = np.asarray(det_batch["boxes"])
    scores = np.asarray(det_batch["scores"])
    classes = np.asarray(det_batch["classes"])
    valid = np.asarray(det_batch["valid"])
    masks = np.asarray(det_batch["masks"]) if "masks" in det_batch else None
    for b in range(min(len(boxes), nvalid)):
        for i in np.nonzero(valid[b])[0]:
            x1, y1, x2, y2 = [float(v) for v in boxes[b][i]]
            d = {
                "image_id": int(first_img_id + b),
                "category_id": int(classes[b][i]) + (1 if add_one else 0),
                "bbox": [x1, y1, max(0.0, x2 - x1), max(0.0, y2 - y1)],
                "score": float(scores[b][i]),
            }
            if masks is not None:
                if mask_size is not None:
                    up = resize_f32(masks[b][i], int(mask_size), int(mask_size))
                    d["segmentation"] = rle_encode_np(up > 0.5)
                else:
                    d["mask"] = masks[b][i] > 0.5
            out.append(d)
    return out


def unpack_masks(packed: np.ndarray) -> np.ndarray:
    """Masks bit-packed along W [..., Hp, ceil(Wp/8)] -> {0,1} uint8
    [..., Hp, Wp]; the width is Hp (square prototypes)."""
    return np.unpackbits(packed, axis=-1, count=packed.shape[-2])


def gts_to_coco(batch: Dict[str, np.ndarray], first_img_id: int, nvalid: int,
                img_size: int, ann_id_start: int):
    """Padded GT batch -> (coco images, coco anns, next_ann_id).

    Segmentation batches attach each GT's mask: the dataset's
    full-resolution RLE ("gt_rles", area from the RLE) when present, else
    the proto-res binary mask (from "masks" or "masks_packed")."""
    images, anns = [], []
    ann_id = ann_id_start
    boxes = np.asarray(batch["boxes"])
    labels = np.asarray(batch["labels"])
    mask = np.asarray(batch["mask"])
    if "masks" in batch:
        gt_masks = np.asarray(batch["masks"])
    elif "masks_packed" in batch:
        gt_masks = unpack_masks(np.asarray(batch["masks_packed"]))
    else:
        gt_masks = None
    gt_rles = batch.get("gt_rles")
    for b in range(min(len(boxes), nvalid)):
        img_id = int(first_img_id + b)
        images.append({"id": img_id, "file_name": f"val_{img_id}.jpg",
                       "width": int(img_size), "height": int(img_size)})
        for i in np.nonzero(mask[b])[0]:
            x1, y1, x2, y2 = [float(v) for v in boxes[b][i]]
            w, h = max(0.0, x2 - x1), max(0.0, y2 - y1)
            a = {"id": ann_id, "image_id": img_id,
                 "category_id": int(labels[b][i]) + 1,
                 "bbox": [x1, y1, w, h], "area": float(w * h), "iscrowd": 0}
            if gt_rles is not None and i < len(gt_rles[b]):
                a["segmentation"] = gt_rles[b][i]
                a["area"] = float(rle_area(gt_rles[b][i]))
            elif gt_masks is not None:
                a["mask"] = gt_masks[b][i] > 0
            anns.append(a)
            ann_id += 1
    return images, anns, ann_id


def bench_forward_ms_per_img(trainer, variables, batch_size: int, img_size: int,
                             warmup: int = 3, iters: int = 10) -> float:
    """Forward-only latency per image on the model's device: CUDA events over
    `iters` calls on the card, the host clock on the CPU."""
    dev = next(variables.parameters()).device
    x = torch.zeros((batch_size, img_size, img_size, 3), dtype=torch.uint8, device=dev)
    for _ in range(warmup):
        trainer.eval_forward(variables, x)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            trainer.eval_forward(variables, x)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            trainer.eval_forward(variables, x)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms / batch_size


def bench_forward_cpu_ms_per_img(trainer, variables, img_size: int) -> float:
    """Forward latency of a CPU copy of the model (batch 1, 3 calls): the
    deploy-on-host number, measured; NaN when the model already runs on the
    CPU (benched above)."""
    if next(variables.parameters()).device.type == "cpu":
        return float("nan")
    cpu_model = copy.deepcopy(variables).cpu().float()
    return bench_forward_ms_per_img(trainer, cpu_model, batch_size=1, img_size=img_size,
                                    warmup=1, iters=3)


def make_summary_image(stats: Dict[str, float], curves: Dict, ms_per_img: float,
                       out_path: str, title: str = "Evaluation summary",
                       ms_per_img_cpu: float = float("nan")):
    """Text dashboard PNG; skipped without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.axis("off")
    lines = [title, ""]
    for k in ("AP", "AP50", "AP75", "APS", "APM", "APL", "AR"):
        lines.append(f"{k:>6}: {stats.get(k, 0.0):.4f}")
    lines.append("")
    lines.append(f"best F1: {curves.get('best_f1', 0.0):.4f} "
                 f"@ conf {curves.get('best_conf', 0.0):.3f}")
    lines.append(f"P/R at best: {curves.get('precision_at_best', 0.0):.4f} / "
                 f"{curves.get('recall_at_best', 0.0):.4f}")
    lines.append("")
    lines.append(f"forward latency: {ms_per_img:.2f} ms/img "
                 f"({1000.0 / max(ms_per_img, 1e-9):.1f} img/s)")
    if np.isfinite(ms_per_img_cpu):
        lines.append(f"host-CPU forward: {ms_per_img_cpu:.2f} ms/img "
                     f"({1000.0 / max(ms_per_img_cpu, 1e-9):.1f} img/s)")
    ax.text(0.02, 0.98, "\n".join(lines), va="top", family="monospace", fontsize=12)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def evaluate_model(trainer, variables, val_loader, log_dir: str, num_classes: int,
                   img_size: int, class_names: Optional[Sequence[str]] = None,
                   conf_th: float = 0.001, iou_th: float = 0.65,
                   max_det: int = 300, run_bench: bool = True) -> Dict[str, Any]:
    """`variables` is the model to evaluate (a `YOLOLiteMS` on the trainer's
    device)."""
    os.makedirs(log_dir, exist_ok=True)
    coco_images: List[dict] = []
    coco_anns: List[dict] = []
    coco_dets: List[dict] = []
    ann_id, img_id = 1, 1
    for batch in val_loader:
        nvalid = int(batch.get("nvalid", len(batch["image"])))
        _, dets = trainer.eval_step(variables, trainer.put_batch(batch), conf_th=conf_th,
                                    iou_th=iou_th, max_det=max_det)
        imgs, anns, ann_id = gts_to_coco(batch, img_id, nvalid, img_size, ann_id)
        coco_images += imgs
        coco_anns += anns
        coco_dets += dets_to_coco({k: v.cpu().numpy() for k, v in dets.items()},
                                  img_id, nvalid, mask_size=img_size)
        img_id += nvalid

    stats = coco_eval_from_lists(coco_images, coco_anns, coco_dets, num_classes=num_classes)
    # instance-segmentation mAP (mask IoU at image resolution) when both sides
    # carry masks
    has = lambda items: any("segmentation" in x or "mask" in x for x in items)
    segm_stats = None
    if has(coco_dets) and has(coco_anns):
        segm_stats = COCOEvaluator(num_classes, iou_type="segm").evaluate(
            coco_images, coco_anns, coco_dets)
    curves = build_curves_from_coco(coco_images, coco_anns, coco_dets, out_dir=log_dir)
    create_confusion_matrix(coco_anns, coco_dets, num_classes,
                            conf=float(curves.get("best_conf", 0.25) or 0.25),
                            class_names=class_names, out_dir=log_dir)
    if run_bench:
        ms_per_img = bench_forward_ms_per_img(
            trainer, variables, batch_size=min(8, val_loader.batch_size), img_size=img_size)
        ms_per_img_cpu = bench_forward_cpu_ms_per_img(trainer, variables, img_size)
    else:
        ms_per_img = ms_per_img_cpu = float("nan")
    make_summary_image(stats, curves, ms_per_img, os.path.join(log_dir, "summary.png"),
                       ms_per_img_cpu=ms_per_img_cpu)
    # NaN is not valid JSON: write null
    jsonable = lambda v: float(v) if np.isfinite(v) else None
    results = {
        "coco": stats,
        "best_f1": float(curves.get("best_f1", 0.0)),
        "best_conf": float(curves.get("best_conf", 0.0)),
        "ms_per_img": jsonable(ms_per_img),
        "ms_per_img_cpu": jsonable(ms_per_img_cpu),
    }
    if segm_stats is not None:
        results["coco_segm"] = segm_stats
    with open(os.path.join(log_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results
