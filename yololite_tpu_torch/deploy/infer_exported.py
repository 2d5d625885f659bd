"""Host pre- and post-processing of an exported artifact (no model code).

The library half of the JAX package's `tools/infer_exported.py`: letterbox
a BGR frame, run an artifact loaded by `deploy/export.load_exported` (a
`.pt2` program on its device, or an `.onnx` file on the host), then either
unpack the "nms" format's in-graph detections or, for "decoded", apply
sigmoid, score and per-class greedy NMS on the host (`ops/nms.nms_numpy`),
assemble a segmentation model's masks on the host
(`ops/masks.assemble_masks_np`) and map boxes and masks back to the frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yololite_tpu_torch.deploy.predictor import frame_masks
from yololite_tpu_torch.ops.letterbox import letterbox_image, unletterbox_boxes
from yololite_tpu_torch.ops.masks import assemble_masks_np
from yololite_tpu_torch.ops.nms import nms_numpy


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def postprocess_decoded(out, conf: float, iou: float, max_det: int):
    """Host post-processing of the "decoded" format's first image (boxes +
    logits, NMS outside). Returns (boxes, scores, classes, kept_indices):
    the indices into the pre-NMS anchor axis select a segmentation model's
    mask coefficients."""
    boxes = _host(out["boxes_xyxy"])[0]
    obj = 1.0 / (1.0 + np.exp(-_host(out["obj_logits"])[0, :, 0]))
    cls = 1.0 / (1.0 + np.exp(-_host(out["cls_logits"])[0]))
    if cls.shape[-1] > 0:
        scores = obj * cls.max(-1)
        clsi = cls.argmax(-1)
    else:
        scores = obj
        clsi = np.zeros_like(obj, np.int64)
    m = scores > conf
    orig = np.nonzero(m)[0]
    boxes, scores, clsi = boxes[m], scores[m], clsi[m]
    fb, fs, fc, fi = [], [], [], []
    for c in np.unique(clsi):
        cm = clsi == c
        keep = nms_numpy(boxes[cm], scores[cm], iou)
        fb.append(boxes[cm][keep])
        fs.append(scores[cm][keep])
        fc.append(np.full(len(keep), c))
        fi.append(orig[cm][keep])
    if not fb:
        return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    boxes, scores = np.concatenate(fb), np.concatenate(fs)
    clsi, idx = np.concatenate(fc), np.concatenate(fi)
    order = np.argsort(-scores)[:max_det]
    return boxes[order], scores[order], clsi[order], idx[order]


def infer_frame(call, meta, img_bgr: np.ndarray, conf: float = 0.25, iou: float = 0.45,
                max_det: int = 300):
    """One BGR frame through an artifact `(call, meta)`: a dict of `boxes`
    (frame pixels), `scores`, `classes`, `masks` (uint8 [D, h, w] for a
    segmentation artifact, else None) and `speed` {preprocess_ms,
    inference_ms, postprocess_ms}. For "nms" artifacts `iou` and `max_det`
    were fixed at export; `conf` still filters on the host."""
    fmt = meta.get("format", "decoded")
    img_size = int(meta.get("img_size", 640))
    h, w = img_bgr.shape[:2]
    t0 = time.perf_counter()
    canvas, scale, px, py = letterbox_image(np.ascontiguousarray(img_bgr[..., ::-1]),
                                            img_size)
    t1 = time.perf_counter()
    out = call(canvas[None])
    out = {k: _host(v) for k, v in out.items()} if isinstance(out, dict) \
        else tuple(_host(v) for v in out)
    t2 = time.perf_counter()
    masks = None
    if fmt == "nms":
        b, s, c, v = out[:4]
        m = v[0].astype(bool) & (s[0] >= conf)
        boxes, scores, classes = b[0][m], s[0][m], c[0][m]
        if len(out) > 4:                      # the in-graph assembled masks
            masks = frame_masks(out[4][0][m], img_size, px, py, w, h)
    elif fmt == "decoded":
        boxes, scores, classes, kept = postprocess_decoded(out, conf, iou, max_det)
        if "mask_coef" in out:                # host YOLACT assembly
            pm = assemble_masks_np(out["protos"][0], out["mask_coef"][0][kept], boxes,
                                   float(img_size))
            masks = frame_masks(pm, img_size, px, py, w, h)
    else:
        raise ValueError(f"format {fmt!r} has no host post-processing "
                         "(use 'decoded' or 'nms')")
    boxes = unletterbox_boxes(boxes, scale, px, py, w, h)
    t3 = time.perf_counter()
    return {"boxes": boxes, "scores": scores, "classes": classes, "masks": masks,
            "speed": {"preprocess_ms": (t1 - t0) * 1e3, "inference_ms": (t2 - t1) * 1e3,
                      "postprocess_ms": (t3 - t2) * 1e3}}
