"""Drawing (port of `utils/viz.py`): YOLO-palette boxes with labels, the
first-batch sanity image and the per-epoch val-debug images.

The drawing is cv2's, pixel for pixel, through the port's own primitives
(`data/imgops.rectangle`, `text_size`, `put_text`); files are written by
`data/imwrite.imwrite_bgr` (JPEG at cv2's default quality 95).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data.imwrite import imwrite_bgr

# Ultralytics-style palette
_PALETTE = [
    (4, 42, 255), (11, 219, 235), (243, 243, 243), (0, 223, 183), (17, 31, 104),
    (255, 111, 221), (255, 68, 79), (204, 237, 0), (0, 243, 68), (189, 0, 255),
    (0, 180, 255), (221, 0, 186), (0, 255, 255), (38, 192, 0), (1, 255, 179),
    (125, 36, 255), (123, 0, 104), (255, 27, 108), (252, 109, 47), (162, 255, 11),
]


def class_color(c: int):
    return _PALETTE[int(c) % len(_PALETTE)]


def draw_detections(img_rgb: np.ndarray, boxes, scores=None, classes=None,
                    names: Optional[Sequence[str]] = None,
                    line_width: int = 2) -> np.ndarray:
    """Draw xyxy boxes (+labels) on an RGB uint8 image; returns a copy."""
    out = np.ascontiguousarray(img_rgb.copy())
    boxes = np.asarray(boxes).reshape(-1, 4)
    for i in range(len(boxes)):
        x1, y1, x2, y2 = [int(round(float(v))) for v in boxes[i]]
        c = int(classes[i]) if classes is not None else 0
        color = class_color(c)
        imgops.rectangle(out, (x1, y1), (x2, y2), color, line_width)
        label = names[c] if names and 0 <= c < len(names) else str(c)
        if scores is not None:
            label = f"{label}:{float(scores[i]):.2f}"
        (tw, th), _ = imgops.text_size(label, 0.5, 1)
        imgops.rectangle(out, (x1, max(0, y1 - th - 6)), (x1 + tw + 2, y1), color, -1)
        imgops.put_text(out, label, (x1 + 1, max(10, y1 - 4)), 0.5, (255, 255, 255), 1)
    return out


def visualize_batch(batch: Dict[str, np.ndarray], save_path: str,
                    names: Optional[Sequence[str]] = None, max_images: int = 8):
    """First-batch ground-truth sanity image: up to `max_images` images of
    the batch in rows of four on a grey canvas."""
    imgs = np.asarray(batch["image"])
    boxes = np.asarray(batch["boxes"])
    labels = np.asarray(batch["labels"])
    mask = np.asarray(batch["mask"])
    n = min(len(imgs), max_images)
    tiles = []
    for b in range(n):
        m = mask[b]
        tiles.append(draw_detections(imgs[b], boxes[b][m], None, labels[b][m], names))
    if not tiles:
        return
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    h, w = tiles[0].shape[:2]
    canvas = np.full((rows * h, cols * w, 3), 114, np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = t
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    imwrite_bgr(save_path, canvas[..., ::-1])


def save_val_debug(images_u8: np.ndarray, dets: Dict[str, np.ndarray], out_dir: str,
                   conf_th: float = 0.35, max_images: int = 2,
                   names: Optional[Sequence[str]] = None):
    """Per-epoch prediction snapshots `last_b{n}.jpg`."""
    os.makedirs(out_dir, exist_ok=True)
    boxes = np.asarray(dets["boxes"])
    scores = np.asarray(dets["scores"])
    classes = np.asarray(dets["classes"])
    valid = np.asarray(dets["valid"])
    for b in range(min(len(images_u8), max_images)):
        keep = valid[b] & (scores[b] >= conf_th)
        img = draw_detections(np.asarray(images_u8[b]), boxes[b][keep],
                              scores[b][keep], classes[b][keep], names)
        imwrite_bgr(os.path.join(out_dir, f"last_b{b}.jpg"), img[..., ::-1])
