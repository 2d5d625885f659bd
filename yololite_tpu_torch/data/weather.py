"""Offline weather augmentation (port of `data/weather.py`): rain, snow,
fog, sun flare and shadow, and the dataset writers behind
`tools/augment_weather.py`.

Every effect is photometric, so labels are copied unchanged. The effects
draw from the caller's `np.random.RandomState` in the JAX package's order,
so one seed gives the same effects, file names and annotations; the cv2
calls are `data/imgops.py`'s (rain and snow equal cv2's output, fog's
cubic upsampling is within 2 ulp of it). Images are read by the port's
codecs (`data/codecs.imread_bgr`); a file cv2 would give None for is
skipped. Copies are written as JPEG (`data/imwrite.imwrite_bgr`).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np

from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data.codecs import imread_bgr
from yololite_tpu_torch.data.imwrite import imwrite_bgr

EFFECTS = ("rain", "snow", "fog", "sunflare", "shadow")


def add_rain(img: np.ndarray, rng: np.random.RandomState,
             density: float = 0.0008, length: int = 12, angle: float = -10.0):
    h, w = img.shape[:2]
    n = max(1, int(h * w * density))
    xs = rng.randint(0, w, n)
    ys = rng.randint(0, h, n)
    layer = np.zeros((h, w), np.uint8)
    dx = int(length * np.sin(np.radians(angle)))
    dy = int(length * np.cos(np.radians(angle)))
    for x, y in zip(xs, ys):
        imgops.line(layer, (x, y), (x + dx, y + dy), 255)
    layer = imgops.box_blur2_u8(layer).astype(np.float32) / 255.0
    out = img.astype(np.float32) * 0.92 + layer[..., None] * 200.0
    return np.clip(out, 0, 255).astype(np.uint8)


def add_snow(img: np.ndarray, rng: np.random.RandomState,
             density: float = 0.0015, brightness: float = 1.15):
    h, w = img.shape[:2]
    out = np.clip(img.astype(np.float32) * brightness, 0, 255)
    n = max(1, int(h * w * density))
    xs = rng.randint(0, w, n)
    ys = rng.randint(0, h, n)
    rs = rng.randint(1, 3, n)
    for x, y, r in zip(xs, ys, rs):
        imgops.fill_circle(out, (int(x), int(y)), int(r), (255, 255, 255))
    return imgops.box_blur2_u8(out.astype(np.uint8))


def add_fog(img: np.ndarray, rng: np.random.RandomState,
            intensity: float = 0.45):
    h, w = img.shape[:2]
    # low-frequency noise field as fog density
    small = rng.rand(max(2, h // 32), max(2, w // 32)).astype(np.float32)
    field = imgops.resize_cubic_f32(small, w, h)
    field = imgops.box_blur_f32(field, 31)
    alpha = np.clip(field * intensity + intensity * 0.5, 0, 1)[..., None]
    fog = np.full_like(img, 255, np.float32)
    out = img.astype(np.float32) * (1 - alpha) + fog * alpha
    return np.clip(out, 0, 255).astype(np.uint8)


def add_sunflare(img: np.ndarray, rng: np.random.RandomState):
    h, w = img.shape[:2]
    cx = rng.randint(0, w)
    cy = rng.randint(0, h // 2)   # flare in the upper half (reference flare_roi)
    overlay = img.astype(np.float32)
    max_r = int(min(h, w) * rng.uniform(0.3, 0.6))
    for r in range(max_r, 0, -max(1, max_r // 10)):
        alpha = 0.08 * (r / max_r)
        circle = np.zeros_like(overlay)
        imgops.fill_circle(circle, (cx, cy), r, (255, 240, 200))
        overlay = overlay * (1 - alpha) + circle * alpha
    return np.clip(overlay, 0, 255).astype(np.uint8)


def add_shadow(img: np.ndarray, rng: np.random.RandomState,
               strength: float = 0.5, dimension: int = 5):
    h, w = img.shape[:2]
    # random polygon in the lower half (reference shadow_roi=(0,0.5,1,1))
    pts = np.stack([rng.randint(0, w, dimension),
                    rng.randint(h // 2, h, dimension)], axis=1)
    mask = np.zeros((h, w), np.uint8)
    imgops.fill_convex_poly(mask, imgops.convex_hull(pts), 255)
    mask = imgops.box_blur_u8(mask, 25).astype(np.float32) / 255.0
    out = img.astype(np.float32) * (1 - strength * mask[..., None])
    return np.clip(out, 0, 255).astype(np.uint8)


_APPLY = {"rain": add_rain, "snow": add_snow, "fog": add_fog,
          "sunflare": add_sunflare, "shadow": add_shadow}


def apply_weather(img: np.ndarray, effect: str, rng: np.random.RandomState):
    return _APPLY[effect](img, rng)


def _read(path: str) -> Optional[np.ndarray]:
    """The BGR image, or None where cv2.imread gives None."""
    try:
        return imread_bgr(path)
    except ValueError:
        return None


def augment_yolo(img_dir: str, label_dir: str, out_dir: str,
                 effects: Optional[List[str]] = None, per_image: int = 1,
                 seed: int = 0) -> int:
    """Write weather-augmented copies next to copied labels (YOLO layout)."""
    effects = list(effects or EFFECTS)
    rng = np.random.RandomState(seed)
    out_img = Path(out_dir) / "images"
    out_lbl = Path(out_dir) / "labels"
    out_img.mkdir(parents=True, exist_ok=True)
    out_lbl.mkdir(parents=True, exist_ok=True)
    count = 0
    for f in sorted(os.listdir(img_dir)):
        if not f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
            continue
        img = _read(os.path.join(img_dir, f))
        if img is None:
            continue
        stem = Path(f).stem
        lbl = Path(label_dir) / f"{stem}.txt"
        for k in range(per_image):
            eff = effects[rng.randint(len(effects))]
            aug = apply_weather(img, eff, rng)
            name = f"{stem}_{eff}{k}"
            imwrite_bgr(str(out_img / f"{name}.jpg"), aug)
            if lbl.exists():
                shutil.copy(lbl, out_lbl / f"{name}.txt")
            count += 1
    return count


def augment_coco(img_dir: str, ann_json: str, out_dir: str,
                 effects: Optional[List[str]] = None, per_image: int = 1,
                 seed: int = 0) -> int:
    """COCO layout: augmented images + extended annotation json."""
    effects = list(effects or EFFECTS)
    rng = np.random.RandomState(seed)
    with open(ann_json) as f:
        coco = json.load(f)
    out_img = Path(out_dir) / "images"
    out_img.mkdir(parents=True, exist_ok=True)
    new_images, new_anns = [], []
    next_img_id = max((im["id"] for im in coco["images"]), default=0) + 1
    next_ann_id = max((a["id"] for a in coco["annotations"]), default=0) + 1
    anns_by_img = {}
    for a in coco["annotations"]:
        anns_by_img.setdefault(a["image_id"], []).append(a)
    count = 0
    for im in coco["images"]:
        img = _read(os.path.join(img_dir, im["file_name"]))
        if img is None:
            continue
        for k in range(per_image):
            eff = effects[rng.randint(len(effects))]
            aug = apply_weather(img, eff, rng)
            name = f"{Path(im['file_name']).stem}_{eff}{k}.jpg"
            imwrite_bgr(str(out_img / name), aug)
            new_im = dict(im, id=next_img_id, file_name=name)
            new_images.append(new_im)
            for a in anns_by_img.get(im["id"], []):
                new_anns.append(dict(a, id=next_ann_id, image_id=next_img_id))
                next_ann_id += 1
            next_img_id += 1
            count += 1
    coco["images"] += new_images
    coco["annotations"] += new_anns
    with open(Path(out_dir) / "annotations.json", "w") as f:
        json.dump(coco, f)
    return count
