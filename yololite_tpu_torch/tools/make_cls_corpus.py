"""A synthetic classification imagefolder for backbone pretraining (port of
`tools/make_cls_corpus.py`).

    python -m yololite_tpu_torch.tools.make_cls_corpus --out /tmp/cls20 \
        --per_class 400 [--val_per_class 50] [--img 160] [--seed 77]

One object an image over HardSynth-20's 20 shape x texture classes, drawn
with `make_hard_synth`'s primitives on its cluttered backgrounds, anywhere
fully inside the frame at 30-90% of it, with the same photometric nuisance
and a 3x3 blur in a quarter of the images. Writes root/train/<class>/*.jpg
and root/val/<class>/*.jpg (cv2's default quality 95), the layout
`pretrain_backbone` reads. The same seed gives the JAX package's tool's
images within a level (`render_one`). Host numpy only: no cv2.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data.imwrite import imwrite_bgr
from yololite_tpu_torch.tools.make_hard_synth import (CLASSES, _clutter_background,
                                                      _shape_mask, _texture_patch)


def render_one(rng: np.random.RandomState, cls_id: int, img_px: int) -> np.ndarray:
    """One uint8 [img_px, img_px, 3] image of class `cls_id`; the tool
    writes it as cv2.imwrite does, its channels taken as BGR."""
    img = _clutter_background(rng, img_px, img_px)
    shape, texture = CLASSES[cls_id].split("_")
    # object fills 30-90% of the frame, anywhere fully inside it
    size = int(img_px * rng.uniform(0.3, 0.9))
    x1 = rng.randint(0, img_px - size)
    y1 = rng.randint(0, img_px - size)
    hue = rng.rand(3) * 200 + 30
    hue2 = np.clip(hue + (rng.rand(3) * 160 - 80), 0, 255)
    patch = _texture_patch(rng, size, texture, hue, hue2)
    mask = _shape_mask(rng, size, shape)
    region = img[y1:y1 + size, x1:x1 + size]
    region[mask > 0] = patch[mask > 0]
    # photometric nuisance matching the detection suite
    img = img * rng.uniform(0.7, 1.3) + rng.uniform(-25, 25)
    img += rng.randn(img_px, img_px, 3) * rng.uniform(0, 8)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if rng.rand() < 0.25:
        img = imgops.gaussian_blur3(img)
    return img


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--per_class", type=int, default=400)
    ap.add_argument("--val_per_class", type=int, default=50)
    ap.add_argument("--img", type=int, default=160)
    ap.add_argument("--seed", type=int, default=77)
    return ap


def main(argv=None) -> str:
    a = build_parser().parse_args(argv)
    rng = np.random.RandomState(a.seed)
    for split, n in (("train", a.per_class), ("val", a.val_per_class)):
        for ci, cname in enumerate(CLASSES):
            d = os.path.join(a.out, split, cname)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                imwrite_bgr(os.path.join(d, f"{i:05d}.jpg"), render_one(rng, ci, a.img))
        print(f"{split}: {n} images x {len(CLASSES)} classes")
    print("done ->", a.out)
    return a.out


if __name__ == "__main__":
    main()
