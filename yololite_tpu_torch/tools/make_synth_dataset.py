"""A synthetic multi-class detection dataset in the YOLO layout (port of
`tools/make_synth_dataset.py`).

    python -m yololite_tpu_torch.tools.make_synth_dataset --out /tmp/synth \
        --n_train 240 --n_val 60 --img 320 [--seed 0] [--seg_polygons]

4 shape classes (rect, triangle, circle, ellipse) over noise backgrounds
with distractor strokes, 1-6 instances an image with scale variety and
partial overlap; YOLO txt labels (with --seg_polygons the triangles as
polygons), JPEG images at cv2's default quality 95 and a data.yaml. The same
seed gives the JAX package's tool's labels and pixels: the same RandomState
draws, and `data/imgops.py`'s OpenCV 5.0 drawing (rectangle, fillPoly,
circle, ellipse, line). Host numpy only: no cv2 or PyYAML.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data.imwrite import JPEG_QUALITY, write_jpeg
from yololite_tpu_torch.tools.make_hard_synth import write_data_yaml

CLASSES = ["rect", "triangle", "circle", "ellipse"]
COLORS = [(220, 40, 40), (40, 220, 40), (60, 80, 230), (230, 220, 40)]


def draw_instance(canvas, cls, rng, img):
    """Draw one instance of class `cls` on the RGB canvas; returns its box
    (x1, y1, x2, y2) and, for the triangle, its integer vertices."""
    size = int(rng.randint(14, max(16, img // 3)))
    x1 = int(rng.randint(0, img - size))
    y1 = int(rng.randint(0, img - size))
    color = tuple(int(c + rng.randint(-25, 26)) for c in COLORS[cls])
    if cls == 0:
        w, h = size, int(size * rng.uniform(0.5, 1.5))
        h = min(h, img - 1 - y1)
        imgops.rectangle(canvas, (x1, y1), (x1 + w, y1 + h), color, -1)
        return (x1, y1, x1 + w, y1 + h), None
    if cls == 1:
        pts = np.array([(x1, y1 + size), (x1 + size, y1 + size),
                        (x1 + size // 2, y1)], np.int32)
        imgops.fill_poly(canvas, pts, color)
        return (x1, y1, x1 + size, y1 + size), pts
    if cls == 2:
        r = size // 2
        imgops.fill_circle(canvas, (x1 + r, y1 + r), r, color)
        return (x1, y1, x1 + 2 * r, y1 + 2 * r), None
    a, b = size // 2, int(size * rng.uniform(0.25, 0.5))
    imgops.fill_ellipse(canvas, (x1 + a, y1 + b), (a, b), color)
    return (x1, y1, x1 + 2 * a, y1 + 2 * b), None


def make_canvas(rng, img: int, seg_polygons: bool = False):
    """One image: (RGB uint8 canvas [img, img, 3], its label rows)."""
    canvas = (rng.rand(img, img, 3) * 60 + rng.randint(0, 40)).astype(np.uint8)
    # distractor strokes
    for _ in range(rng.randint(0, 5)):
        p1 = tuple(rng.randint(0, img, 2).tolist())
        p2 = tuple(rng.randint(0, img, 2).tolist())
        col = tuple(int(v) for v in rng.randint(60, 140, 3))
        imgops.line(canvas, p1, p2, col)
    lines = []
    for _ in range(rng.randint(1, 7)):
        cls = int(rng.randint(len(CLASSES)))
        (x1, y1, x2, y2), poly = draw_instance(canvas, cls, rng, img)
        if seg_polygons and poly is not None:
            coords = " ".join(f"{px / img:.6f} {py / img:.6f}" for px, py in poly)
            lines.append(f"{cls} {coords}")
        else:
            cx, cy = (x1 + x2) / 2 / img, (y1 + y2) / 2 / img
            w, h = (x2 - x1) / img, (y2 - y1) / img
            lines.append(f"{cls} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}")
    return canvas, lines


def make_split(root, split, n, img, rng, seg_polygons=False):
    idir = os.path.join(root, split, "images")
    ldir = os.path.join(root, split, "labels")
    os.makedirs(idir, exist_ok=True)
    os.makedirs(ldir, exist_ok=True)
    for i in range(n):
        canvas, lines = make_canvas(rng, img, seg_polygons)
        write_jpeg(os.path.join(idir, f"{i:05d}.jpg"), canvas, JPEG_QUALITY)
        with open(os.path.join(ldir, f"{i:05d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_train", type=int, default=240)
    ap.add_argument("--n_val", type=int, default=60)
    ap.add_argument("--img", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seg_polygons", action="store_true")
    return ap


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    rng = np.random.RandomState(args.seed)
    make_split(args.out, "train", args.n_train, args.img, rng, args.seg_polygons)
    make_split(args.out, "valid", args.n_val, args.img, rng, args.seg_polygons)
    data_yaml = write_data_yaml(args.out, CLASSES)
    print(data_yaml)
    return data_yaml


if __name__ == "__main__":
    main()
