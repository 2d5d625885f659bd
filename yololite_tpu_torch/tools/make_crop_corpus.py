"""A classification imagefolder of a YOLO detection dataset's boxes (port of
`tools/make_crop_corpus.py`).

    python -m yololite_tpu_torch.tools.make_crop_corpus --data /tmp/hardsynth \
        --out /tmp/crops [--margin 0.25] [--min_px 10] [--max_per_class 2000] [--seed 0]

Every labelled box (box rows, or the bounding box of a polygon row) becomes
one JPEG crop (cv2's default quality 95) with a context margin of `margin`
of its size, under out/train/<class>/ and out/val/<class>/, named
<image stem>_<row>.jpg: the layout `pretrain_backbone` reads. Images are
read with the port's codecs (`data/codecs.py`), label dirs resolved as the
trainer resolves them (`config._labels_or_fallback`), the images of a split
visited in a RandomState(seed) shuffle with a cap of `max_per_class` crops
a class. Host numpy only: no cv2 or PyYAML.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from yololite_tpu_torch.config import read_yaml
from yololite_tpu_torch.config.config import _labels_or_fallback
from yololite_tpu_torch.data import codecs
from yololite_tpu_torch.data.imwrite import imwrite_bgr


def extract_split(img_dir, lab_dir, out_root, names, margin, min_px,
                  max_per_class, rng):
    """Crops of one split's images; returns the crops a class."""
    counts = np.zeros(len(names), np.int64)
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    rng.shuffle(files)
    for fn in files:
        lab = os.path.join(lab_dir, os.path.splitext(fn)[0] + ".txt")
        if not os.path.exists(lab):
            continue
        try:
            img = codecs.imread_bgr(os.path.join(img_dir, fn))
        except (ValueError, codecs.UnsupportedImage):
            continue
        h, w = img.shape[:2]
        with open(lab) as f:
            rows = [ln.split() for ln in f.read().splitlines() if ln.strip()]
        for ri, r in enumerate(rows):
            ci = int(float(r[0]))
            if ci < 0 or ci >= len(names):
                print(f"[WARN] {lab}: row {ri} class id {ci} outside "
                      f"names[0..{len(names) - 1}], skipped")
                continue
            if counts[ci] >= max_per_class:
                continue
            # seg rows are `cls x1 y1 x2 y2 ...` polygons; box rows are
            # `cls cx cy bw bh`: take the bbox of whatever coords follow
            vals = np.asarray([float(v) for v in r[1:]], np.float32)
            if vals.size == 4:
                cx, cy, bw, bh = vals
                x1, y1 = (cx - bw / 2) * w, (cy - bh / 2) * h
                x2, y2 = (cx + bw / 2) * w, (cy + bh / 2) * h
            else:
                xs, ys = vals[0::2] * w, vals[1::2] * h
                x1, y1, x2, y2 = xs.min(), ys.min(), xs.max(), ys.max()
            mx, my = margin * (x2 - x1), margin * (y2 - y1)
            xa, ya = max(0, int(x1 - mx)), max(0, int(y1 - my))
            xb, yb = min(w, int(x2 + mx) + 1), min(h, int(y2 + my) + 1)
            if xb - xa < min_px or yb - ya < min_px:
                continue
            cdir = os.path.join(out_root, names[ci])
            os.makedirs(cdir, exist_ok=True)
            imwrite_bgr(os.path.join(cdir, f"{os.path.splitext(fn)[0]}_{ri}.jpg"),
                        np.ascontiguousarray(img[ya:yb, xa:xb]))
            counts[ci] += 1
    return counts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="YOLO dataset root (data.yaml with train/val/names)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--margin", type=float, default=0.25,
                    help="context margin as a fraction of box size")
    ap.add_argument("--min_px", type=int, default=10,
                    help="skip crops smaller than this on either side")
    ap.add_argument("--max_per_class", type=int, default=2000,
                    help="cap per class per split (class-imbalance guard)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    data_yaml = os.path.join(args.data, "data.yaml")
    dy = read_yaml(data_yaml)
    names = [str(n) for n in dy["names"]]
    rng = np.random.RandomState(args.seed)
    out = {}
    for split, key in (("train", "train"), ("val", "val")):
        if key not in dy:
            print(f"[WARN] data.yaml has no '{key}' split, skipped")
            continue
        img_dir = dy[key]
        if not os.path.isabs(img_dir):
            img_dir = os.path.join(args.data, img_dir)
        # the trainer's label-dir resolution (config/config.py)
        lab_dir = _labels_or_fallback("", img_dir, key, data_yaml)
        if not os.path.isdir(img_dir) or not os.path.isdir(lab_dir):
            print(f"[WARN] {split}: missing images/labels dir "
                  f"({img_dir} / {lab_dir}), skipped")
            continue
        counts = extract_split(img_dir, lab_dir, os.path.join(args.out, split), names,
                               args.margin, args.min_px, args.max_per_class, rng)
        out[split] = counts
        print(f"{split}: {int(counts.sum())} crops, "
              f"per-class min/max {int(counts.min())}/{int(counts.max())}")
    return out


if __name__ == "__main__":
    main()
