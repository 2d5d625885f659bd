"""Offline weather augmentation CLI (port of `tools/augment_weather.py`).

    python -m yololite_tpu_torch.tools.augment_weather --images ds/train/images \
        --labels ds/train/labels --out ds_weather --effects rain fog --per_image 2

Writes weather-augmented JPEG copies of a dataset (`data/weather.py`): a
YOLO layout (labels copied) or, with --coco_json, a COCO layout with an
extended annotation json. Host work only (no device).
"""

from __future__ import annotations

import argparse
import os

from yololite_tpu_torch.data.weather import EFFECTS, augment_coco, augment_yolo


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True)
    ap.add_argument("--labels", default=None, help="YOLO label dir")
    ap.add_argument("--coco_json", default=None, help="COCO annotations json")
    ap.add_argument("--out", required=True)
    ap.add_argument("--effects", nargs="+", default=list(EFFECTS),
                    choices=list(EFFECTS))
    ap.add_argument("--per_image", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.coco_json:
        n = augment_coco(args.images, args.coco_json, args.out, args.effects,
                         args.per_image, args.seed)
    else:
        labels = args.labels or os.path.join(os.path.dirname(args.images), "labels")
        n = augment_yolo(args.images, labels, args.out, args.effects,
                         args.per_image, args.seed)
    print(f"Wrote {n} augmented images to {args.out}")
    return n


if __name__ == "__main__":
    main()
