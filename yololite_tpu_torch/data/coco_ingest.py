"""COCO-json dataset ingestion (port of `data/coco_ingest.py`).

The train path reads YOLO-txt labels. A dataset distributed as COCO
`instances_*.json` is converted once to YOLO-txt next to the json
(`<json_dir>/labels_from_coco/<stem>/`), cached by modification time so that
a re-run skips the work. In data.yaml:

    train: images/train
    val: images/val
    train_json: annotations/instances_train.json
    val_json: annotations/instances_val.json
    # names/nc optional: read from the json's categories

Polygons are kept (YOLO-seg polygon lines, which the detection path collapses
to boxes); crowd/RLE annotations fall back to their bbox. Category ids map to
a dense 0..nc-1 by ascending original id.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple


def coco_to_yolo_labels(json_path: str,
                        out_dir: Optional[str] = None) -> Tuple[str, List[str]]:
    """Convert a COCO instances json to a YOLO-txt label dir.

    Returns (label_dir, class_names). Conversion is skipped when the output
    dir already exists and is newer than the json.
    """
    json_path = os.path.abspath(json_path)
    if out_dir is None:
        stem = os.path.splitext(os.path.basename(json_path))[0]
        out_dir = os.path.join(os.path.dirname(json_path),
                               "labels_from_coco", stem)
    stamp = os.path.join(out_dir, ".converted")
    names_file = os.path.join(out_dir, ".names.json")
    if os.path.exists(stamp) and os.path.exists(names_file) and \
            os.path.getmtime(stamp) >= os.path.getmtime(json_path):
        with open(names_file) as f:
            return out_dir, json.load(f)

    with open(json_path) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    names = [str(c.get("name", c["id"])) for c in cats]

    images = {im["id"]: im for im in coco.get("images", [])}
    lines = {im_id: [] for im_id in images}
    for ann in coco.get("annotations", []):
        im = images.get(ann["image_id"])
        if im is None or ann.get("category_id") not in id_map:
            continue
        w, h = float(im["width"]), float(im["height"])
        cls = id_map[ann["category_id"]]
        seg = ann.get("segmentation")
        if (seg and isinstance(seg, list) and not ann.get("iscrowd") and
                all(isinstance(p, list) and len(p) >= 6 for p in seg)):
            # polygon(s): one YOLO-seg line per polygon part
            for poly in seg:
                xs = [min(max(float(v) / w, 0.0), 1.0) for v in poly[0::2]]
                ys = [min(max(float(v) / h, 0.0), 1.0) for v in poly[1::2]]
                coords = " ".join(f"{x:.6f} {y:.6f}" for x, y in zip(xs, ys))
                lines[ann["image_id"]].append(f"{cls} {coords}")
        else:
            bx, by, bw, bh = [float(v) for v in ann["bbox"]]
            cx, cy = (bx + bw / 2.0) / w, (by + bh / 2.0) / h
            lines[ann["image_id"]].append(
                f"{cls} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}")

    os.makedirs(out_dir, exist_ok=True)
    for im_id, im in images.items():
        stem = os.path.splitext(os.path.basename(im["file_name"]))[0]
        with open(os.path.join(out_dir, stem + ".txt"), "w") as f:
            ls = lines[im_id]
            f.write("\n".join(ls) + ("\n" if ls else ""))
    with open(names_file, "w") as f:
        json.dump(names, f)
    with open(stamp, "w") as f:
        f.write("ok\n")
    return out_dir, names
