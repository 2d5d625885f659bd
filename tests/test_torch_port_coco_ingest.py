"""PyTorch port parity: COCO-json ingestion (`data/coco_ingest.py` and the
data.yaml wiring in `config/config.py`) against the JAX package (CPU). The
label files are compared byte for byte, the class names exactly."""

import json
import os

import numpy as np

from yololite_tpu.config.config import load_configs as jax_load_configs
from yololite_tpu.data.coco_ingest import coco_to_yolo_labels as jax_coco_to_yolo

from chip_smoke import write_png
from yololite_tpu_torch.config import load_configs
from yololite_tpu_torch.data.coco_ingest import coco_to_yolo_labels


def make_coco_set(root, n=5, w=80, h=60, seed=0):
    """PNG images and a COCO instances json per split: boxes, polygons (one
    with two parts), a crowd RLE, an unknown category, an image with no
    annotation, and sparse category ids. Returns the data.yaml path."""
    rng = np.random.RandomState(seed)
    cats = [{"id": 9, "name": "tri"}, {"id": 3, "name": "box"}, {"id": 42, "name": "blob"}]
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split in ("train", "val"):
        img_dir = os.path.join(root, "images", split)
        os.makedirs(img_dir, exist_ok=True)
        images, anns, aid = [], [], 1
        for i in range(n):
            write_png(os.path.join(img_dir, f"im{i}.png"),
                      (rng.rand(h, w, 3) * 60).astype(np.uint8))
            images.append({"id": 100 + i, "file_name": f"im{i}.png", "width": w, "height": h})
            if i == n - 1:
                continue                                   # no annotation
            x, y = float(rng.randint(0, w - 20)), float(rng.randint(0, h - 20))
            anns.append({"id": aid, "image_id": 100 + i, "category_id": 3,
                         "bbox": [x, y, 17.5, 12.25], "iscrowd": 0, "segmentation": []})
            anns.append({"id": aid + 1, "image_id": 100 + i, "category_id": 9, "iscrowd": 0,
                         "bbox": [x, y, 20, 20],
                         "segmentation": [[x, y, x + 20, y, x + 10, y + 20]]
                         + ([[1, 1, 9, 1, 5, 7, 2, 6]] if i % 2 else [])})
            anns.append({"id": aid + 2, "image_id": 100 + i, "category_id": 42, "iscrowd": 1,
                         "bbox": [0, 0, w + 5.0, 10], "segmentation": {"counts": [1, 2]}})
            anns.append({"id": aid + 3, "image_id": 100 + i, "category_id": 77,
                         "bbox": [1, 1, 2, 2]})
            aid += 4
        with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    data_yaml = os.path.join(root, "data.yaml")
    with open(data_yaml, "w") as f:
        f.write("train: images/train\nval: images/val\n"
                "train_json: annotations/instances_train.json\n"
                "val_json: annotations/instances_val.json\n")
    return data_yaml


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_labels_and_names_match_jax(tmp_path):
    make_coco_set(str(tmp_path))
    jp = str(tmp_path / "annotations" / "instances_train.json")
    jdir, jnames = jax_coco_to_yolo(jp, str(tmp_path / "jax"))
    pdir, pnames = coco_to_yolo_labels(jp, str(tmp_path / "port"))
    assert pnames == jnames == ["box", "tri", "blob"]
    assert _files(pdir) == _files(jdir)
    assert open(os.path.join(pdir, "im4.txt")).read() == ""


def test_conversion_is_cached_by_mtime(tmp_path):
    make_coco_set(str(tmp_path))
    jp = str(tmp_path / "annotations" / "instances_train.json")
    out, _ = coco_to_yolo_labels(jp)
    assert out == str(tmp_path / "annotations" / "labels_from_coco" / "instances_train")
    label = os.path.join(out, "im0.txt")
    with open(label, "w") as f:
        f.write("sentinel\n")
    coco_to_yolo_labels(jp)                          # cached: not rewritten
    assert open(label).read() == "sentinel\n"
    stamp = os.path.getmtime(os.path.join(out, ".converted"))
    os.utime(jp, (stamp + 10, stamp + 10))           # a newer json converts again
    coco_to_yolo_labels(jp)
    assert open(label).read() != "sentinel\n"


def test_data_yaml_with_json_matches_jax(tmp_path):
    data = make_coco_set(str(tmp_path))
    cp = load_configs(None, None, data, make_run_dir=False)      # converts
    cj = jax_load_configs(None, None, data, make_run_dir=False)  # reads its cache
    assert cp["dataset"] == cj["dataset"]
    assert cp["dataset"]["names"] == ["box", "tri", "blob"]
    assert cp["dataset"]["val_labels"].endswith(os.path.join("labels_from_coco",
                                                             "instances_val"))
    assert cp["model"]["num_classes"] == cj["model"]["num_classes"] == 3
