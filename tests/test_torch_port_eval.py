"""PyTorch port parity: COCO bbox stats, P/R/F1 curves, the confusion matrix
and the COCO list builders against the JAX package (numpy on both sides).

Tolerance 1e-12 on every float (the same numpy code in the same order; the
JAX package's native C++ matcher and the port's Python one make the same
integer decisions), CSV and text outputs byte for byte.
"""

import os

import numpy as np
import pytest

from yololite_tpu.eval.coco import coco_eval_from_lists as jax_coco
from yololite_tpu.eval.confusion import create_confusion_matrix as jax_confusion
from yololite_tpu.eval.evaluate import dets_to_coco as jax_dets_to_coco
from yololite_tpu.eval.evaluate import gts_to_coco as jax_gts_to_coco
from yololite_tpu.eval.prf1 import build_curves_from_coco as jax_curves

from yololite_tpu_torch.eval.coco import COCOEvaluator, coco_eval_from_lists
from yololite_tpu_torch.eval.confusion import create_confusion_matrix
from yololite_tpu_torch.eval.evaluate import dets_to_coco, gts_to_coco
from yololite_tpu_torch.eval.prf1 import build_curves_from_coco


def random_batches(seed, n_batches=3, B=4, M=6, D=40, C=3, img=320):
    """Padded GT batches and fixed-shape NMS outputs: detections near the
    GTs (jittered, some with the wrong class) plus background ones."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        xy = rng.uniform(0, img - 120, (B, M, 2))
        wh = rng.uniform(8, 120, (B, M, 2))
        gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        labels = rng.randint(0, C, (B, M)).astype(np.int32)
        mask = rng.rand(B, M) > 0.3
        src = rng.randint(0, M, (B, D))
        boxes = np.take_along_axis(gt, src[..., None], 1) + rng.normal(0, 6, (B, D, 4))
        bg = rng.rand(B, D) < 0.3
        boxes[bg] = rng.uniform(0, img, (int(bg.sum()), 4))
        boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 1)
        classes = np.where(rng.rand(B, D) < 0.8, np.take_along_axis(labels, src, 1),
                           rng.randint(0, C, (B, D))).astype(np.int32)
        scores = rng.rand(B, D).astype(np.float32)
        valid = rng.rand(B, D) > 0.2
        scores[~valid], classes[~valid] = 0.0, -1
        out.append(({"boxes": gt, "labels": labels, "mask": mask},
                    {"boxes": boxes.astype(np.float32), "scores": scores,
                     "classes": classes, "valid": valid}, B - (1 if _ == n_batches - 1 else 0)))
    return out


def to_lists(batches, builders):
    gts_fn, dets_fn = builders
    images, anns, dets = [], [], []
    ann_id, img_id = 1, 1
    for gt, det, nvalid in batches:
        im, an, ann_id = gts_fn(gt, img_id, nvalid, 320, ann_id)
        images += im
        anns += an
        dets += dets_fn(det, img_id, nvalid)
        img_id += nvalid
    return images, anns, dets


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_coco_lists_and_stats_equal_jax(seed):
    batches = random_batches(seed)
    want = to_lists(batches, (jax_gts_to_coco, jax_dets_to_coco))
    got = to_lists(batches, (gts_to_coco, dets_to_coco))
    assert got == want
    s_got = coco_eval_from_lists(*got, num_classes=3)
    s_want = jax_coco(*want, num_classes=3)
    assert s_got.keys() == s_want.keys()
    for k in s_want:
        np.testing.assert_allclose(s_got[k], s_want[k], rtol=0, atol=1e-12, err_msg=k)
    assert s_got["AP50"] > 0.1                      # the case is not degenerate


def test_coco_empty_and_segm():
    assert coco_eval_from_lists([], [], [])["AP"] == 0.0
    # segm is ported: mask IoU on dense masks, equal to JAX's evaluator
    from yololite_tpu.eval.coco import COCOEvaluator as JaxCOCOEvaluator
    rng = np.random.RandomState(0)
    images = [{"id": 1, "width": 16, "height": 16}]
    anns = [{"id": i + 1, "image_id": 1, "category_id": 1, "bbox": [0, 0, 8, 8],
             "area": 64.0, "iscrowd": 0, "mask": rng.rand(16, 16) > 0.5} for i in range(3)]
    dets = [{"image_id": 1, "category_id": 1, "bbox": [0, 0, 8, 8], "score": float(s),
             "mask": (a["mask"] ^ (rng.rand(16, 16) > 0.9))}
            for a, s in zip(anns, rng.rand(3))]
    got = COCOEvaluator(3, iou_type="segm").evaluate(images, anns, dets)
    assert got == JaxCOCOEvaluator(3, iou_type="segm").evaluate(images, anns, dets)
    assert got["AP50"] > 0.5
    assert COCOEvaluator(3, iou_type="segm").evaluate(images, anns, [])["AP"] == 0.0
    with pytest.raises(ValueError, match="iou_type"):
        COCOEvaluator(3, iou_type="keypoints")


@pytest.mark.parametrize("seed", [0, 5])
def test_prf1_curves_and_csv_equal_jax(seed, tmp_path):
    images, anns, dets = to_lists(random_batches(seed), (gts_to_coco, dets_to_coco))
    a, b = tmp_path / "port", tmp_path / "jax"
    got = build_curves_from_coco(images, anns, dets, out_dir=str(a))
    want = jax_curves(images, anns, dets, out_dir=str(b))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                   rtol=0, atol=1e-12, err_msg=k)
    assert (a / "p_r_f1_curves.csv").read_bytes() == (b / "p_r_f1_curves.csv").read_bytes()
    empty = build_curves_from_coco(images, anns, [])
    assert empty == jax_curves(images, anns, [])


@pytest.mark.parametrize("conf", [0.0, 0.3, 0.7])
def test_confusion_matrix_equals_jax(conf, tmp_path):
    images, anns, dets = to_lists(random_batches(7), (gts_to_coco, dets_to_coco))
    a, b = tmp_path / "port", tmp_path / "jax"
    got = create_confusion_matrix(anns, dets, 3, conf=conf, class_names=["x", "y", "z"],
                                  out_dir=str(a))
    want = jax_confusion(anns, dets, 3, conf=conf, class_names=["x", "y", "z"],
                         out_dir=str(b))
    np.testing.assert_array_equal(got, want)
    assert (a / "confusion_stats.txt").read_text() == (b / "confusion_stats.txt").read_text()


def test_padding_images_are_skipped():
    batches = random_batches(9, n_batches=1)
    gt, det, _ = batches[0]
    images, anns, _ = gts_to_coco(gt, 1, 2, 320, 1)
    assert [im["id"] for im in images] == [1, 2]
    assert {d["image_id"] for d in dets_to_coco(det, 1, 2)} <= {1, 2}
    assert os.path.basename(images[0]["file_name"]) == "val_1.jpg"
