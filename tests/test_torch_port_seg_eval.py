"""PyTorch port parity, segmentation evaluation: the COCO list functions with
masks (detections upsampled to the image and RLE-encoded; GTs from the
dataset's full-resolution RLEs or the bit-packed prototype masks), segm
COCOeval (mask IoU) and `evaluate_model`'s `coco_segm`, against the JAX
package (numpy on both sides).

Tolerances: the lists equal (RLE counts exact; the port's `resize_f32` is
cv2.resize INTER_LINEAR on floats, which the JAX function calls); every stat
within 1e-12 (the same float64 numpy code in the same order).
"""

import numpy as np
import pytest
import torch

from yololite_tpu.eval.coco import COCOEvaluator as JaxCOCOEvaluator
from yololite_tpu.eval.coco import mask_iou_matrix as jax_mask_iou
from yololite_tpu.eval.evaluate import dets_to_coco as jax_dets_to_coco
from yololite_tpu.eval.evaluate import evaluate_model as jax_evaluate_model
from yololite_tpu.eval.evaluate import gts_to_coco as jax_gts_to_coco
from yololite_tpu.ops.masks import rle_encode_np as jax_rle_encode

from tests.test_torch_port_eval import random_batches
from yololite_tpu_torch.eval.coco import COCOEvaluator, mask_iou_matrix
from yololite_tpu_torch.eval.evaluate import dets_to_coco, evaluate_model, gts_to_coco

IMG, HP = 320, 40


def _box_masks(boxes, size, scale):
    """[..., 4] boxes in image pixels -> {0,1} [..., size, size] rectangles."""
    c = (np.arange(size) + 0.5) / scale
    b = boxes[..., None, None, :]
    return ((c[:, None] >= b[..., 1]) & (c[:, None] <= b[..., 3])
            & (c[None, :] >= b[..., 0]) & (c[None, :] <= b[..., 2])).astype(np.uint8)


def seg_batches(seed, gt_kind="rles"):
    """random_batches plus masks: GT rectangles (with a notch) as RLEs at
    IMG and bit-packed at HP, detection probabilities near them at HP. The
    real GT rows come first, as the dataset pads them (the RLE list is
    indexed by row)."""
    rng = np.random.RandomState(100 + seed)
    out = []
    for gt, det, nvalid in random_batches(seed):
        m = gt["mask"]
        gt = dict(gt, mask=np.arange(m.shape[1])[None] < m.sum(1, keepdims=True))
        full = _box_masks(gt["boxes"], IMG, 1.0)
        full[..., : IMG // 8, : IMG // 8] = 0
        proto = _box_masks(gt["boxes"], HP, HP / IMG)
        gt = dict(gt, masks_packed=np.packbits(proto, axis=-1))
        if gt_kind == "rles":
            gt["gt_rles"] = [[jax_rle_encode(full[b, i]) for i in np.nonzero(gt["mask"][b])[0]]
                             for b in range(len(full))]
        probs = _box_masks(det["boxes"], HP, HP / IMG) * 0.8 + \
            rng.uniform(0, 0.3, det["boxes"].shape[:2] + (HP, HP))
        out.append((gt, dict(det, masks=probs.astype(np.float32)), nvalid))
    return out


def _lists(batches, gts_fn, dets_fn, mask_size):
    images, anns, dets = [], [], []
    ann_id, img_id = 1, 1
    for gt, det, nvalid in batches:
        im, an, ann_id = gts_fn(gt, img_id, nvalid, IMG, ann_id)
        images += im
        anns += an
        dets += dets_fn(det, img_id, nvalid, mask_size=mask_size)
        img_id += nvalid
    return images, anns, dets


def _same_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "segmentation":
                assert g[k]["size"] == w[k]["size"]
                np.testing.assert_array_equal(g[k]["counts"], w[k]["counts"])
            elif k == "mask":
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("seed,gt_kind,mask_size", [(0, "rles", IMG), (1, "rles", IMG),
                                                    (2, "packed", None)])
def test_segm_lists_and_stats_equal_jax(seed, gt_kind, mask_size):
    batches = seg_batches(seed, gt_kind)
    got = _lists(batches, gts_to_coco, dets_to_coco, mask_size)
    want = _lists(batches, jax_gts_to_coco, jax_dets_to_coco, mask_size)
    for g, w in zip(got, want):
        _same_items(g, w)
    for iou_type in ("segm", "bbox"):
        s_got = COCOEvaluator(3, iou_type=iou_type).evaluate(*got)
        s_want = JaxCOCOEvaluator(3, iou_type=iou_type).evaluate(*want)
        assert s_got.keys() == s_want.keys()
        for k in s_want:
            np.testing.assert_allclose(s_got[k], s_want[k], rtol=0, atol=1e-12,
                                       err_msg=f"{iou_type} {k}")
    assert COCOEvaluator(3, iou_type="segm").evaluate(*got)["AP50"] > 0.05


def test_mask_iou_matrix_equals_jax():
    rng = np.random.RandomState(7)
    d, g = rng.rand(5, 9, 11) > 0.5, rng.rand(4, 9, 11) > 0.4
    d[0] = False
    np.testing.assert_array_equal(mask_iou_matrix(d, g), jax_mask_iou(d, g))
    assert mask_iou_matrix(d[:0], g).shape == (0, 4)


class _FixedTrainer:
    """A trainer stand-in whose eval_step returns fixed detections, so both
    packages' `evaluate_model` see equal detections."""

    def __init__(self, dets, to_torch):
        self.dets, self.to_torch, self.i = dets, to_torch, 0

    def put_batch(self, batch):
        return batch

    def eval_step(self, variables, batch, **kw):
        d = self.dets[self.i]
        self.i += 1
        return {}, ({k: torch.from_numpy(v) for k, v in d.items()} if self.to_torch else d)


class _Loader:
    def __init__(self, batches):
        self.batches, self.batch_size = batches, 4

    def __iter__(self):
        for gt, _, nvalid in self.batches:
            yield dict(gt, image=np.zeros((4, IMG, IMG, 3), np.uint8), nvalid=np.int32(nvalid))


def test_evaluate_model_coco_segm_equals_jax(tmp_path):
    batches = seg_batches(3)
    dets = [d for _, d, _ in batches]
    got = evaluate_model(_FixedTrainer(dets, True), None, _Loader(batches),
                         str(tmp_path / "port"), 3, IMG, run_bench=False)
    want = jax_evaluate_model(_FixedTrainer(dets, False), None, _Loader(batches),
                              str(tmp_path / "jax"), 3, IMG, run_bench=False)
    for key in ("coco", "coco_segm"):
        assert got[key].keys() == want[key].keys()
        for k in want[key]:
            np.testing.assert_allclose(got[key][k], want[key][k], rtol=0, atol=1e-12,
                                       err_msg=f"{key} {k}")
    assert got["coco_segm"]["AP"] != got["coco"]["AP"]
    for k in ("best_f1", "best_conf"):
        assert got[k] == pytest.approx(want[k], abs=1e-12)
