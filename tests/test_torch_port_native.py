"""The port's host C++ library (`csrc/native.cpp` through `native.py`)
against the JAX package's native functions and against the port's own
numpy plain versions.

Every comparison is exact: kept indices, IoU matrices (fp32, both sides
evaluate the same rounded operations in the same order), matches and packed
bytes. `evaluate_model` with the C++ matcher equals it with the Python
matcher to 1e-12, as `test_torch_port_eval.py` holds the stats to JAX's.
"""

import ctypes

import numpy as np
import pytest
import torch

from yololite_tpu import native as jax_native
from yololite_tpu.deploy.s2d import pack_s2d as jax_pack_s2d
from yololite_tpu.ops.nms import nms_numpy as jax_nms_numpy

from yololite_tpu_torch import native
from yololite_tpu_torch.eval import coco as port_coco
from yololite_tpu_torch.eval.evaluate import evaluate_model
from yololite_tpu_torch.ops.nms import nms_numpy

THRS = np.linspace(0.5, 0.95, 10)


def _random_boxes(rng, n, span=500.0, integral=False):
    cx, cy = rng.rand(2, n) * span
    w, h = rng.rand(2, n) * 80 + 5
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return (np.round(boxes) if integral else boxes).astype(np.float32)


def _tied_boxes():
    """Integral boxes whose IoU with box 0 is exactly 0.5 (above-threshold
    comparisons must not suppress them), exactly 1/3, and above 0.5; the
    scores tie in pairs, so the order among equal scores decides."""
    boxes = np.array([[0, 0, 30, 10],       # area 300
                      [10, 0, 40, 10],      # inter 200, union 400: IoU 0.5
                      [0, 0, 20, 10],       # inter 200, union 300: IoU 2/3
                      [15, 0, 45, 10],      # inter 150, union 450: IoU 1/3
                      [0, 0, 30, 10],       # identical to 0
                      [100, 100, 110, 110],
                      [100, 100, 110, 110],
                      [105, 100, 115, 110]], np.float32)
    scores = np.array([0.9, 0.9, 0.8, 0.8, 0.7, 0.5, 0.5, 0.5], np.float32)
    return boxes, scores


def test_native_library_builds():
    assert isinstance(native.library(), ctypes.CDLL)
    assert jax_native.available()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
def test_nms_equals_jax_and_plain(seed, thr):
    rng = np.random.RandomState(seed)
    boxes = _random_boxes(rng, 300, integral=seed % 2 == 1)
    scores = rng.rand(300).astype(np.float32)
    got = native.nms(boxes, scores, thr)
    np.testing.assert_array_equal(got, jax_native.nms_native(boxes, scores, thr))
    np.testing.assert_array_equal(got, native.nms_plain(boxes, scores, thr))
    np.testing.assert_array_equal(nms_numpy(boxes, scores, thr), got)
    assert got.dtype == np.int64 and 0 < len(got) < 300


@pytest.mark.parametrize("thr", [0.5, 1 / 3, 0.6])
def test_nms_ties_equal_jax_and_plain(thr):
    boxes, scores = _tied_boxes()
    got = native.nms(boxes, scores, thr)
    np.testing.assert_array_equal(got, jax_native.nms_native(boxes, scores, thr))
    np.testing.assert_array_equal(got, native.nms_plain(boxes, scores, thr))
    # JAX's nms_numpy takes its native kernel here, as the port's always does
    np.testing.assert_array_equal(nms_numpy(boxes, scores, thr), jax_nms_numpy(boxes, scores, thr))
    if thr == 0.5:      # IoU exactly 0.5 is not above the threshold: box 1 stays
        assert list(got[:2]) == [0, 1] and 2 not in got and 4 not in got


def test_nms_empty_and_single():
    assert native.nms(np.zeros((0, 4)), np.zeros(0), 0.5).shape == (0,)
    np.testing.assert_array_equal(native.nms(np.ones((1, 4)), np.ones(1), 0.5), [0])


def _box_iou(lib, a, b):
    """`yl_box_iou` of a ctypes library: xyxy a [n,4], b [m,4] -> [n,m]."""
    a, b = np.ascontiguousarray(a, np.float32), np.ascontiguousarray(b, np.float32)
    out = np.empty((len(a), len(b)), np.float32)
    p = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.yl_box_iou(p(a), len(a), p(b), len(b), p(out))
    return out


def _box_iou_plain(a, b):
    """The same fp32 operations in numpy, in the same order."""
    a, b = np.asarray(a, np.float32)[:, None], np.asarray(b, np.float32)[None]
    zero = np.float32(0)
    area_a = np.maximum(zero, a[..., 2] - a[..., 0]) * np.maximum(zero, a[..., 3] - a[..., 1])
    area_b = np.maximum(zero, b[..., 2] - b[..., 0]) * np.maximum(zero, b[..., 3] - b[..., 1])
    iw = np.maximum(zero, np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]))
    ih = np.maximum(zero, np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]))
    inter = iw * ih
    return inter / (area_a + area_b - inter + np.float32(1e-7))


@pytest.mark.parametrize("integral", [False, True])
def test_box_iou_equals_jax_and_plain(integral):
    rng = np.random.RandomState(7)
    a, b = _random_boxes(rng, 60, 200, integral), _random_boxes(rng, 45, 200, integral)
    port, jax_lib = native.library(), jax_native.get_lib()
    got = _box_iou(port, a, b)
    np.testing.assert_array_equal(got, _box_iou_plain(a, b))
    if integral:        # products and sums of integers are exact: FMA or not
        np.testing.assert_array_equal(got, _box_iou(jax_lib, a, b))
    else:               # JAX's -march=native build may contract into FMAs
        np.testing.assert_allclose(got, _box_iou(jax_lib, a, b), rtol=1e-6, atol=1e-7)
    boxes, _ = _tied_boxes()
    np.testing.assert_array_equal(_box_iou(port, boxes, boxes), _box_iou(jax_lib, boxes, boxes))
    assert _box_iou(port, boxes, boxes)[0, 1] == np.float32(0.5)


def _match_case(seed, d, g, n_ignored, tied):
    rng = np.random.RandomState(seed)
    ious = rng.rand(d, g)
    if tied:            # IoUs exactly at the thresholds, and equal across GTs
        ious = THRS[rng.randint(0, len(THRS), (d, g))]
        ious[:, 1::3] = ious[:, 0:1]
    ignore = np.zeros(g, np.uint8)
    if n_ignored:
        ignore[-n_ignored:] = 1         # ignored GTs sorted last
    return ious, ignore


@pytest.mark.parametrize("seed,d,g,n_ignored,tied", [
    (1, 30, 12, 3, False), (2, 50, 7, 0, False), (3, 20, 9, 9, False),
    (4, 40, 10, 2, True), (5, 12, 12, 0, True), (6, 1, 1, 0, False)])
def test_coco_match_equals_jax_and_plain(seed, d, g, n_ignored, tied):
    ious, ignore = _match_case(seed, d, g, n_ignored, tied)
    dtm, ig = native.coco_match(ious, ignore, THRS)
    jdtm, jig = jax_native.coco_match_native(ious, ignore, THRS)
    pdtm, pig = native.coco_match_plain(ious, ignore, THRS)
    for want_dtm, want_ig in ((jdtm, jig), (pdtm, pig)):
        np.testing.assert_array_equal(dtm, want_dtm)
        np.testing.assert_array_equal(ig, want_ig)
    assert dtm.dtype == np.int32 and ig.dtype == bool and dtm.shape == (10, d)
    assert (dtm > 0).any()


def test_coco_match_without_dets_or_gts():
    for d, g in ((0, 5), (5, 0)):
        dtm, ig = native.coco_match(np.zeros((d, g)), np.zeros(g, np.uint8), THRS)
        assert dtm.shape == (10, d) and not dtm.any() and not ig.any()


@pytest.mark.parametrize("shape", [(2, 32, 48, 3), (1, 640, 640, 3), (3, 6, 4, 5), (1, 2, 2, 1)])
def test_pack_s2d_equals_jax_and_plain(shape):
    x = (np.random.RandomState(0).rand(*shape) * 255).astype(np.uint8)
    got = native.pack_s2d(x)
    np.testing.assert_array_equal(got, jax_pack_s2d(x))
    np.testing.assert_array_equal(got, jax_native.pack_s2d_native(x))
    np.testing.assert_array_equal(got, native.pack_s2d_plain(x))
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 4 * shape[3])


def test_pack_s2d_refuses_odd_sizes_and_other_dtypes():
    with pytest.raises(ValueError, match="even"):
        native.pack_s2d(np.zeros((1, 3, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        native.pack_s2d(np.zeros((1, 4, 4, 3), np.float32))


class _FixedDetsTrainer:
    """Stands in for a Trainer: `eval_step` returns prepared detections."""

    def __init__(self, dets):
        self.dets = iter(dets)

    def put_batch(self, batch):
        return batch

    def eval_step(self, variables, batch, conf_th, iou_th, max_det):
        return {}, {k: torch.from_numpy(v) for k, v in next(self.dets).items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_model_cpp_matcher_equals_python(seed, tmp_path, monkeypatch):
    from test_torch_port_eval import random_batches
    batches = random_batches(seed)

    def run(tag):
        loader = [dict(gt, image=np.zeros((len(gt["boxes"]), 320, 320, 3), np.uint8),
                       nvalid=n) for gt, _, n in batches]
        trainer = _FixedDetsTrainer([det for _, det, _ in batches])
        return evaluate_model(trainer, None, loader, str(tmp_path / tag), num_classes=3,
                              img_size=320, run_bench=False)

    calls = []
    real = native.coco_match
    monkeypatch.setattr(native, "coco_match", lambda *a: calls.append(1) or real(*a))
    cpp = run("cpp")
    assert calls, "the evaluator did not reach the C++ matcher"
    monkeypatch.setattr(native, "coco_match", native.coco_match_plain)
    py = run("py")
    assert port_coco.native.coco_match is native.coco_match_plain
    for k, v in py["coco"].items():
        np.testing.assert_allclose(cpp["coco"][k], v, rtol=0, atol=1e-12, err_msg=k)
    assert cpp["best_f1"] == py["best_f1"] and cpp["coco"]["AP50"] > 0.1
