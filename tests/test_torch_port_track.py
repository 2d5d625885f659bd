"""The port's SORT tracker (`yololite_tpu_torch/track/kalman.py`) against
JAX's (`yololite_tpu/track/kalman.py`) on seeded detection sequences.

Both are the same fp32 numpy code, so every comparison is exact: per frame
the reported track ids, boxes, classes and scores, and after every frame
the filter state (means, covariances, ids, hits, ages).
"""

import numpy as np
import pytest

from yololite_tpu.track import kalman as jax_kalman
from yololite_tpu_torch.track import kalman
from yololite_tpu_torch.track import KalmanSortTracker


def _box(cx, cy, w, h):
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def _moving(rng, n_frames, n_obj, noise=1.0, classes=3, drop=0.0):
    """n_obj objects at constant velocity with box jitter; each detection
    is dropped with probability `drop`."""
    start = rng.rand(n_obj, 2) * 400 + 50
    vel = rng.randn(n_obj, 2) * 4
    size = rng.rand(n_obj, 2) * 60 + 20
    cls = rng.randint(0, classes, n_obj)
    frames = []
    for t in range(n_frames):
        keep = rng.rand(n_obj) >= drop
        c = start + vel * t + rng.randn(n_obj, 2) * noise
        boxes = [_box(*c[i], *size[i]) for i in range(n_obj) if keep[i]]
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4),
                       rng.rand(int(keep.sum())).astype(np.float32) * 0.5 + 0.5,
                       cls[keep]))
    return frames


def _births(rng):
    # objects appear one by one at frames 0, 3, 6, ...
    full = _moving(rng, 20, 5)
    return [(b[:1 + t // 3], s[:1 + t // 3], c[:1 + t // 3]) for t, (b, s, c)
            in enumerate(full)], {}


def _deaths(rng):
    # an object vanishes for max_age + 1 frames and comes back: a new id;
    # another vanishes for max_age frames and keeps its id
    full = _moving(rng, 30, 2, noise=0.5)
    out = []
    for t, (b, s, c) in enumerate(full):
        m = np.ones(len(b), bool)
        m[0] = not 5 <= t < 5 + 4          # gone 4 frames > max_age 3
        m[1] = not 12 <= t < 12 + 3        # gone 3 frames == max_age
        out.append((b[m], s[m], c[m]))
    return out, {"max_age": 3}


def _min_hits(rng):
    return _moving(rng, 12, 4, drop=0.3), {"min_hits": 4}


def _class_gating(rng, match_by_class):
    # two overlapping objects of different classes at one place, their
    # detections listed in alternating order
    out = []
    for t in range(12):
        a = _box(200 + t, 200, 60, 60)
        b = _box(205 + t, 203, 58, 62)
        boxes = np.asarray([a, b] if t % 2 else [b, a], np.float32)
        classes = np.asarray([0, 1] if t % 2 else [1, 0])
        out.append((boxes + rng.randn(2, 4).astype(np.float32), np.full(2, 0.9, np.float32),
                    classes))
    return out, {"match_by_class": match_by_class}


def _crossing(rng):
    # two objects of one class crossing paths
    out = []
    for t in range(30):
        a = _box(100 + 10 * t, 200, 50, 50)
        b = _box(400 - 10 * t, 205, 50, 50)
        out.append((np.asarray([a, b], np.float32) + rng.randn(2, 4).astype(np.float32) * 0.3,
                    np.asarray([0.8, 0.7], np.float32), np.asarray([2, 2])))
    return out, {}


def _empty_frames(rng):
    full = _moving(rng, 24, 3)
    return [f if t % 4 else (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                             np.zeros(0, np.int64)) for t, f in enumerate(full)], {}


def _none_inputs(rng):
    # None / empty arguments mean "no detections" (and default scores/classes)
    frames = _moving(rng, 8, 2)
    out = []
    for t, (b, s, c) in enumerate(frames):
        out.append((None, None, None) if t == 3 else (b, s if t % 2 else None, c))
    return out, {"iou_threshold": 0.2}


SCENARIOS = {
    "births": _births,
    "deaths_at_max_age": _deaths,
    "min_hits": _min_hits,
    "class_gating_on": lambda rng: _class_gating(rng, True),
    "class_gating_off": lambda rng: _class_gating(rng, False),
    "crossing": _crossing,
    "motion_many": lambda rng: (_moving(rng, 40, 12, noise=2.0, drop=0.1), {}),
    "empty_frames": _empty_frames,
    "none_inputs": _none_inputs,
}


def _same_state(port, ref):
    for name in ("X", "P", "ids", "cls", "score", "hits", "age", "tsu"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert len(port) == len(ref)


def _same_output(got, want):
    assert [o["track_id"] for o in got] == [o["track_id"] for o in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
        assert g["cls"] == w["cls"] and g["score"] == w["score"]
        assert g["bbox"].dtype == w["bbox"].dtype == np.float32


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tracker_matches_jax(scenario):
    rng = np.random.RandomState(sorted(SCENARIOS).index(scenario))
    frames, kw = SCENARIOS[scenario](rng)
    port, ref = KalmanSortTracker(**kw), jax_kalman.KalmanSortTracker(**kw)
    reported = set()
    for boxes, scores, classes in frames:
        got = port.update(boxes, scores, classes)
        want = ref.update(boxes, scores, classes)
        _same_output(got, want)
        _same_state(port, ref)
        np.testing.assert_array_equal(port.track_boxes(), ref.track_boxes())
        reported |= {o["track_id"] for o in got}
    assert reported or scenario == "min_hits"
    if scenario == "deaths_at_max_age":
        assert max(reported) == 3        # object 0 came back under a third id
    # reset: ids restart, and the second pass equals JAX's second pass
    port.reset()
    ref.reset()
    assert len(port) == 0 and port._next_id == 1
    for boxes, scores, classes in frames[:6]:
        _same_output(port.update(boxes, scores, classes), ref.update(boxes, scores, classes))
    _same_state(port, ref)


def test_measurement_round_trip_and_iou_match_jax():
    rng = np.random.RandomState(3)
    xy = rng.rand(50, 2).astype(np.float32) * 500
    wh = rng.rand(50, 2).astype(np.float32) * 80 + 1
    boxes = np.concatenate([xy, xy + wh], 1)
    z = kalman.xyxy_to_cxsysr(boxes)
    np.testing.assert_array_equal(z, jax_kalman.xyxy_to_cxsysr(boxes))
    back = kalman.cxsysr_to_xyxy(z)
    np.testing.assert_array_equal(back, jax_kalman.cxsysr_to_xyxy(z))
    np.testing.assert_allclose(back, boxes, rtol=1e-5, atol=1e-3)   # fp32 sqrt round trip
    np.testing.assert_array_equal(kalman.iou_xyxy(boxes[:20], boxes[10:]),
                                  jax_kalman.iou_xyxy(boxes[:20], boxes[10:]))
    np.testing.assert_array_equal(np.diag(kalman.iou_xyxy(boxes, boxes)), np.ones(50, np.float32))
    assert kalman.iou_xyxy(boxes[:0], boxes).shape == (0, 50)
    degenerate = np.zeros((2, 4), np.float32)          # zero-area boxes: union 0 -> IoU 0
    np.testing.assert_array_equal(kalman.iou_xyxy(degenerate, degenerate),
                                  jax_kalman.iou_xyxy(degenerate, degenerate))
