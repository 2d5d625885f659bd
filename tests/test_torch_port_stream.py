"""The port's streaming predictor (`Predictor.infer_stream`) and the tracker
over it, against its own `infer_image` and against the JAX package, on one
checkpoint written by the JAX package (edge_n at 128 px, randomized
BatchNorm; a narrow seg variant at 64 px).

Frames are 96x128 (64x48 for the seg model): the letterbox only pads, so
both packages see the same pixels. The port against itself is exact (the
same graph on the same CPU). The port against JAX uses the Predictor tests'
tolerances: one to one, same class, box within 1e-3 px, score within 1e-5
(fp32 forward rounding), at conf 0.001, where JAX's suppression is exact.
Tracks over the two packages' detections: ids and classes equal, boxes
within 1e-2 px (the filter carries the detections' 1e-3 px apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yololite_tpu.deploy.predictor import Predictor as JaxPredictor
from yololite_tpu.track import KalmanSortTracker as JaxTracker
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint

from tests.test_torch_port_models import edge_cfg, jax_edge
from tests.test_torch_port_export import one_torch_thread  # noqa: F401 fixture
from tests.test_torch_port_seg_model import jax_seg, seg_cfg
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.ops import cuda_nms
from yololite_tpu_torch.track import KalmanSortTracker

IMG = 128
CONF, IOU = 0.001, 0.45


def clip(n=8, h=96, w=128, seed=0):
    """BGR frames: rectangles moving at constant velocity over noise."""
    rng = np.random.RandomState(seed)
    pos = rng.rand(3, 2) * [w - 40, h - 30]
    vel = rng.randn(3, 2) * 3
    colour = rng.randint(60, 255, (3, 3))
    frames = []
    for t in range(n):
        f = (rng.rand(h, w, 3) * 40).astype(np.uint8)
        for p, v, c in zip(pos, vel, colour):
            x, y = (p + v * t).clip(0, [w - 30, h - 20]).astype(int)
            f[y:y + 20, x:x + 30] = c
        frames.append(f)
    return frames


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    _, params, bs = jax_edge(IMG)
    meta = build_meta(edge_cfg(IMG), {}, "map", ["a", "b", "c"], (1, 1, 1))
    return save_checkpoint(str(tmp_path_factory.mktemp("ck") / "edge_n.ckpt"),
                           params, bs, meta)


@pytest.fixture(scope="module")
def port(ckpt):
    return Predictor(ckpt, device="cpu", dtype=torch.float32)


def _match(got, want, box_tol=1e-3, score_tol=1e-5):
    """Indices into `want` of each detection of `got`, one to one."""
    wb, ws, wc = (np.asarray(want[k]) for k in ("boxes", "scores", "classes"))
    assert len(got["boxes"]) == len(wb)
    order, free = [], list(range(len(wb)))
    for b, s, c in zip(got["boxes"], got["scores"], got["classes"]):
        hit = [j for j in free if wc[j] == c and np.abs(wb[j] - b).max() <= box_tol
               and abs(ws[j] - s) <= score_tol]
        assert hit, f"no JAX detection matches class {c} box {b} score {s}"
        order.append(hit[0])
        free.remove(hit[0])
    return order


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_stream_equals_infer_image(port, depth):
    frames = clip()
    before = cuda_nms.LAUNCHES
    out = list(port.infer_stream(iter(frames), conf=CONF, iou=IOU, depth=depth))
    assert len(out) == len(frames)
    for r, f in zip(out, frames):
        b, s, c = port.infer_image(f, conf=CONF, iou=IOU)
        assert len(b) > 0
        np.testing.assert_array_equal(r["boxes"], b)
        np.testing.assert_array_equal(r["scores"], s)
        np.testing.assert_array_equal(r["classes"], c)
        assert set(r) == {"boxes", "scores", "classes", "names", "speed"}
        assert set(r["speed"]) == {"preprocess_ms", "sync_ms"}
        assert r["names"] == ["a", "b", "c"]
    assert cuda_nms.LAUNCHES == before        # CPU tensors: the plain version


def test_stream_matches_jax_and_tracks_alike(ckpt, port):
    frames = clip(n=10, seed=1)
    ref = JaxPredictor(ckpt, dtype=jnp.float32)
    got = list(port.infer_stream(frames, conf=CONF, iou=IOU, depth=2))
    want = list(ref.infer_stream(frames, conf=CONF, iou=IOU, depth=2))
    assert len(got) == len(want) == len(frames)
    ours, theirs = KalmanSortTracker(), JaxTracker()
    n_tracks = 0
    for g, w in zip(got, want):
        order = _match(g, w)
        assert set(g) == set(w) and set(g["speed"]) == set(w["speed"])
        # the tracker takes the port's 12 best and their JAX matches, in one
        # order (this seeded net's scores are near-equal, so a threshold
        # would split pairs)
        sel = np.arange(min(12, len(order)))
        wsel = np.asarray(order)[sel]
        tg = ours.update(g["boxes"][sel], g["scores"][sel], g["classes"][sel])
        tw = theirs.update(np.asarray(w["boxes"])[wsel], np.asarray(w["scores"])[wsel],
                           np.asarray(w["classes"])[wsel])
        assert [t["track_id"] for t in tg] == [t["track_id"] for t in tw]
        assert [t["cls"] for t in tg] == [t["cls"] for t in tw]
        for a, b in zip(tg, tw):
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=1e-2)
        n_tracks = max(n_tracks, len(tg))
    assert n_tracks > 0


def test_seg_stream_drops_masks_in_both(tmp_path):
    _, params, bs = jax_seg()
    meta = build_meta(seg_cfg(), {}, "map", ["a", "b", "c"], (1, 1, 1))
    ck = save_checkpoint(str(tmp_path / "seg.ckpt"), params, bs, meta)
    frames = clip(n=4, h=48, w=64, seed=2)
    port = Predictor(ck, device="cpu", dtype=torch.float32)
    ref = JaxPredictor(ck, dtype=jnp.float32)
    got = list(port.infer_stream(frames, conf=0.3, depth=1))
    want = list(ref.infer_stream(frames, conf=0.3, depth=1))
    assert sum(len(g["boxes"]) for g in got) > 0
    for g, w, f in zip(got, want, frames):
        assert "masks" not in g and "masks" not in w
        _match(g, w)
        single = port.infer_image_profiled(f, conf=0.3)
        assert single["masks"] is not None          # infer_image keeps them
        np.testing.assert_array_equal(g["boxes"], single["boxes"])
