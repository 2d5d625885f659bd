"""PyTorch port parity, the segmentation model and its serving path: the seg
detector (mask-coefficient heads, ProtoNet), its weights both ways, the
fused head, fold-norm, the Predictor's masks and `YoloLite.predict`, against
the JAX package on the same checkpoint (CPU, fp32).

The model is edge_n_seg's topology at FPN width 32 with K = 8 prototypes,
at 64 px, with random variables that keep its outputs O(0.1..1)
(tests/test_torch_port_zoo.py: `random_vars`).

Tolerances, each with its reason:
  - level outputs and prototypes: rtol = atol = 1e-4 (fp32 convolutions
    summed in another order; see tests/test_torch_port_models.py);
  - weights both ways: exact, and a checkpoint the port writes back is
    byte-identical to JAX's;
  - Predictor: detections one to one (boxes 1e-3 px, scores 1e-5); the
    binarized frame masks differ on at most 1e-3 of the pixels (the
    assembled probabilities are fp32 matmuls in another order, so a value
    within ~1e-6 of 0.5 may fall on either side; frames that the letterbox
    resizes would add cv2's 1-level uint8 resize difference at the input,
    so the frames here need none).
"""

import functools

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.deploy.fold_norm import fold_normalization as jax_fold
from yololite_tpu.deploy.fuse_head import fuse_head_params as jax_fuse
from yololite_tpu.deploy.predictor import Predictor as JaxPredictor
from yololite_tpu.models.detector import build_model_from_config as jax_build
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint

from tests.test_torch_port_models import EDGE_N
from tests.test_torch_port_zoo import nhwc, random_vars
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.convert import from_flax, load_flax, to_flax
from yololite_tpu_torch.deploy.fold_norm import fold_normalization
from yololite_tpu_torch.deploy.fuse_head import fuse_head_params
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.models.detector import build_model_from_config, init_weights
from yololite_tpu_torch.train.checkpoint import load_checkpoint
from yololite_tpu_torch.train.checkpoint import save_checkpoint as port_save_checkpoint

IMG = 64
SEG = dict(EDGE_N, fpn_channels=54, with_masks=True, num_prototypes=8)   # FPN 32
PIXEL_SHARE = 1e-3


def seg_cfg(**model):
    return {"model": dict(SEG, **model), "training": {"img_size": IMG}}


@functools.lru_cache(maxsize=None)
def jax_seg(fused: bool = False):
    """(flax model, params, batch_stats); the proto_out bias is raised so
    that the assembled masks are not empty."""
    m = jax_build(seg_cfg(), dtype=jnp.float32)
    params, bs = random_vars(m, nhwc(2, IMG, 3))
    params["protonet"]["proto_out"]["bias"] = np.full(8, 0.5, np.float32)
    if fused:
        params, _ = jax_fuse(params)
        m = jax_build(seg_cfg(), dtype=jnp.float32).clone(fused_head=True)
    return m, params, bs


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    _, params, bs = jax_seg()
    meta = build_meta(seg_cfg(), {}, "map", ["a", "b", "c"], (1, 1, 1))
    return save_checkpoint(str(tmp_path_factory.mktemp("ck") / "seg.ckpt"), params, bs, meta)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_seg_detector_and_protos_match_jax(fused):
    m, params, bs = jax_seg(fused)
    x = nhwc(2, IMG, 3)
    outs, protos = jax.jit(lambda v, x: m.apply(v, x, train=False))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))
    if fused:
        _, p0, _ = jax_seg()
        sd, ok = fuse_head_params(from_flax(p0, bs))
        assert ok and "head3.fused_out.weight" in sd and "head3.mcoef.weight" not in sd
        port = build_model_from_config(seg_cfg(), fused_head=True)
        port.load_state_dict(sd)
    else:
        port = load_flax(build_model_from_config(seg_cfg()), params, bs)
    with torch.no_grad():
        got, got_p = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got_p.shape == (2, 16, 16, 8) and got[0].shape == (2, 1, 8, 8, 5 + 3 + 8)
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(protos), rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(protos)).max() > 0.1
    # the coefficients are tanh'd
    assert np.abs(got[0][..., 8:].numpy()).max() <= 1.0


def test_seg_weights_both_ways_and_fold(ckpt, tmp_path):
    sd, meta = load_checkpoint(ckpt)
    port = load_flax(build_model_from_config(meta["config"]), sd["params"], sd["batch_stats"])
    params, stats = to_flax(port)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(sd["params"])):
        np.testing.assert_array_equal(a, b)
    back = port_save_checkpoint(str(tmp_path / "back.ckpt"), params, stats, meta)
    with open(back, "rb") as f, open(ckpt, "rb") as g:
        assert f.read() == g.read()
    # fold-norm touches the stem only; ProtoNet and the heads pass through
    folded, ok = fold_normalization(port.state_dict())
    jp, _, jok = jax_fold(sd["params"], sd["batch_stats"])
    assert ok and jok
    for k, v in port.state_dict().items():
        if k.startswith(("protonet.", "head")):
            assert torch.equal(folded[k], v), k
    for a, b in zip(jax.tree.leaves(jp["protonet"]), jax.tree.leaves(sd["params"]["protonet"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    # seeded init: mask coefficient and prototype biases start at 0
    seeded = init_weights(build_model_from_config(seg_cfg()), 0)
    assert not seeded.head3.mcoef.bias.any() and not seeded.protonet.proto_out.bias.any()


def _frames():
    rng = np.random.RandomState(0)
    # letterboxed without a resize (the pads: 8 rows, 12 columns a side), so
    # both packages see the same pixels; the masks are cropped and resized
    return [(rng.rand(48, 64, 3) * 255).astype(np.uint8),
            (rng.rand(64, 40, 3) * 255).astype(np.uint8)]


def _assert_same_dets_and_masks(got, want):
    """Detections one to one (near-equal scores may come in another order),
    then each matched pair's frame mask."""
    wb, ws, wc = (np.asarray(want[k]) for k in ("boxes", "scores", "classes"))
    assert len(got["boxes"]) == len(wb) > 0
    order, free = [], list(range(len(wb)))
    for b, s, c in zip(got["boxes"], got["scores"], got["classes"]):
        hit = [j for j in free if wc[j] == c and np.abs(wb[j] - b).max() <= 1e-3
               and abs(ws[j] - s) <= 1e-5]
        assert hit, f"no JAX detection matches class {c} box {b} score {s}"
        order.append(hit[0])
        free.remove(hit[0])
    gm, wm = got["masks"], want["masks"][order]
    assert gm.dtype == np.uint8 and gm.shape == wm.shape
    assert wm.sum() >= 200 and wm.any(axis=(1, 2)).mean() > 0.5    # not empty
    assert (gm != wm).mean() <= PIXEL_SHARE


def test_predictor_masks_match_jax(ckpt):
    port = Predictor(ckpt, device="cpu", dtype=torch.float32)
    ref = JaxPredictor(ckpt, dtype=jnp.float32)
    assert port.with_masks
    frames = _frames()
    for f in frames:
        got = port.infer_image_profiled(f, conf=0.3)
        _assert_same_dets_and_masks(got, ref.infer_image_profiled(f, conf=0.3))
        assert got["masks"].shape[1:] == f.shape[:2]
    for g, w in zip(port.infer_batch(frames, conf=0.3), ref.infer_batch(frames, conf=0.3)):
        _assert_same_dets_and_masks(g, w)


def test_batched_stream_drops_the_masks(ckpt):
    """As in JAX, `infer_batched_stream` serves boxes only (the masks are
    assembled in the graph and dropped)."""
    port = Predictor(ckpt, device="cpu", dtype=torch.float32)
    canvases = np.zeros((2, IMG, IMG, 3), np.uint8)
    out = [r for b in port.infer_batched_stream([canvases], conf=0.3, prepared=True)
           for r in b]
    assert len(out) == 2 and all(r["masks"] is None for r in out)
    full = port._run(IMG, 0.3, 0.45, 300, canvases)
    assert len(full) == 5 and full[4].shape == (2, 300, 16, 16)


def test_yololite_segment_predicts_masks_from_png(ckpt, tmp_path):
    """YoloLite(task="segment").predict on a PNG path against JAX's
    YoloLite.predict on the same file (both Predictors in fp32)."""
    from yololite_tpu.api import YoloLite as JaxYoloLite
    frame = _frames()[0]
    cv2.imwrite(str(tmp_path / "f.png"), frame)
    model = YoloLite(ckpt, device="cpu", task="segment")
    assert model.task == "segment"
    model._predictor = Predictor(ckpt, device="cpu", dtype=torch.float32)
    ref = JaxYoloLite(ckpt, task="segment")
    ref._predictor = JaxPredictor(ckpt, dtype=jnp.float32)
    r = model.predict(str(tmp_path / "f.png"), conf=0.3)[0]
    assert r["masks"].dtype == np.uint8 and r["masks"].shape == (len(r["boxes"]), 48, 64)
    assert r["source"] == str(tmp_path / "f.png")
    _assert_same_dets_and_masks(r, ref.predict(str(tmp_path / "f.png"), conf=0.3)[0])
