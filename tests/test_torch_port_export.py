"""The port's `.pt2` export (`deploy/export.py`, `deploy/infer_exported.py`,
`YoloLite.export`, the `yololite::nms_suppress` op) against the JAX
package's StableHLO export, on one checkpoint written by the JAX package
(edge_n at 64 px with randomized BatchNorm; its obj/cls head kernels scaled
by 100 so that scores spread over 0.01-0.16 and no two candidates tie
within the packages' fp32 rounding, which keeps top-k order comparable).
ONNX export is held in test_torch_port_onnx.py.

Tolerances and their reasons:
  - `.pt2` "raw"/"decoded" against JAX's StableHLO artifact: 1e-4 (fp32
    convolutions summed in other orders, as in test_torch_port_models.py);
  - `.pt2` "nms": `valid` and `classes` equal (exact greedy on both sides,
    scores apart by far more than the rounding), boxes and scores 1e-3;
  - the seg "nms" masks: 1e-4 (probabilities of the same fp32 logits);
  - host post-processing of equal outputs: equal (the same numpy code).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yololite_tpu.api import YoloLite as JaxYoloLite
from yololite_tpu.deploy import export as jax_export
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint

from tests.test_torch_port_models import edge_cfg, jax_edge
from tests.test_torch_port_seg_model import jax_seg, seg_cfg
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.deploy import export
from yololite_tpu_torch.deploy.infer_exported import infer_frame, postprocess_decoded
from yololite_tpu_torch.ops import cuda_nms

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from infer_exported import postprocess_decoded as jax_postprocess_decoded  # noqa: E402

IMG = 64
HEAD_SCALE = 100.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU graphs: the test files
    run in parallel processes, and torch's default of one thread a core in
    each of them oversubscribes the machine (8 frames at 128 px took 30 s
    instead of 0.3 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ckpt(path, params, bs, cfg):
    meta = build_meta(cfg, {}, "map", ["a", "b", "c"], (1, 1, 1))
    return save_checkpoint(str(path), params, bs, meta)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    _, params, bs = jax_edge(IMG)
    params = copy.deepcopy(params)
    for head in ("head3", "head4", "head5"):
        for part in ("obj", "cls"):
            params[head][part]["kernel"] = params[head][part]["kernel"] * HEAD_SCALE
    return _ckpt(tmp_path_factory.mktemp("ck") / "edge.ckpt", params, bs, edge_cfg(IMG))


@pytest.fixture(scope="module")
def seg_ckpt(tmp_path_factory):
    _, params, bs = jax_seg()
    return _ckpt(tmp_path_factory.mktemp("ck") / "seg.ckpt", params, bs, seg_cfg())


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("art"))


def _batch(n=2, seed=0):
    return (np.random.RandomState(seed).rand(n, IMG, IMG, 3) * 255).astype(np.uint8)


def _np(out):
    if isinstance(out, dict):
        return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()}
    return [np.asarray(v.detach() if isinstance(v, torch.Tensor) else v) for v in out]


_ARTIFACTS = {}


def _jax_artifact(ckpt, out_dir, fmt, **kw):
    key = ("jax", ckpt, fmt, tuple(sorted(kw.items())))
    if key not in _ARTIFACTS:
        path = jax_export.export_model(ckpt, out_dir=os.path.join(out_dir, "jax"),
                                       fmt=fmt, img_size=IMG, dtype=jnp.float32, **kw)
        _ARTIFACTS[key] = jax_export.load_exported(path)
    return _ARTIFACTS[key]


def _port_artifact(ckpt, out_dir, fmt, **kw):
    """(call, meta) of the port's fp32 CPU `.pt2`, exported once per test run."""
    key = ("port", ckpt, fmt, tuple(sorted(kw.items())))
    if key not in _ARTIFACTS:
        path = export.export_model(ckpt, out_dir=out_dir, fmt=fmt, img_size=IMG,
                                   dtype=torch.float32, device="cpu", **kw)
        assert path.endswith(f"_{fmt}.pt2") and os.path.exists(path + ".json")
        _ARTIFACTS[key] = export.load_exported(path)
    return _ARTIFACTS[key]


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,k", [(1, 1), (2, 40), (3, 130)])
def test_nms_suppress_op(b, k):
    """The registered op: opcheck on CPU tensors (schema, fake tensor,
    autograd registration, AOT dispatch), and its keep mask equal to the
    plain version; a meta tensor still raises in the wrapper."""
    rng = np.random.RandomState(k)
    xy = rng.rand(b, k, 2).astype(np.float32) * 100
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.rand(b, k, 2).astype(
        np.float32) * 40 + 1], -1))
    valid = torch.from_numpy(rng.rand(b, k) > 0.2)
    result = torch.library.opcheck(torch.ops.yololite.nms_suppress.default,
                                   (boxes, valid, 0.5))
    assert set(result.values()) == {"SUCCESS"}
    keep = cuda_nms.greedy_keep(boxes, valid, 0.5)
    assert torch.equal(keep, cuda_nms.greedy_keep_reference(boxes, valid, 0.5))
    assert keep.data_ptr() != valid.data_ptr()
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_nms.greedy_keep(boxes.to("meta"), valid.to("meta"), 0.5)


@pytest.mark.parametrize("fmt", ["raw", "decoded", "nms"])
def test_pt2_matches_jax(ckpt, out_dir, fmt):
    x = _batch(1)
    call, meta = _port_artifact(ckpt, out_dir, fmt)
    jcall, jmeta = _jax_artifact(ckpt, out_dir, fmt)
    for key in ("format", "img_size", "batch", "conf", "iou", "max_det", "names",
                "num_classes", "letterbox", "normalize"):
        assert meta[key] == jmeta[key], key
    before = cuda_nms.LAUNCHES
    got, want = _np(call(x)), _np(jcall(x))
    assert cuda_nms.LAUNCHES == before           # on the CPU: the plain version
    if fmt == "decoded":
        assert list(got) == sorted(want) == meta["outputs"]
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    elif fmt == "raw":
        assert len(got) == len(want) == len(meta["outputs"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    else:
        boxes, scores, classes, valid = got
        assert valid.sum() > 10 and meta["outputs"] == ["boxes", "scores", "classes",
                                                        "valid"]
        np.testing.assert_array_equal(valid, want[3])
        np.testing.assert_array_equal(classes, want[2])
        np.testing.assert_allclose(boxes, want[0], atol=1e-3)
        np.testing.assert_allclose(scores, want[1], atol=1e-3)


def test_seg_pt2_decoded_and_nms(seg_ckpt, out_dir):
    """As JAX's test_stablehlo_seg_decoded_and_nms: "decoded" carries
    mask_coef and protos, "nms" the in-graph masks, and the host assembly
    from "decoded" equals the in-graph masks; each against JAX's artifact."""
    from yololite_tpu_torch.ops.masks import assemble_masks_np
    x = _batch(1, seed=4)
    call, meta = _port_artifact(seg_ckpt, out_dir, "decoded")
    out = _np(call(x))
    want = _np(_jax_artifact(seg_ckpt, out_dir, "decoded")[0](x))
    assert list(out) == sorted(want) == meta["outputs"]
    for key in want:
        np.testing.assert_allclose(out[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    n, k = out["boxes_xyxy"].shape[1], out["mask_coef"].shape[-1]
    assert out["mask_coef"].shape == (1, n, k) and out["protos"].shape[-1] == k
    kw = dict(conf=0.0, iou=0.65, max_det=10)
    call2, meta2 = _port_artifact(seg_ckpt, out_dir, "nms", **kw)
    b, s, c, v, masks = _np(call2(x))
    assert meta2["outputs"][-1] == "masks" and masks.shape[:2] == (1, 10)
    jb, js, jc, jv, jmasks = _np(_jax_artifact(seg_ckpt, out_dir, "nms", **kw)[0](x))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(b, jb, atol=1e-3)
    np.testing.assert_allclose(masks, jmasks, atol=1e-4)
    kept = v[0].astype(bool)
    assert kept.any()
    bx = b[0][kept]
    idx = [int(np.argmin(np.abs(out["boxes_xyxy"][0] - bb).sum(1))) for bb in bx]
    host = assemble_masks_np(out["protos"][0], out["mask_coef"][0][idx], bx, float(IMG))
    np.testing.assert_allclose(host, masks[0][kept], atol=2e-3)


def test_host_postprocess_matches_jax(ckpt, out_dir):
    """postprocess_decoded equals JAX's tools/infer_exported.py on equal
    outputs; infer_frame on the "decoded" and "nms" artifacts gives the same
    detections in frame pixels."""
    dec, meta = _port_artifact(ckpt, out_dir, "decoded")
    x = _batch(1, seed=5)
    out = _np(dec(x))
    for conf, iou, max_det in ((0.001, 0.45, 300), (0.05, 0.65, 20)):
        got = postprocess_decoded(out, conf, iou, max_det)
        want = jax_postprocess_decoded(out, conf, iou, max_det)
        assert len(got[0]) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    nms, nmeta = _port_artifact(ckpt, out_dir, "nms")
    frame = np.ascontiguousarray(np.random.RandomState(6).rand(48, 64, 3) * 255,
                                 dtype=np.uint8)
    a = infer_frame(dec, meta, frame, conf=0.05, iou=nmeta["iou"])
    b = infer_frame(nms, nmeta, frame, conf=0.05)
    assert len(a["boxes"]) == len(b["boxes"]) > 0 and a["masks"] is None
    order = np.argsort(-a["scores"], kind="stable")
    np.testing.assert_allclose(a["boxes"][order], b["boxes"], atol=1e-3)
    np.testing.assert_array_equal(a["classes"][order], b["classes"])
    assert (b["boxes"][:, 3] <= 47).all() and set(a["speed"]) == {
        "preprocess_ms", "inference_ms", "postprocess_ms"}


def test_yololite_export_maps_onnx_to_decoded_like_jax(ckpt, out_dir):
    """`format="onnx"` is the "decoded" artifact in both packages (JAX's
    StableHLO, the port's `.pt2`), not an ONNX file."""
    path = YoloLite(ckpt, device="cpu").export(format="onnx", img_size=IMG,
                                               dtype=torch.float32)
    jpath = JaxYoloLite(ckpt).export(format="onnx", img_size=IMG, dtype=jnp.float32)
    assert path.endswith("_decoded.pt2") and jpath.endswith("_decoded.stablehlo")
    call, meta = export.load_exported(path)
    assert meta["format"] == "decoded" and meta["device"] == "cpu"
    x = _batch(1, seed=7)
    got = _np(call(x))
    want = _np(_jax_artifact(ckpt, os.path.dirname(path), "decoded")[0](x))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
