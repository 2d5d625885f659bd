"""The port's first-party ONNX export (`deploy/export.export_onnx`,
`deploy/onnx_emit.py`, and its own copies of `onnx_proto.py` and
`onnx_run.py`) against the JAX package's, on the checkpoint of
test_torch_port_export.py (written by the JAX package).

Tolerances and their reasons:
  - outputs against JAX's ONNX file's: 1e-3, the bound of JAX's own
    `test_export_onnx_decoded_parity` (the port folds BatchNorm into the
    convs; JAX writes it out);
  - the same file in the port's runner and in JAX's: both within that bound;
    JAX's file in the port's runner: equal (the same numpy code);
  - the emitter on one backbone per family against eager: 1e-3 of the
    outputs' scale, as JAX's `test_emit_diverse_backbones`;
  - the protobuf codec: equal bytes and messages.
"""

import os

import numpy as np
import pytest
import torch

from yololite_tpu.deploy import export as jax_export
from yololite_tpu.deploy import onnx_proto as jax_proto
from yololite_tpu.deploy.onnx_run import load_onnx as jax_load_onnx

from tests.test_torch_port_export import (  # noqa: F401 fixtures
    IMG, _batch, ckpt, one_torch_thread, out_dir)
from yololite_tpu_torch.deploy import export, onnx_proto
from yololite_tpu_torch.deploy.onnx_emit import export_program_to_onnx
from yololite_tpu_torch.deploy.onnx_run import load_onnx
from yololite_tpu_torch.models.backbones.zoo import build_backbone


_JAX_FILES = {}


def _jax_onnx(ckpt, out_dir, fmt):
    """JAX's dynamic-batch ONNX file of `fmt`, written once per test run (its
    emitter is the slow part of this file); it serves batch 1 and 3."""
    if (ckpt, fmt) not in _JAX_FILES:
        _JAX_FILES[ckpt, fmt] = jax_export.export_onnx(
            ckpt, out_dir=os.path.join(out_dir, "jax"), fmt=fmt, img_size=IMG,
            dynamic_batch=True)
    return _JAX_FILES[ckpt, fmt]


@pytest.mark.parametrize("fmt", ["raw", "decoded"])
def test_onnx_matches_jax_in_both_runners(ckpt, out_dir, fmt):
    path = export.export_onnx(ckpt, out_dir=out_dir, fmt=fmt, img_size=IMG)
    jpath = _jax_onnx(ckpt, out_dir, fmt)
    call, meta = export.load_exported(path)
    assert meta["runtime"] == "onnx" and meta["batch"] == 1 and meta["outputs"] == \
        jax_export.load_exported(jpath)[1]["outputs"]
    x = _batch(1, seed=1)
    want = jax_load_onnx(jpath)(x)
    for runner in (load_onnx(path), jax_load_onnx(path)):     # the port's file
        for g, w in zip(runner(x), want):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)
    for g, w in zip(load_onnx(jpath)(x), want):                 # JAX's file, our runner
        np.testing.assert_array_equal(g, w)
    got = call(x)
    assert isinstance(got, dict) == (fmt == "decoded")
    ops = load_onnx(path).summary()["ops"]
    assert "BatchNormalization" not in ops and ops.get("Conv", 0) > 10


@pytest.mark.parametrize("fmt", ["raw", "decoded"])
def test_onnx_dynamic_batch(ckpt, out_dir, fmt):
    path = export.export_onnx(ckpt, out_dir=os.path.join(out_dir, "dyn"), fmt=fmt,
                              img_size=IMG, dynamic_batch=True)
    jpath = _jax_onnx(ckpt, out_dir, fmt)
    with open(path, "rb") as f:
        model = onnx_proto.parse_model(f.read())
    for vi in model["graph"]["input"] + model["graph"]["output"]:
        assert vi["type"]["tensor_type"]["shape"]["dim"][0].get("dim_param") == "batch"
    assert export.load_exported(path)[1]["batch"] == "dynamic"
    for b in (1, 3):
        x = _batch(b, seed=b)
        want = jax_load_onnx(jpath)(x)
        for runner in (load_onnx(path), jax_load_onnx(path)):
            got = runner(x)
            assert all(g.shape[0] == b for g in got)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_onnx_gates_and_unmapped_ops(ckpt, out_dir, tmp_path):
    with pytest.raises(ValueError, match="raw'/'decoded"):
        export.export_onnx(ckpt, out_dir=out_dir, fmt="nms")
    with pytest.raises(ValueError):
        jax_export.export_onnx(ckpt, out_dir=out_dir, fmt="nms")
    # TFLite export is ported: its "raw" file gives the ONNX file's maps
    tfl, _ = export.load_exported(export.export_tflite(
        ckpt, out_dir=os.path.join(out_dir, "tfl"), fmt="raw", img_size=IMG))
    onnx_raw = load_onnx(export.export_onnx(ckpt, out_dir=os.path.join(out_dir, "tfl"),
                                            fmt="raw", img_size=IMG))
    x = _batch(1, seed=9)
    for g, w in zip(tfl(x), onnx_raw(x)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)

    class Cumsum(torch.nn.Module):
        def forward(self, x):
            return torch.cumsum(x, 1)
    program = torch.export.export(Cumsum(), (torch.ones(2, 3),))
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        export_program_to_onnx(program, str(tmp_path / "c.onnx"), input_names=["x"],
                               output_names=["y"])


@pytest.mark.parametrize("name", ["tf_efficientnetv2_b0", "cs3darknet_focus_m",
                                  "convnextv2_tiny"])
def test_emitter_covers_backbone_families(name, tmp_path):
    """SE gates and SiLU (EfficientNetV2-B0), the Focus stem's strided
    slices (CS3Darknet), GELU(tanh), LayerNorm, linear and GRN
    (ConvNeXtV2), with BatchNorm statistics from one forward so that the
    outputs keep their scale through the depth."""
    from chip_smoke import calibrate_batchnorm
    from yololite_tpu_torch.models.detector import init_weights
    bb = init_weights(build_backbone(name)[0], 0)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, IMG, IMG).astype(np.float32))
    calibrate_batchnorm(bb, x)
    bb.eval()
    with torch.no_grad():
        ref = [r.numpy() for r in bb(x)]
        program = torch.export.export(bb, (x,))
    path = export_program_to_onnx(program, str(tmp_path / f"{name}.onnx"),
                                  input_names=["images"],
                                  output_names=[f"f{i}" for i in range(len(ref))])
    for runner in (load_onnx(path), jax_load_onnx(path)):
        outs = runner(x.numpy())
        assert len(outs) == len(ref)
        for o, r in zip(outs, ref):
            scale = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(o, r, rtol=1e-3, atol=1e-3 * scale, err_msg=name)


def test_onnx_proto_round_trips_and_parses_jax_files(ckpt, out_dir):
    jpath = _jax_onnx(ckpt, out_dir, "decoded")
    with open(jpath, "rb") as f:
        data = f.read()
    model = onnx_proto.parse_model(data)
    assert model == jax_proto.parse_model(data)
    assert onnx_proto.serialize_model(model) == jax_proto.serialize_model(model)
    again = onnx_proto.parse_model(onnx_proto.serialize_model(model))
    assert again == model and again["opset_import"][0]["version"] == 17
    arr = np.arange(-6, 6, dtype=np.float32).reshape(3, 4)
    t = onnx_proto.tensor_to_array(onnx_proto.tensor_proto("w", arr))
    np.testing.assert_array_equal(t, arr)
    for v in (3, -3, 2.5, "s", [1, -2], [0.5, 1.5], ["a", "b"]):
        a = onnx_proto.attr("x", v)
        assert a == jax_proto.attr("x", v) and onnx_proto.attr_value(a) == v
