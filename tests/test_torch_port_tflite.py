"""The port's first-party TFLite export (`deploy/export.export_tflite`,
`deploy/tflite_emit.py`, `deploy/tflite_schema.py`, `deploy/tflite_run.py`)
against the JAX package's graph and TFLite export, on the checkpoints of
test_torch_port_export.py (written by the JAX package; the detector's
obj/cls heads scaled so that scores spread and no two candidates tie within
fp32 rounding).

Each port file runs three ways: TensorFlow's `tf.lite.Interpreter` (as
JAX's `load_tflite` builds it), the port's numpy runner, and JAX's own
`load_exported`. Tolerances and their reasons:
  - fp32 "raw"/"decoded" against JAX's graph (`model.apply` +
    `decode_anchorfree`, JAX's `_build_fn`): rtol = atol = 1e-4, fp32
    convolutions summed in other orders (BatchNorm folded here);
  - "nms": boxes 1e-4; `classes`, `valid` and the kept anchor indices
    equal to JAX's `batched_nms` (pre-NMS top-k 512), ties and IoU exactly
    at the threshold included; scores 1e-5 (TFLite's LOGISTIC against
    XLA's); seg masks 1e-4;
  - the port's runner against the Interpreter on the same fp32 file:
    rtol = atol = 1e-5; on the same fp16 file against TFLite's builtin
    kernels (no delegate): 1e-5; on the dynamic file: the dynamic
    tolerance below (the runner quantizes an activation as TFLite's hybrid
    kernel does, bit for bit on equal input, but an input 1 ulp apart can
    round to the next int8 step, and that step travels on);
  - fp16 against JAX's fp32 graph: 1e-2 of each output's scale (weights
    rounded to 11 significant bits, ~5e-4, through some 60 layers; the
    seg model's 640 px file reaches 4e-3); dynamic int8: 5e-2 of each
    output's scale (weights rounded to 1/254 of a channel's range,
    activations to 1/255 of a batch item's).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.deploy import export as jax_export
from yololite_tpu.ops.nms import batched_nms as jax_batched_nms
from yololite_tpu.ops.nms import yolo_scores as jax_yolo_scores
from yololite_tpu.train.checkpoint import load_checkpoint, model_from_meta

from tests.test_torch_port_export import (  # noqa: F401 fixtures
    IMG, _batch, ckpt, one_torch_thread, out_dir, seg_ckpt)
from yololite_tpu_torch.deploy import export, tflite_schema
from yololite_tpu_torch.deploy.tflite_emit import export_program_to_tflite
from yololite_tpu_torch.deploy.tflite_run import TFLiteModel
from yololite_tpu_torch.ops.nms import batched_nms, yolo_scores

tf = pytest.importorskip("tensorflow")

BATCH = 2
_FILES = {}


def _port_file(ckpt, out_dir, fmt, quantize=None, batch=BATCH, **kw):
    key = (ckpt, fmt, quantize, batch, tuple(sorted(kw.items())))
    if key not in _FILES:
        sub = os.path.join(out_dir, f"tfl_{quantize}_{batch}_{len(_FILES)}")
        _FILES[key] = export.export_tflite(ckpt, out_dir=sub, fmt=fmt, batch=batch,
                                           img_size=IMG, quantize=quantize, **kw)
    return _FILES[key]


def _interpreter(path, delegates: bool = True):
    kind = tf.lite.experimental.OpResolverType
    it = tf.lite.Interpreter(model_path=path, experimental_op_resolver_type=(
        kind.AUTO if delegates else kind.BUILTIN_WITHOUT_DEFAULT_DELEGATES))
    return it.get_signature_runner("serving_default")


_JAX_FNS = {}


def _jax_graph(ckpt, fmt, x, conf=0.001, iou=0.65, max_det=300):
    """JAX's deploy graph of `fmt` (its `_build_fn`, fp32) on `x`, as numpy:
    a dict for "decoded", else a tuple."""
    key = (ckpt, fmt, conf, iou, max_det)
    if key not in _JAX_FNS:
        sd, meta = load_checkpoint(ckpt)
        model = model_from_meta(meta, dtype=jnp.float32)
        variables = {"params": sd["params"], "batch_stats": sd["batch_stats"]}
        fn = jax_export._build_fn(model, IMG, fmt, conf, iou, max_det)
        _JAX_FNS[key] = jax.jit(lambda im: fn(variables, im))
    out = _JAX_FNS[key](jnp.asarray(x))
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    return tuple(np.asarray(v) for v in out)


def _three_ways(path, x):
    """The port's file through the Interpreter, the port's runner
    (`load_exported`) and JAX's `load_exported`, each as {name: array}."""
    meta = json.load(open(path + ".json"))
    names = meta["outputs"]
    interp = _interpreter(path)(images=x)
    call, _ = export.load_exported(path)
    port = call(x)
    jcall, jmeta = jax_export.load_exported(path)
    jax_out = jcall(x)
    assert jmeta == meta
    as_dict = lambda o: dict(o) if isinstance(o, dict) else dict(zip(names, o))  # noqa: E731
    return meta, {"interpreter": {n: interp[n] for n in names}, "runner": as_dict(port),
                  "jax_load_tflite": as_dict(jax_out)}


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["det", "seg"])
@pytest.mark.parametrize("fmt", ["raw", "decoded"])
def test_fp32_raw_and_decoded_match_jax_graph(ckpt, seg_ckpt, out_dir, model, fmt):
    path = _port_file(ckpt if model == "det" else seg_ckpt, out_dir, fmt)
    x = _batch(BATCH, seed=11)
    meta, runs = _three_ways(path, x)
    want = _jax_graph(ckpt if model == "det" else seg_ckpt, fmt, x)
    want = want if isinstance(want, dict) else dict(zip(meta["outputs"], want))
    assert set(want) == set(meta["outputs"])
    for how, got in runs.items():
        for name in meta["outputs"]:
            assert got[name].dtype == want[name].dtype == np.float32
            _close(got[name], want[name], 1e-4, f"{how} {name}")
    for name in meta["outputs"]:
        _close(runs["runner"][name], runs["interpreter"][name], 1e-5, f"runner {name}")


def _sidecar_like_jax(meta, fmt, with_masks):
    keys = {"format", "img_size", "batch", "conf", "iou", "max_det", "names",
            "num_classes", "outputs", "quantize", "letterbox", "normalize", "runtime",
            "source_ckpt"}
    assert keys <= set(meta)
    assert meta["runtime"] == "tflite" and meta["normalize"] == "imagenet/in-graph"
    if fmt == "nms":
        assert meta["outputs"] == ["boxes", "scores", "classes", "valid"] + (
            ["masks"] if with_masks else [])


@pytest.mark.parametrize("model", ["det", "seg"])
def test_fp32_nms_matches_jax_batched_nms(ckpt, seg_ckpt, out_dir, model):
    """The in-graph NMS (TOPK_V2, IoU matrix, WHILE) gives JAX's detections:
    classes and valid equal, boxes 1e-4; the seg masks 1e-4."""
    ck = ckpt if model == "det" else seg_ckpt
    kw = dict(conf=0.0, iou=0.5, max_det=40) if model == "seg" else {}
    path = _port_file(ck, out_dir, "nms", **kw)
    x = _batch(BATCH, seed=12)
    meta, runs = _three_ways(path, x)
    _sidecar_like_jax(meta, "nms", model == "seg")
    want = dict(zip(meta["outputs"], _jax_graph(ck, "nms", x, meta["conf"], meta["iou"],
                                                meta["max_det"])))
    assert want["valid"].sum() > 10
    for how, got in runs.items():
        assert got["valid"].dtype == np.bool_ and got["classes"].dtype == np.int32
        np.testing.assert_array_equal(got["valid"], want["valid"], err_msg=how)
        np.testing.assert_array_equal(got["classes"], want["classes"], err_msg=how)
        _close(got["boxes"], want["boxes"], 1e-4, f"{how} boxes")
        _close(got["scores"], want["scores"], 1e-5, f"{how} scores")
        if model == "seg":
            _close(got["masks"], want["masks"], 1e-4, f"{how} masks")
    for name in meta["outputs"]:
        _close(runs["runner"][name], runs["interpreter"][name], 1e-5, f"runner {name}")


class _Nms(torch.nn.Module):
    """The port's scores and batched NMS on given decoded outputs, with
    the kept anchor indices (the keep) as a fifth output."""

    def __init__(self, conf, iou, max_det, topk):
        super().__init__()
        self.kw = dict(iou_th=iou, conf_th=conf, max_det=max_det, pre_nms_topk=topk)

    def forward(self, boxes, obj, cls):
        s, c = yolo_scores(obj, cls)
        return batched_nms(boxes, s, c, **self.kw)


def _tie_case(seed: int, b: int = 2, n: int = 120):
    """Integer boxes (exact IoU arithmetic) with runs of equal scores, a
    pair at IoU exactly 0.5 and another just above, in the same class."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 50, (b, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.randint(2, 24, (b, n, 2)).astype(np.float32)], -1)
    obj = rng.randn(b, n).astype(np.float32)
    cls = rng.randn(b, n, 3).astype(np.float32)
    obj[:, 10:30] = obj[:, 9:10]                   # 21 equal scores a row
    cls[:, 10:30] = cls[:, 9:10]
    for first, second, at, h in ((0, 1, 0, 5.0), (2, 3, 30, 5.5)):
        boxes[:, first] = [at, at, at + 10, at + 10]   # IoU 50/100 = 0.5 exactly; 55/100
        boxes[:, second] = [at, at, at + 10, at + h]
        obj[:, [first, second]] = 6.0
        cls[:, [first, second]] = [8.0, 0.0, 0.0]
    return boxes, obj, cls


@pytest.mark.parametrize("seed,topk", [(0, 512), (1, 64)])
def test_nms_keep_equals_jax_with_ties_and_iou_at_threshold(tmp_path, seed, topk):
    boxes, obj, cls = _tie_case(seed)
    conf, iou, max_det = 0.001, 0.5, 50
    args = tuple(torch.from_numpy(a) for a in (boxes, obj, cls))
    program = torch.export.export(_Nms(conf, iou, max_det, topk), args)
    names = ["boxes", "scores", "classes", "valid", "idx"]
    path = export_program_to_tflite(program, str(tmp_path / "nms.tflite"),
                                    input_names=["boxes", "obj", "cls"], output_names=names)
    s, c = jax_yolo_scores(jnp.asarray(obj), jnp.asarray(cls))
    want = [np.asarray(t) for t in jax_batched_nms(jnp.asarray(boxes), s, c, iou_th=iou,
                                                   conf_th=conf, max_det=max_det,
                                                   pre_nms_topk=topk)]
    kept = want[4][0][want[3][0]].tolist()
    assert 0 in kept and 1 in kept and 2 in kept and 3 not in kept   # 0.5 kept, 0.55 not
    model = TFLiteModel(path)
    runs = {"interpreter": _interpreter(path)(boxes=boxes, obj=obj, cls=cls),
            "runner": model.run_signature(boxes=boxes, obj=obj, cls=cls)}
    with torch.no_grad():
        eager = [t.numpy() for t in _Nms(conf, iou, max_det, topk)(*args)]
    for how, got in list(runs.items()) + [("eager", dict(zip(names, eager)))]:
        for name, w in zip(names, want):
            if name == "scores":
                _close(got[name], w, 1e-5, f"{how} {name}")
            else:
                np.testing.assert_array_equal(got[name], w, err_msg=f"{how} {name}")
    assert "WHILE" in model.summary()["ops"] and model.summary()["subgraphs"] == 3


# --------------------------------------------------------------------------- #
_JAX_TFLITE = {}


def _jax_tflite(ckpt, out_dir, quantize):
    if quantize not in _JAX_TFLITE:
        _JAX_TFLITE[quantize] = jax_export.export_tflite(
            ckpt, out_dir=os.path.join(out_dir, f"jax_tfl_{quantize}"), fmt="decoded",
            batch=1, img_size=IMG, quantize=quantize)
    return _JAX_TFLITE[quantize]


def test_jax_decoded_file_through_the_port_reader_and_runner(ckpt, out_dir):
    """JAX's own "decoded" file: the port's reader lists what TF's schema
    code reads (ops, tensors, dtypes, signature) and the port's runner
    gives the Interpreter's outputs; the port's file has JAX's names and
    dtypes."""
    from tensorflow.lite.python import schema_py_generated as tfs
    jpath = _jax_tflite(ckpt, out_dir, None)
    blob = open(jpath, "rb").read()
    model = tflite_schema.parse_model(blob)
    ref = tfs.Model.GetRootAsModel(blob, 0)
    assert model["version"] == ref.Version() == 3
    codes = [tflite_schema.opcode(c) for c in model["operator_codes"]]
    assert codes == [max(ref.OperatorCodes(i).BuiltinCode(),
                         ref.OperatorCodes(i).DeprecatedBuiltinCode())
                     for i in range(ref.OperatorCodesLength())]
    assert tflite_schema.BUILTIN["BROADCAST_TO"] in codes      # above 127: placeholder
    g, rg = model["subgraphs"][0], ref.Subgraphs(0)
    assert len(g["tensors"]) == rg.TensorsLength()
    for i in range(rg.TensorsLength()):
        t, rt = g["tensors"][i], rg.Tensors(i)
        assert t["shape"] == rt.ShapeAsNumpy().tolist() if rt.ShapeLength() else True
        assert (t["type"], t["buffer"], t["name"]) == (rt.Type(), rt.Buffer(),
                                                       rt.Name().decode())
    x = _batch(1, seed=13)
    want = _interpreter(jpath, delegates=False)(images=x)
    got = TFLiteModel(jpath).run_signature(images=x)
    assert set(got) == set(want) == {"boxes_xyxy", "obj_logits", "cls_logits"}
    for name in want:
        _close(got[name], want[name], 1e-5, name)
    port = TFLiteModel(_port_file(ckpt, out_dir, "decoded", batch=1))
    pout = port.run_signature(images=x)
    for name in want:
        assert pout[name].dtype == want[name].dtype and pout[name].shape == want[name].shape
        _close(pout[name], want[name], 1e-4, name)
    mine = port.model["subgraphs"][0]
    inp = mine["tensors"][mine["inputs"][0]]
    assert inp["type"] == tflite_schema.UINT8 and inp["shape"] == [1, IMG, IMG, 3]
    assert port.input_names == ["images"]


@pytest.mark.parametrize("quantize,tol", [("fp16", 1e-2), ("dynamic", 5e-2)])
def test_quantized_files(ckpt, out_dir, quantize, tol):
    path = _port_file(ckpt, out_dir, "decoded", quantize=quantize)
    fp32 = _port_file(ckpt, out_dir, "decoded")
    assert os.path.getsize(path) < os.path.getsize(fp32)
    assert json.load(open(path + ".json"))["quantize"] == quantize
    x = _batch(BATCH, seed=14)
    want = _jax_graph(ckpt, "decoded", x)
    meta, runs = _three_ways(path, x)
    for how, got in runs.items():
        for name, w in want.items():
            err = float(np.abs(got[name] - w).max()) / max(1.0, float(np.abs(w).max()))
            assert err <= tol, (how, name, err)
    builtin = _interpreter(path, delegates=False)(images=x)
    for name, w in want.items():
        if quantize == "fp16":
            _close(runs["runner"][name], builtin[name], 1e-5, f"runner {name}")
        else:
            err = float(np.abs(runs["runner"][name] - builtin[name]).max())
            assert err <= tol * max(1.0, float(np.abs(w).max())), (name, err)
    port = TFLiteModel(path)
    if quantize == "fp16":
        kinds = port.summary()["ops"]
        assert kinds["DEQUANTIZE"] > 50
        return
    mine = _quantized_kinds(port)
    theirs = _quantized_kinds(TFLiteModel(_jax_tflite(ckpt, out_dir, "dynamic")))
    assert mine == theirs and set(mine) == {("CONV_2D", 0), ("DEPTHWISE_CONV_2D", 3)}


def _quantized_kinds(model: TFLiteModel):
    """{(op kind, quantized_dimension): count} of the int8 weights, with
    their scales per channel and zero points 0."""
    out = {}
    g = model.subgraphs[0]
    for op in g["operators"]:
        for ti in op["inputs"][1:2]:
            t = g["tensors"][ti]
            if t["type"] == tflite_schema.INT8:
                q = t["quantization"]
                assert len(q["scale"]) == t["shape"][q["quantized_dimension"]] > 1
                assert set(q["zero_point"]) == {0}
                key = (model.codes[op["opcode_index"]], q["quantized_dimension"])
                out[key] = out.get(key, 0) + 1
    return out


# --------------------------------------------------------------------------- #
def test_codec_writes_what_tf_schema_reads(ckpt, out_dir):
    """The port's file under TF's generated schema code: the TFL3
    identifier, buffer 0 empty, weight data 16-byte aligned, the
    signature; and a parse -> serialize round trip runs unchanged."""
    from tensorflow.lite.python import schema_py_generated as tfs
    path = _port_file(ckpt, out_dir, "nms")
    blob = open(path, "rb").read()
    assert blob[4:8] == b"TFL3"
    ref = tfs.Model.GetRootAsModel(blob, 0)
    assert ref.Buffers(0).DataLength() == 0 and ref.SignatureDefsLength() == 1
    sig = ref.SignatureDefs(0)
    assert sig.SignatureKey() == b"serving_default" and sig.Inputs(0).Name() == b"images"
    for i in range(1, ref.BuffersLength()):
        if ref.Buffers(i).DataLength() > 16:
            assert ref.Buffers(i)._tab.Vector(4) % 16 == 0
    model = tflite_schema.parse_model(blob)
    assert [s["name"] for s in model["subgraphs"]] == ["main", "greedy_nms_cond",
                                                       "greedy_nms_body"]
    again = tflite_schema.serialize_model(model)
    x = _batch(BATCH, seed=15)
    a = TFLiteModel(blob).run_signature(images=x)
    b = TFLiteModel(again).run_signature(images=x)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
    with pytest.raises(ValueError, match="TFL3"):
        tflite_schema.parse_model(b"\0" * 16)


def test_codes_above_127_and_unknown_ops(tmp_path):
    """GELU (150) keeps PLACEHOLDER_FOR_GREATER_OP_CODES (127) in the
    deprecated field and runs in both runtimes; an op the runner lacks
    raises naming it; an unmapped ATen op raises naming it."""
    class Gelu(torch.nn.Module):
        def forward(self, x):
            return torch.nn.functional.gelu(x, approximate="tanh") * 2.0

    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    path = export_program_to_tflite(torch.export.export(Gelu(), (torch.from_numpy(x),)),
                                    str(tmp_path / "g.tflite"), input_names=["x"],
                                    output_names=["y"])
    model = TFLiteModel(path)
    code = next(c for c in model.model["operator_codes"] if tflite_schema.opcode(c) == 150)
    assert code["deprecated_builtin_code"] == 127 and code["builtin_code"] == 150
    want = Gelu()(torch.from_numpy(x)).numpy()
    _close(model(x)[0], want, 1e-6, "runner")
    _close(_interpreter(path)(x=x)["y"], want, 1e-6, "interpreter")
    model.model["operator_codes"][0] = tflite_schema.operator_code("AVERAGE_POOL_2D")
    model.codes[0] = "AVERAGE_POOL_2D"
    with pytest.raises(NotImplementedError, match="AVERAGE_POOL_2D"):
        model(x)

    class Cumsum(torch.nn.Module):
        def forward(self, x):
            return torch.cumsum(x, 1)
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        export_program_to_tflite(torch.export.export(Cumsum(), (torch.ones(2, 3),)),
                                 str(tmp_path / "c.tflite"), input_names=["x"],
                                 output_names=["y"])
    with pytest.raises(ValueError, match="quantize"):
        export.export_tflite("unused.ckpt", quantize="int4")


def test_export_and_runner_without_tensorflow(ckpt, out_dir, monkeypatch, capsys):
    """export_tflite, load_exported(".tflite") and both CLIs with
    `tensorflow` and `flatbuffers` unimportable."""
    from yololite_tpu_torch.tools import export as export_tool
    from yololite_tpu_torch.tools import infer_exported as infer_tool
    import chip_smoke
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    with pytest.raises(ImportError):
        import tensorflow  # noqa: F401
    sub = os.path.join(out_dir, "no_tf")
    path = export_tool.main(["--weights", ckpt, "--runtime", "tflite", "--format", "nms",
                             "--img_size", str(IMG), "--out_dir", sub, "--quantize",
                             "dynamic"])
    out = capsys.readouterr().out
    assert path.endswith("_nms.tflite") and "Sanity run OK; output tree: tuple" in out
    frame = _batch(1, seed=16)[0]
    img = os.path.join(sub, "f.png")
    chip_smoke.write_png(img, frame[..., ::-1])
    r = infer_tool.main(["--artifact", path, "--img", img, "--conf", "0.01"])
    assert "detections" in capsys.readouterr().out and len(r["boxes"]) > 0
    call, meta = export.load_exported(export.export_tflite(ckpt, out_dir=sub, fmt="decoded",
                                                           img_size=IMG))
    assert set(call(frame[None])) == {"boxes_xyxy", "cls_logits", "obj_logits"}
