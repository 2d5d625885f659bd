"""The port's TFLite emitter and runner over the model zoo and every op
they map (`deploy/tflite_emit.py`, `deploy/tflite_run.py`), port only.

- One config per backbone family (MobileNetV4, HGNetV2, EfficientNet-Lite,
  EfficientNetV2, ConvNeXtV2, CS3Darknet) and both segmentation configs at
  64 px: the "raw" and "decoded" graphs of the Predictor (the normalize
  folded into the stem, so the stem's correction map is a constant ADD)
  through the emitter and the port's runner against the port's eager graph.
  Seeded weights with BatchNorm statistics from one forward keep the
  outputs' scale through depth. Tolerance, against the graph in fp64: the
  larger of 1e-4 and 4x the eager fp32 graph's own distance from it, each
  as a share of the output's scale (the larger of 1 and its max abs). The
  eager fp32 graph sits up to 8.5e-5 of scale from fp64 here
  (EfficientNet-Lite's heads), so a fixed 1e-4 between two fp32 orders of
  summation, one with BatchNorm folded, would be tighter than fp32 is.
- Every ATen op the emitter maps and no deploy graph above uses, in small
  modules: through the runner and `tf.lite.Interpreter` against eager,
  1e-5 (1e-6 of scale for exact ops, which must agree to the bit).
"""

import numpy as np
import pytest
import torch

from chip_smoke import calibrate_batchnorm
from yololite_tpu_torch.config import read_yaml
from yololite_tpu_torch.deploy import export
from yololite_tpu_torch.deploy.fold_norm import normalize_images
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.deploy.tflite_emit import export_program_to_tflite
from yololite_tpu_torch.deploy.tflite_run import TFLiteModel
from yololite_tpu_torch.models.detector import build_model_from_config, init_weights

IMG = 64
FAMILIES = {"mobilenetv4": "configs/models/edge_n.yaml",
            "hgnetv2": "configs/models/edge_xl.yaml",
            "efficientnet_lite": "configs/models/yololite_n.yaml",
            "efficientnetv2": "configs/v2_models/yololite_n.yaml",
            "convnextv2": "configs/v2_models/yololite_l.yaml",
            "cs3darknet": "configs/custom/custom.yaml",
            "seg_edge_n": "configs/models/edge_n_seg.yaml",
            "seg_yololite_n": "configs/models/yololite_n_seg.yaml"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _scale_err(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max()) / max(1.0,
                                                                    float(np.abs(want).max()))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_zoo_raw_and_decoded_through_the_runner(family, tmp_path):
    cfg = read_yaml(FAMILIES[family])
    cfg["model"]["num_classes"] = 3
    model = init_weights(build_model_from_config(cfg), 0).eval()
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.rand(2, IMG, IMG, 3) * 255).astype(np.uint8))
    calibrate_batchnorm(model, normalize_images(x.permute(0, 3, 1, 2)))
    meta = {"img_size": IMG, "names": list("abc")}
    pred = Predictor((model, model.state_dict(), meta), device="cpu", dtype=torch.float32)
    pred64 = Predictor((model, model.state_dict(), meta), device="cpu", dtype=torch.float64)
    assert pred.folded
    for fmt in ("raw", "decoded"):
        graph = export.DeployGraph(pred, IMG, fmt, 0.001, 0.65, 300)
        with torch.no_grad():
            program = torch.export.export(graph, (x,))
            want = graph(x)
            ref = export.graph_outputs(pred64, pred64.forward(x), fmt, IMG, 0.001, 0.65, 300)
        want, ref = ([t.numpy() for t in (o.values() if isinstance(o, dict) else o)]
                     for o in (want, ref))
        names = export.output_names(pred.with_masks, fmt, 3)
        path = export_program_to_tflite(program, str(tmp_path / f"{fmt}.tflite"),
                                        input_names=["images"], output_names=names)
        runner = TFLiteModel(path)
        got = runner.run_signature(images=x.numpy())
        for name, w, r in zip(names, want, ref):
            assert got[name].shape == w.shape and np.abs(w).max() > 0.05
            floor = _scale_err(w, r)                   # eager fp32 against fp64
            assert _scale_err(got[name], r) <= max(1e-4, 4 * floor), (family, fmt, name,
                                                                     floor)
        ops = runner.summary()["ops"]
        assert "CONV_2D" in ops and "DEPTHWISE_CONV_2D" in ops
        if fmt == "raw":
            assert "TRANSPOSE" not in ops, ops          # the level maps need none


class _Ops(torch.nn.Module):
    """The mapped ATen ops that no deploy graph uses, on x [2, 3, 5, 7] and
    y [2, 6, 4]."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(7, 4)
        self.bn = torch.nn.BatchNorm1d(6).eval()
        with torch.no_grad():
            self.bn.running_mean.uniform_(-1, 1)
            self.bn.running_var.uniform_(0.5, 2)

    def forward(self, x, y):
        a = torch.nn.functional.hardsigmoid(x) + torch.nn.functional.hardswish(x)
        b = torch.nn.functional.gelu(x) * torch.exp(-x.abs()) + torch.log(x.abs() + 1)
        c = torch.sqrt(x.abs()) + torch.rsqrt(x.abs() + 1) - torch.neg(x)
        d = torch.maximum(x, a) - torch.minimum(x, b) + x.clamp(-0.5, 0.7)
        e = torch.where((x < 0.1) | (x <= -0.3), d, torch.zeros_like(d))
        f = torch.where((x == 0.0) & ~(x != 0.0), 1.0, e)
        g = torch.nn.functional.relu6(self.lin(f)).permute(0, 2, 3, 1).reshape(2, -1)
        h = torch.tanh(self.bn(y)).sum(-1) + y.amax(-1) + y.mean(-1)
        i = torch.bmm(y.transpose(1, 2), y).reshape(2, -1)
        j = torch.argmax(y, -1).to(torch.float32) + y.argmax(1).sum(-1, keepdim=True)
        k = torch.nn.functional.pad(y, (1, 2), value=0.5).flatten(1)
        m = torch.cat([h, j, torch.ones(2, 3)], 1)
        return g, i, k, m, torch.nn.functional.silu(c).squeeze(0).sum((1, 2))


class _Layout(torch.nn.Module):
    """A conv, then a permute + reshape that needs NCHW order (a
    TRANSPOSE), a channel-axis select, slices with steps and an upsample
    at 5/3 (a GATHER)."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, stride=2, padding=1)
        self.dw = torch.nn.Conv2d(4, 8, 5, padding=2, groups=4)

    def forward(self, x):
        y = self.dw(self.conv(x))
        up = torch.nn.functional.interpolate(y, size=(5, 5), mode="nearest-exact")
        flat = y.reshape(2, 8, -1).permute(0, 2, 1)
        return flat, y[:, 3], y[:, :, ::2, 1::2].sum((2, 3)), up[:, 1:7:3], y.mean((1, 2))


@pytest.mark.parametrize("module", ["ops", "layout"])
def test_every_mapped_op(module, tmp_path):
    tf = pytest.importorskip("tensorflow")
    torch.manual_seed(0)
    rng = np.random.RandomState(2)
    if module == "ops":
        mod = _Ops().eval()
        ins = {"x": rng.randn(2, 3, 5, 7).astype(np.float32),
               "y": rng.randn(2, 6, 4).astype(np.float32)}
        ins["x"][0, 0, 0, :2] = 0.0
    else:
        mod = _Layout().eval()
        ins = {"x": rng.randn(2, 3, 6, 6).astype(np.float32)}
    args = tuple(torch.from_numpy(v) for v in ins.values())
    with torch.no_grad():
        program = torch.export.export(mod, args)
        want = [w.numpy() for w in mod(*args)]
    names = [f"out{i}" for i in range(len(want))]
    path = export_program_to_tflite(program, str(tmp_path / "m.tflite"),
                                    input_names=list(ins), output_names=names)
    runner = TFLiteModel(path)
    ops = runner.summary()["ops"]
    interp = tf.lite.Interpreter(model_path=path).get_signature_runner("serving_default")
    for how, got in (("runner", runner.run_signature(**ins)), ("interpreter", interp(**ins))):
        for name, w in zip(names, want):
            assert got[name].shape == w.shape, (how, name)
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{how} {name}")
    if module == "layout":
        assert {"TRANSPOSE", "GATHER", "PAD", "DEPTHWISE_CONV_2D"} <= set(ops), ops
    else:
        assert {"FULLY_CONNECTED", "BATCH_MATMUL", "ARG_MAX", "SELECT_V2", "PADV2",
                "GELU", "HARD_SWISH", "RSQRT", "LOGICAL_OR", "REDUCE_MAX"} <= set(ops), ops

