"""PyTorch port parity: `yololite_tpu_torch/tools/model_info.py` against the
JAX package's `tools/model_info.py` (`analyze`, XLA's `cost_analysis` of the
lowered eval forward), on the CPU.

JAX's `analyze` is run with its `init_model` handed zero variables of the
right shapes (`jax.eval_shape`, no flax init): neither the parameter count
nor the cost analysis reads the values.

Parameters: equal. FLOPs: the two counts differ by design, and each gap is
explained exactly (see the port module's docstring). The port counts every
kernel tap of its convolutions and matmuls (2 x MACs, FlopCounterMode); XLA
counts the taps over real input only, adds the discarded P6 branch, and
adds elementwise work. The test takes XLA's figure apart with XLA itself
(each convolution the forward lowers, lowered alone and cost-analysed) and
holds, per config at 64 px:
  port FLOPs - the port's taps over padding + the P6 branch's taps over
  input == the sum of XLA's per-convolution counts (exactly), and
  XLA's figure - that sum (elementwise work) within 2% of XLA's figure.
The stated gaps (port / XLA - 1) are the values measured here, held to
0.01 points: they are exact integer counts.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yololite_tpu.models.detector as jax_detector

from yololite_tpu_torch.config.config import read_yaml
from yololite_tpu_torch.models.detector import build_model_from_config
from yololite_tpu_torch.tools import model_info

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
# config -> (JAX's parameter count at 3 classes, port / XLA FLOPs - 1 at 64 px, %)
CONFIGS = {
    "configs/models/edge_n.yaml": (549_640, +1.12),
    "configs/models/edge_n_seg.yaml": (728_328, +8.14),
    "configs/models/yololite_n.yaml": (6_293_616, +14.62),
    "configs/v2_models/yololite_n.yaml": (8_921_632, +12.15),
    "configs/custom/custom.yaml": (5_338_840, +8.41),
}
ELEMENTWISE_SHARE = 0.02       # measured 0.4-1.7% of XLA's figure at 64 px


def _jax_model_info():
    spec = importlib.util.spec_from_file_location(
        "jax_model_info", os.path.join(ROOT, "tools", "model_info.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_MI = _jax_model_info()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs: the test files run in
    parallel processes, and torch's default of one thread a core in each of
    them oversubscribes the machine (this file's runs took 50-100x longer
    so in a 4-process run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_analyze(monkeypatch):
    """JAX's `analyze` on zero variables, returning (info, the arguments of
    every convolution its forward lowers)."""
    convs = []

    def zero_init(model, img_size, seed=0, batch=1, host_init=None):
        x = jnp.zeros((batch, img_size, img_size, 3), model.dtype)
        shapes = jax.eval_shape(lambda k, x: model.init({"params": k}, x, train=False),
                                jax.random.PRNGKey(seed), x)
        z = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        convs.clear()           # keep only the forward's convolutions
        return z["params"], z.get("batch_stats", {})

    real = jax.lax.conv_general_dilated

    def conv(lhs, rhs, *args, **kw):
        convs.append((jax.ShapeDtypeStruct(lhs.shape, lhs.dtype),
                      jax.ShapeDtypeStruct(rhs.shape, rhs.dtype), args, kw))
        return real(lhs, rhs, *args, **kw)

    monkeypatch.setattr(jax_detector, "init_model", zero_init)
    monkeypatch.setattr(jax.lax, "conv_general_dilated", conv)

    def run(rel):
        info = JAX_MI.analyze(os.path.join(ROOT, rel), IMG, 3)
        return info, list(convs)
    return run


def _xla_conv_flops(convs) -> float:
    """XLA's own count of each convolution, lowered alone."""
    total = 0.0
    for lhs, rhs, args, kw in convs:
        fn = jax.jit(lambda a, b: jax.lax.conv_general_dilated(a, b, *args, **kw))
        total += float(fn.lower(lhs, rhs).cost_analysis()["flops"])
    return total


def _padded_and_valid_taps(model, run):
    """(FLOPs of the taps over padding, FLOPs of the taps over input) of
    every Conv2d call in `run()`, 2 per multiply-add."""
    pad = valid = 0

    def taps(n_in, n_out, k, s, p, d):
        pos = np.arange(n_out)[:, None] * s - p + np.arange(k)[None, :] * d
        return int(((pos >= 0) & (pos < n_in)).sum())

    def hook(mod, inp, out):
        nonlocal pad, valid
        (kh, kw), (sh, sw), (ph, pw), (dh, dw) = (mod.kernel_size, mod.stride,
                                                  mod.padding, mod.dilation)
        h, w = inp[0].shape[2:]
        ho, wo = out.shape[2:]
        per_tap = 2 * inp[0].shape[0] * mod.out_channels * (mod.in_channels // mod.groups)
        v = taps(h, ho, kh, sh, ph, dh) * taps(w, wo, kw, sw, pw, dw)
        valid += per_tap * v
        pad += per_tap * (ho * kh * wo * kw - v)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return pad, valid


def _port_model(rel):
    cfg = read_yaml(os.path.join(ROOT, rel))
    cfg["model"]["num_classes"] = 3
    cfg.setdefault("training", {})["img_size"] = IMG
    return build_model_from_config(cfg).eval()


@pytest.mark.parametrize("rel", sorted(CONFIGS))
def test_params_and_flops_against_jax(rel, jax_analyze):
    want_params, stated_gap = CONFIGS[rel]
    info, convs = jax_analyze(rel)
    got = model_info.analyze(os.path.join(ROOT, rel), IMG, 3, device="cpu")
    assert round(got["params_M"] * 1e6) == round(info["params_M"] * 1e6) == want_params
    assert got["strides"] == list(info["strides"]) and got["backbone"] == info["backbone"]
    assert got["macs_G"] == got["flops_G"] / 2 and got["model"] == info["model"]

    port, xla = got["flops_G"] * 1e9, info["flops_G"] * 1e9
    model = _port_model(rel)
    x = torch.zeros(1, 3, IMG, IMG)
    pad, _ = _padded_and_valid_taps(model, lambda: model(x))
    p5 = {}
    h = model.smooth5.register_forward_hook(lambda m, i, o: p5.setdefault("x", o))
    with torch.no_grad():
        model(x)
    h.remove()
    assert not model.use_p6
    _, p6 = _padded_and_valid_taps(model, lambda: model.smooth6(model.p6_down(p5["x"])))
    xla_convs = _xla_conv_flops(convs)
    assert port - pad + p6 == xla_convs, (port, pad, p6, xla_convs)
    assert 0 < xla - xla_convs <= ELEMENTWISE_SHARE * xla
    assert abs(100 * (port / xla - 1) - stated_gap) < 0.01, 100 * (port / xla - 1)


def test_main_all_prints_twelve_rows(capsys):
    rows = model_info.main(["--all", "--img_size", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(rows) == 12 and "FAILED" not in out
    lines = out.strip().splitlines()
    assert lines[0].split() == ["model", "backbone", "params(M)", "GFLOPs", "GMACs", "strides"]
    assert [ln.split()[0] for ln in lines[1:]] == sorted(
        os.path.splitext(f)[0] for f in os.listdir(os.path.join(ROOT, "configs", "models")))
    edge_n = next(r for r in rows if r["model"] == "edge_n")
    assert round(edge_n["params_M"] * 1e6) == 549_640


def test_a_failing_config_prints_failed(tmp_path, capsys):
    bad = tmp_path / "bad.yaml"
    bad.write_text("model:\n  arch: YOLOLiteMS\n  backbone: no_such_backbone\n")
    assert model_info.main(["--model", str(bad), "--img_size", "64", "--device", "cpu"]) == []
    assert capsys.readouterr().out.splitlines()[1].split()[:2] == ["bad.yaml", "FAILED:"]
    with pytest.raises(SystemExit):
        model_info.main(["--device", "cpu"])
