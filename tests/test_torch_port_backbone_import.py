"""The port's backbone importer (`models/backbones/torch_import.py`,
`tools/import_backbone.py`) against the JAX package's, for each of the 11
`SUPPORTED_IMPORTS`.

The timm-layout state_dicts come from the JAX package's torch twins
(`models/backbones/torch_twin.py`; resnet18's, which the twin module lacks,
is built here as tests/test_torch_import.py builds it), with randomized
BatchNorm, saved with `torch.save`. Both CLIs run on the same file: JAX's
through `runpy` with `sys.argv` set, the port's through `main(argv)`. JAX's
CLI initializes the backbone with a flax `init` (about 30 s a backbone on a
CPU, op by op); the test hands it the port's seeded initial tree
instead, of the same structure, so that resnet18's stem conv, which keeps
its initial weights, is equal on both sides too. Everything else in JAX's
CLI runs as it is.

Tolerances: the checkpoints' bytes, trees, metas and reports equal for all
11 names; the port's imported backbone's stage features against JAX's
`module.apply` on JAX's checkpoint within 1e-4 of each stage's scale (fp32
convolutions summed in other orders, as in tests/test_torch_import.py) for
one name of each block family (`FEATURE_NAMES`). EfficientNet-Lite 1-4 and
EfficientNetV2-B1/B2 are lite0's and B0's blocks at other width and depth
multipliers (`models/backbones/zoo.py`), and their files equal JAX's byte
for byte, so their features are held to the stage shapes of their
feature_info and to finite values, without a JAX compile of each (3-4 s a
backbone on a CPU).
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

import yololite_tpu.models.backbones as jax_backbones
from yololite_tpu.models.backbones import torch_import as jax_import
from yololite_tpu.models.backbones.torch_twin import TorchTwin

from tests.test_torch_port_export import one_torch_thread  # noqa: F401 fixture
from yololite_tpu_torch.convert import load_flax, to_flax
from yololite_tpu_torch.models.backbones import torch_import
from yololite_tpu_torch.models.backbones.zoo import BACKBONES, build_backbone
from yololite_tpu_torch.models.detector import init_weights
from yololite_tpu_torch.tools import import_backbone as import_tool
from yololite_tpu_torch.train.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
FEATURE_RTOL = 1e-4
# one name of each block family: features held against JAX's
FEATURE_NAMES = ("mobilenetv4_conv_small", "mobilenetv4_conv_small_050",
                 "tf_efficientnet_lite0", "tf_efficientnetv2_b0", "resnet18")
JAX_BUILD = jax_backbones.build_backbone


def _randomize_bn(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, tnn.BatchNorm2d):
            with torch.no_grad():
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)


class TorchResNet18(tnn.Module):
    """timm's resnet18 state_dict layout: conv7x7 + bn, 4 stages of two
    basic blocks (downsample where the shape changes), fc."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        layers, c_in = [], 64
        for feats, stride in [(64, 1), (128, 2), (256, 2), (512, 2)]:
            blocks = []
            for bi in range(2):
                s = stride if bi == 0 else 1
                block = tnn.Module()
                block.conv1 = tnn.Conv2d(c_in, feats, 3, s, 1, bias=False)
                block.bn1 = tnn.BatchNorm2d(feats)
                block.conv2 = tnn.Conv2d(feats, feats, 3, 1, 1, bias=False)
                block.bn2 = tnn.BatchNorm2d(feats)
                if s != 1 or c_in != feats:
                    block.downsample = tnn.Sequential(
                        tnn.Conv2d(c_in, feats, 1, s, bias=False), tnn.BatchNorm2d(feats))
                blocks.append(block)
                c_in = feats
            layers.append(tnn.ModuleList(blocks))
        self.layers = tnn.ModuleList(layers)
        self.fc = tnn.Linear(512, 1000)


def _timm_state(name):
    torch.manual_seed(3)
    model = TorchResNet18() if name == "resnet18" else TorchTwin(name)
    _randomize_bn(model)
    return model.state_dict()


def _port_initial_tree(name):
    return to_flax(init_weights(build_backbone(name)[0], 0))


class _PortInitialized:
    """A JAX zoo module whose `init` returns the port's initial tree."""

    def __init__(self, name):
        self.name = name

    def init(self, rng, x):
        params, batch_stats = _port_initial_tree(self.name)
        return {"params": params, "batch_stats": batch_stats}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _run_both(name, state_path, out_dir, monkeypatch, capsys):
    jax_out, port_out = os.path.join(out_dir, "jax.ckpt"), os.path.join(out_dir, "port.ckpt")
    monkeypatch.setattr(jax_backbones, "build_backbone",
                        lambda n, **kw: (_PortInitialized(n), JAX_BUILD(n, **kw)[1]))
    monkeypatch.setattr(sys, "argv", ["tools/import_backbone.py", "--backbone", name,
                                      "--torch_state", state_path, "--out", jax_out])
    runpy.run_path(os.path.join(ROOT, "tools", "import_backbone.py"), run_name="__main__")
    jax_lines = capsys.readouterr().out.replace(jax_out, "OUT")
    report = import_tool.main(["--backbone", name, "--torch_state", state_path,
                               "--out", port_out])
    port_lines = capsys.readouterr().out.replace(port_out, "OUT")
    assert port_lines == jax_lines
    return jax_out, port_out, report


@pytest.mark.parametrize("name", torch_import.SUPPORTED_IMPORTS)
def test_import_matches_jax(name, tmp_path, monkeypatch, capsys):
    assert torch_import.SUPPORTED_IMPORTS == jax_import.SUPPORTED_IMPORTS
    state_path = str(tmp_path / f"{name}.pth")
    torch.save(_timm_state(name), state_path)
    jax_out, port_out, report = _run_both(name, state_path, str(tmp_path), monkeypatch,
                                          capsys)
    with open(jax_out, "rb") as f, open(port_out, "rb") as g:
        assert f.read() == g.read()
    (sd, meta), (jsd, jmeta) = load_checkpoint(port_out), load_checkpoint(jax_out)
    assert meta == jmeta
    assert {k: meta[k] for k in report} == report
    assert report["assigned"] == len(torch_import.plan_flax_slots(name)) - \
        len(report["skipped_flax"])
    if name == "resnet18":
        assert report["skipped_flax"] == ["ConvBNAct_1/Conv_0", "ConvBNAct_1/BatchNorm_0"]
        assert report["leftover_torch"] == ["fc"]
    else:
        assert not report["skipped_flax"] and not report["leftover_torch"]
    # the trees, leaf by leaf (the zoo's trees equal flax's:
    # test_torch_port_zoo.py)
    for coll in ("params", "batch_stats"):
        got, want = dict(_leaves(sd[coll])), dict(_leaves(jsd[coll]))
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])

    # features: the port's backbone from its file against JAX's apply on JAX's
    module, info = build_backbone(name)
    load_flax(module, sd["params"], sd["batch_stats"]).eval()
    x = np.random.RandomState(0).rand(1, IMG, IMG, 3).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    if name not in FEATURE_NAMES:
        assert [tuple(g.shape) for g in got] == \
            [(1, i["num_chs"], IMG // i["reduction"], IMG // i["reduction"]) for i in info]
        assert all(torch.isfinite(g).all() for g in got)
        return
    jmod, _ = JAX_BUILD(name, dtype=jnp.float32)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        {"params": jsd["params"], "batch_stats": jsd["batch_stats"]}, jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy().transpose(0, 2, 3, 1)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= FEATURE_RTOL * max(1.0, np.abs(w).max())


def test_unsupported_backbones_raise(tmp_path):
    others = sorted(set(BACKBONES) - set(torch_import.SUPPORTED_IMPORTS))
    assert others
    for name in others:
        for mod in (torch_import, jax_import):
            with pytest.raises(mod.UnsupportedBackbone, match="not supported"):
                mod.plan_flax_slots(name)
    assert issubclass(torch_import.UnsupportedBackbone, ValueError)
    path = str(tmp_path / "sd.npz")
    np.savez(path, w=np.zeros((8, 3, 3, 3), np.float32))
    with pytest.raises(torch_import.UnsupportedBackbone):
        import_tool.main(["--backbone", "convnextv2_tiny", "--torch_state", path,
                          "--out", str(tmp_path / "x.ckpt")])


def test_torch_state_forms(tmp_path):
    """A bare state_dict, one under "state_dict" or "model", and an .npz read
    the same in both packages."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from import_backbone import load_torch_state as jax_load
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    sd = _timm_state("tf_efficientnet_lite0")
    forms = {"bare.pth": sd, "wrapped.pt": {"state_dict": sd, "epoch": 3},
             "model.pth": {"model": sd}}
    for fname, obj in forms.items():
        torch.save(obj, str(tmp_path / fname))
    np.savez(str(tmp_path / "sd.npz"), **{k: v.numpy() for k, v in sd.items()})
    for fname in list(forms) + ["sd.npz"]:
        got, want = (fn(str(tmp_path / fname)) for fn in (import_tool.load_torch_state,
                                                             jax_load))
        assert list(got) == list(want) == list(sd)
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_slot_plans_match_jax():
    for name in torch_import.SUPPORTED_IMPORTS:
        got, want = torch_import.plan_flax_slots(name), jax_import.plan_flax_slots(name)
        assert [(s.kind, s.path, s.has_bias) for s in got] == \
            [(s.kind, s.path, s.has_bias) for s in want]
    sd = _timm_state("tf_efficientnetv2_b0")
    got, want = torch_import.group_torch_slots(sd), jax_import.group_torch_slots(sd)
    assert [(s.kind, s.torch_prefix, s.has_bias) for s in got] == \
        [(s.kind, s.torch_prefix, s.has_bias) for s in want]


def test_mismatched_state_raises():
    """A state_dict of another backbone fails on a shape or kind, naming the
    slot, in both packages."""
    sd = _timm_state("tf_efficientnet_lite0")
    params, stats = _port_initial_tree("mobilenetv4_conv_small_050")
    for mod in (torch_import, jax_import):
        with pytest.raises(ValueError, match="mismatch|exhausted"):
            mod.convert_backbone("mobilenetv4_conv_small_050", sd, params, stats)
