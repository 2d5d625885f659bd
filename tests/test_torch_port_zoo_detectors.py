"""PyTorch port parity: every detection config under configs/, the port's
YAML reader and model-name resolution, against the JAX package.

- Structure, all 15 detection configs and the 2 segmentation configs: the
  flax variables' tree (from jax.eval_shape, no forward) loads with no
  missing or leftover key, and the parameter counts equal JAX's.
- Forward, one config per backbone family at 64 px: rtol = atol = 1e-4 on
  every level output, fp32 on the CPU (see tests/test_torch_port_zoo.py for
  why 1e-4, and for the random variables, which keep outputs O(0.1..1)).
- The YAML reader equals `yaml.safe_load` exactly on every config it reads.
"""

import functools
import glob
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from yololite_tpu.api import _resolve_model_arg as jax_resolve_model_arg
from yololite_tpu.config.config import deep_merge as jax_deep_merge
from yololite_tpu.config.config import read_yaml as jax_read_yaml
from yololite_tpu.deploy.fold_norm import fold_normalization as jax_fold
from yololite_tpu.deploy.fold_norm import folded_stem as jax_folded_stem
from yololite_tpu.deploy.fold_norm import raw_cast as jax_raw_cast
from yololite_tpu.models.detector import build_model_from_config as jax_build
from yololite_tpu.models.detector import count_params as jax_count_params

from tests.test_torch_port_zoo import nhwc, random_vars, run_jax_all
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.config import deep_merge, parse_yaml, read_yaml, resolve_model_arg
from yololite_tpu_torch.convert import load_flax
from yololite_tpu_torch.deploy.fold_norm import (
    fold_normalization, folded_stem, normalize_images, raw_cast,
)
from yololite_tpu_torch.models.detector import (
    build_model_from_config, count_params, init_weights,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every detection config, with its parameter count at 3 classes (JAX)
CONFIGS = {
    "configs/models/edge_n.yaml": 549_640,
    "configs/models/edge_s.yaml": 2_359_736,
    "configs/models/edge_m.yaml": 2_948_948,
    "configs/models/edge_l.yaml": 4_351_608,
    "configs/models/edge_xl.yaml": 9_344_168,
    "configs/models/yololite_n.yaml": 6_293_616,
    "configs/models/yololite_s.yaml": 9_369_368,
    "configs/models/yololite_m.yaml": 13_924_752,
    "configs/models/yololite_l.yaml": 30_379_544,
    "configs/models/yololite_xl.yaml": 44_597_528,
    "configs/v2_models/yololite_n.yaml": 8_921_632,
    "configs/v2_models/yololite_s.yaml": 12_431_916,
    "configs/v2_models/yololite_m.yaml": 17_913_598,
    "configs/v2_models/yololite_l.yaml": 52_219_704,
    "configs/custom/custom.yaml": 5_338_840,
}
SEG_CONFIGS = ["configs/models/edge_n_seg.yaml", "configs/models/yololite_n_seg.yaml"]
SEG_PARAMS = {"configs/models/edge_n_seg.yaml": 728_328,        # JAX, 3 classes
              "configs/models/yololite_n_seg.yaml": 7_011_104}
# one config per backbone family (v2 l: ConvNeXtV2's 17/9/5/3 maps at 64 px)
FORWARD = {"yololite_n": "configs/models/yololite_n.yaml",
           "v2_n": "configs/v2_models/yololite_n.yaml",
           "v2_l": "configs/v2_models/yololite_l.yaml",
           "edge_xl": "configs/models/edge_xl.yaml",
           "custom": "configs/custom/custom.yaml",
           "edge_s": "configs/models/edge_s.yaml"}
YAMLS = sorted(os.path.relpath(p, ROOT) for sub in ("models", "v2_models", "custom")
               for p in glob.glob(os.path.join(ROOT, "configs", sub, "*.yaml")))
IMG = 64


def config(rel: str, reader=read_yaml):
    cfg = reader(os.path.join(ROOT, rel))
    cfg["model"]["num_classes"] = 3
    return cfg


@functools.lru_cache(maxsize=None)
def jax_model(rel: str):
    return jax_build(config(rel, jax_read_yaml), dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def jax_variables(rel: str):
    """Random variables of a config at IMG px; cached, callers must not mutate."""
    return random_vars(jax_model(rel), nhwc(2, IMG, 3))


def port_model(rel: str, params, bs):
    return load_flax(build_model_from_config(config(rel)), params, bs).eval()


# --------------------------------------------------------------------------- #
def test_every_detection_config_is_listed():
    det = {rel for rel in YAMLS if "model" in read_yaml(os.path.join(ROOT, rel))}
    assert det == set(CONFIGS) | set(SEG_CONFIGS)


@pytest.mark.parametrize("rel", sorted(CONFIGS))
def test_config_loads_jax_variables_exactly(rel):
    m = jax_model(rel)
    shapes = jax.eval_shape(lambda k, x: m.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = port_model(rel, zeros["params"], zeros["batch_stats"])
    assert count_params(port) == jax_count_params(zeros["params"]) == CONFIGS[rel]


@pytest.mark.parametrize("rel", SEG_CONFIGS)
def test_segmentation_configs_raise(rel):
    """The segmentation configs build (ProtoNet and mask coefficients, no
    raise) and load JAX's full-size variable tree exactly, with JAX's
    parameter count at 3 classes."""
    m = jax_model(rel)
    shapes = jax.eval_shape(lambda k, x: m.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = port_model(rel, zeros["params"], zeros["batch_stats"])
    assert port.with_masks and port.num_prototypes == 32
    assert count_params(port) == jax_count_params(zeros["params"]) == SEG_PARAMS[rel]


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_detector_forward_matches_jax(name):
    rel = FORWARD[name]
    params, bs = jax_variables(rel)
    x = nhwc(2, IMG, 3)
    want = run_jax_all(jax_model(rel), params, bs, x)
    with torch.no_grad():
        got = port_model(rel, params, bs)(torch.from_numpy(x).permute(0, 3, 1, 2))
    if name == "v2_l":      # k4/s4 stem and k2/s2 downsamples pad 2 and 1
        assert [g.shape[2] for g in got] == [9, 5, 3]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.abs(w - w.mean()).max() > 0.05     # outputs are not constant
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_init_weights_ignores_the_global_rng():
    """ConvNeXtV2 adds Linear, LayerNorm and GRN: all are set from the seed."""
    sds = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        model = init_weights(build_model_from_config(config(FORWARD["v2_l"])), seed=0)
        sds.append(model.state_dict())
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])


def test_v2_fold_touches_only_the_stem():
    """JAX's `folded_stem` interceptor adds the normalize correction to every
    conv whose input has 3 or 12 channels. EfficientNetV2-B0's first SE
    block squeezes 48 channels to int(48 * 0.25) = 12, so JAX's folded v2 n
    shifts those SE gates (ROADMAP Queue 3). The port folds only the stem:
    its folded model on raw uint8 equals the unfolded one (and JAX's
    unfolded one) on the normalized image, at rtol = atol = 1e-4."""
    rel = FORWARD["v2_n"]
    m, (params, bs) = jax_model(rel), jax_variables(rel)
    u8 = (np.random.RandomState(3).rand(2, IMG, IMG, 3) * 255).astype(np.uint8)
    x_u8 = torch.from_numpy(u8).permute(0, 3, 1, 2)
    x_norm = normalize_images(x_u8).permute(0, 2, 3, 1).numpy()
    want = run_jax_all(m, params, bs, x_norm)

    sd, ok = fold_normalization(port_model(rel, params, bs).state_dict())
    assert ok
    folded = build_model_from_config(config(rel))
    folded.load_state_dict(sd)
    with torch.no_grad():
        got = folded_stem(folded).eval()(raw_cast(x_u8, torch.float32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)

    fp, fbs, ok = jax_fold(params, bs)
    assert ok

    def jax_folded(v, x):
        with jax_folded_stem():
            return m.apply(v, jax_raw_cast(x, jnp.float32), train=False)
    jax_out = jax.jit(jax_folded)({"params": fp, "batch_stats": fbs}, jnp.asarray(u8))
    assert max(float(np.abs(np.asarray(j) - w).max()) for j, w in zip(jax_out, want)) > 1e-3


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rel", YAMLS)
def test_read_yaml_equals_pyyaml(rel):
    with open(os.path.join(ROOT, rel)) as f:
        want = yaml.safe_load(f) or {}
    assert read_yaml(os.path.join(ROOT, rel)) == want


@pytest.mark.parametrize("text", [
    "a: 1e-3", "a: 1.0e-3", "a: 1.0e+3", "a: .5", "a: -.inf", "a: 1_000", "a: +3",
    "a: yes", "a: Off", "a: ~", "a: null", "a:", "a: 'x # y'", "a: 'it''s'",
    'a: "q"', "a: x#y", "a: x # comment", "1: b", "a: 0", "a: -0.0",
    "a:\n  b:\n  c: 2\nd: 3", "# only a comment\n", "a:\n  b:\n    c: 1\n  d: 2",
    "a: [1, 2]", "a:\n  - 1",
])
def test_parse_yaml_scalars_and_nesting_equal_pyyaml(text):
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, [2]]", "a:\n  - b: 1", "a: &x 1", "a: !!int 3", "a: |\n  x", "a: 012",
    "a: 0x1f", "a: 1:30", "a: 2001-12-14", "a: b: c", "  a: 1\n b: 2",
    "a:\n\tb: 1", "a: 'x", 'a: "x\\n"', "---\na: 1", "a\n", "a: {b: 1}",
])
def test_parse_yaml_raises_on_syntax_it_does_not_know(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_deep_merge_equals_jax():
    a = {"model": {"backbone": "x", "fpn_channels": 128}, "training": {"img_size": 640}}
    b = {"model": {"fpn_channels": 256, "head_depth": 2}, "logging": {"log_dir": "r"}}
    want = jax_deep_merge({k: dict(v) for k, v in a.items()}, b)
    assert deep_merge({k: dict(v) for k, v in a.items()}, b) == want


@pytest.mark.parametrize("arg", [
    "edge_n", "edge_n.yaml", "yololite_n", "yololite_l", "custom", "edge_n_seg",
    os.path.join(ROOT, "configs", "v2_models", "yololite_n.yaml"),
])
def test_model_name_resolution_equals_jax(arg):
    """models/ shadows v2_models/ by name: v2 configs are reached by path."""
    assert resolve_model_arg(arg) == jax_resolve_model_arg(arg)


def test_unknown_model_and_missing_checkpoint_raise_as_jax():
    for resolve in (resolve_model_arg, jax_resolve_model_arg):
        with pytest.raises(FileNotFoundError):
            resolve("no_such_model")
    model = YoloLite("edge_n", device="cpu")
    with pytest.raises(RuntimeError, match="checkpoint"):
        model.predict(np.zeros((32, 32, 3), np.uint8))


# --------------------------------------------------------------------------- #
# Training configs: the reader on configs/train, data.yaml forms, the 3-way
# merge against JAX's load_configs, and the merged config's round trip
TRAIN_YAMLS = sorted(os.path.relpath(p, ROOT)
                     for p in glob.glob(os.path.join(ROOT, "configs", "train", "*.yaml")))


@pytest.mark.parametrize("rel", TRAIN_YAMLS)
def test_train_yaml_equals_pyyaml(rel):
    with open(os.path.join(ROOT, rel)) as f:
        want = yaml.safe_load(f) or {}
    assert read_yaml(os.path.join(ROOT, rel)) == want


@pytest.mark.parametrize("text", [
    "names: [cat, dog, 'a, b']\nnc: 3", "names:\n- cat\n- dog\nnc: 2",
    "train: ../train/images\nval: valid/images\nnames:\n  - x\n  - 'y z'\n",
    "a: []\nb: {}\nc: [1.5, null, true, -3]\nd:\n", "resume:\nsave_by: null\n",
])
def test_data_yaml_forms_equal_pyyaml(text):
    assert parse_yaml(text) == yaml.safe_load(text)


def _tiny_data(tmp_path):
    for split in ("train", "valid"):
        for kind in ("images", "labels"):
            (tmp_path / split / kind).mkdir(parents=True)
    (tmp_path / "data.yaml").write_text("train: train/images\nval: val/images\n"
                                        "names: [red, green]\n")
    return str(tmp_path / "data.yaml")


def test_load_configs_and_merged_config_round_trip(tmp_path, monkeypatch):
    from yololite_tpu.config.config import load_configs as jax_load_configs
    from yololite_tpu_torch.config import dump_yaml, load_configs, save_merged_config
    data = _tiny_data(tmp_path)
    model = os.path.join(ROOT, "configs", "models", "edge_n.yaml")
    train = os.path.join(ROOT, "configs", "train", "standard_train.yaml")
    got = load_configs(model, train, data, make_run_dir=False)
    want = jax_load_configs(model, train, data, make_run_dir=False)
    assert got == want                      # 'val' falls back to valid/, nc from names
    got["training"]["lr"] = 1e-05           # a float PyYAML would misread as '1e-05'
    got["dataset"]["names"].append("it's: odd, #1")
    path = save_merged_config(got, str(tmp_path / "run"))
    with open(path) as f:
        assert yaml.safe_load(f) == got
    assert read_yaml(path) == got
    assert parse_yaml(dump_yaml(want)) == want
    monkeypatch.chdir(tmp_path)             # the recipe's log_dir is relative
    run_dirs = [load_configs(model, train, data)["logging"]["log_dir"] for _ in range(2)]
    assert [os.path.basename(r) for r in run_dirs] == ["1", "2"]
    assert os.path.realpath(tmp_path / "runs" / "train" / "latest") == run_dirs[1]
