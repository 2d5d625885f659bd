"""PyTorch port parity: the backbone zoo's spec tables, its blocks and the
weight bridge's Dense/LayerNorm/GRN leaves, against the JAX package.

Tolerance: rtol = atol = 1e-4 on block outputs, fp32 on the CPU, as
tests/test_torch_port_models.py states: both sides run the same fp32 ops in
different summation orders (XLA vs oneDNN/ATen), which moves O(1) outputs by
~1e-6; 1e-4 still catches any wrong weight, layout, name or activation.
BatchNorm statistics, LayerNorm and GRN parameters and every bias are
randomized, so a wrong mapping of any of them shows in the outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.models import layers as jl
from yololite_tpu.models.backbones import zoo as jzoo

from tests.test_torch_port_models import randomize_bn
from yololite_tpu_torch.convert import from_flax, load_flax
from yololite_tpu_torch.models import layers as tl
from yololite_tpu_torch.models.backbones import zoo as tzoo
from yololite_tpu_torch.models.detector import count_params

# the three backbones that no shipped config uses (the others are run whole
# in tests/test_torch_port_zoo_detectors.py)
UNUSED_BY_CONFIGS = ["resnet18", "cs3darknet_focus_m", "mobilenetv3_large_100"]


def randomize(params, batch_stats, seed: int = 1):
    """randomize_bn, plus random LayerNorm scale/bias, GRN gamma/beta and
    conv/Dense biases (flax initialises all of these to constants)."""
    params, batch_stats = randomize_bn(params, batch_stats, seed)
    rng = np.random.RandomState(seed + 1)

    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = v if k.startswith("BatchNorm_") else walk(v, k)
                continue
            v = np.asarray(v)
            if parent.startswith("LayerNorm_") and k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif parent.startswith("GRN_") or k == "bias":
                v = rng.normal(0, 0.5 if parent.startswith("GRN_") else 0.1, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(params), batch_stats


def random_vars(module, x, seed: int = 0, train_arg: bool = True):
    """Random flax variables for `module` on input `x`, without running its
    init (jax.eval_shape gives the tree; compiling an init costs seconds):
    kernels U(+-sqrt(3/fan_in)), unit variance gain, so that a deep net keeps
    O(1) outputs and atol 1e-4 checks them (flax's torch-style bound, three
    times smaller in variance, fades a detector's outputs to ~0.01); then
    `randomize` for everything else."""
    init = (lambda k, x: module.init(k, x, train=False)) if train_arg else module.init
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if path[-1].key != "kernel":
            return np.zeros(s.shape, np.float32)
        bound = np.sqrt(3.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return randomize(v["params"], v.get("batch_stats", {}), seed + 1)


def run_jax(module, params, bs, x, train_arg: bool = True):
    variables = {"params": params, "batch_stats": bs} if bs else {"params": params}
    if train_arg:
        return np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
            variables, jnp.asarray(x)))
    return np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))


def run_jax_all(module, params, bs, x):
    """Eval-mode apply of a module that returns a list of maps."""
    return [np.asarray(o) for o in jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))]


def nhwc(b, hw, c, seed=0):
    return np.random.RandomState(seed).normal(0, 1, (b, hw, hw, c)).astype(np.float32)


# --------------------------------------------------------------------------- #
def test_backbone_names_equal_jax():
    assert tzoo.BACKBONES == jzoo.BACKBONES
    assert len(tzoo.BACKBONES) == 16


@pytest.mark.parametrize("name", jzoo.BACKBONES)
def test_spec_table_equals_jax(name):
    assert tzoo._specs()[name] == jzoo._specs()[name]
    assert tzoo.backbone_feature_info(name) == jzoo.backbone_feature_info(name)


@pytest.mark.parametrize("name", jzoo.BACKBONES)
def test_backbone_loads_jax_variables_exactly(name):
    """Every backbone: zeros shaped like the flax variables load with no
    missing or leftover key, and the parameter counts agree."""
    module, _ = jzoo.build_backbone(name)
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port, info = tzoo.build_backbone(name)
    load_flax(port, zeros["params"], zeros["batch_stats"])
    assert count_params(port) == sum(int(np.prod(s.shape))
                                     for s in jax.tree.leaves(shapes["params"]))
    assert info == jzoo.backbone_feature_info(name)


@pytest.mark.parametrize("name", UNUSED_BY_CONFIGS)
def test_backbone_forward_matches_jax(name):
    module, _ = jzoo.build_backbone(name)
    x = nhwc(2, 32, 3)
    params, bs = random_vars(module, x)
    port, _ = tzoo.build_backbone(name)
    load_flax(port, params, bs).eval()
    want = run_jax_all(module, params, bs, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.1        # features keep their scale
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=1e-4)


# (JAX module, port module, input channels, input size)
BLOCKS = {
    "mb-expand1-residual": (jl.MBConv(16, expand=1.0, kernel=3, act="relu6"),
                            tl.MBConv(16, 16, expand=1.0, kernel=3, act="relu6"), 16, 16),
    "mb-se-stride2-k5": (jl.MBConv(24, expand=6.0, kernel=5, stride=2, se_ratio=0.25,
                                   act="silu"),
                         tl.MBConv(8, 24, expand=6.0, kernel=5, stride=2, se_ratio=0.25,
                                   act="silu"), 8, 16),
    "mb-se-hardswish": (jl.MBConv(16, expand=3.0, kernel=3, se_ratio=0.25,
                                  act="hardswish"),
                        tl.MBConv(16, 16, expand=3.0, kernel=3, se_ratio=0.25,
                                  act="hardswish"), 16, 16),
    "mb-expand2.3": (jl.MBConv(16, expand=2.3, act="relu"),
                     tl.MBConv(16, 16, expand=2.3, act="relu"), 16, 16),
    "fused-expand1": (jl.FusedMBConv(16, expand=1.0), tl.FusedMBConv(16, 16, expand=1.0),
                      16, 16),
    "fused-expand4-stride2": (jl.FusedMBConv(16, expand=4.0, stride=2),
                              tl.FusedMBConv(8, 16, expand=4.0, stride=2), 8, 16),
    "basic-identity": (jl.BasicBlock(16), tl.BasicBlock(16, 16), 16, 16),
    "basic-shortcut": (jl.BasicBlock(16, stride=2), tl.BasicBlock(8, 16, stride=2), 8, 16),
    "convnextv2": (jl.ConvNeXtV2Block(16), tl.ConvNeXtV2Block(16, 16), 16, 16),
    "csp-residual": (jl.CSPBottleneck(16), tl.CSPBottleneck(16, 16), 16, 16),
    "csp-no-residual": (jl.CSPBottleneck(16), tl.CSPBottleneck(8, 16), 8, 16),
    "cs3-n2": (jl.CS3Stage(16, n=2), tl.CS3Stage(8, 16, n=2), 8, 16),
    "focus": (jl.Focus(16, kernel=3), tl.Focus(3, 16, kernel=3), 3, 16),
    "hg": (jl.HGBlock(8, 32, layers=3), tl.HGBlock(16, 8, 32, layers=3), 16, 16),
    "hg-residual": (jl.HGBlock(8, 32, layers=3, residual=True),
                    tl.HGBlock(32, 8, 32, layers=3, residual=True), 32, 16),
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_matches_jax(case):
    jmod, tmod, cin, hw = BLOCKS[case]
    x = nhwc(2, hw, cin)
    params, bs = random_vars(jmod, x)
    want = run_jax(jmod, params, bs, x)
    load_flax(tmod, params, bs).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_squeeze_excite_matches_jax():
    """Sigmoid gate (not hard sigmoid), biased 1x1 convs."""
    jmod, tmod = jl.SqueezeExcite(4, act="silu"), tl.SqueezeExcite(16, 4, act="silu")
    x = nhwc(2, 8, 16)
    params, _ = random_vars(jmod, x, train_arg=False)
    want = run_jax(jmod, params, {}, x, train_arg=False)
    load_flax(tmod, params, {})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grn_matches_jax(dtype):
    """GRN on NHWC: the sum of squares in fp32 and the `+ x` in fp32 for any
    input dtype. bf16 is compared at bf16's resolution (2^-8 relative)."""
    x = nhwc(2, 8, 16) * 3
    params, _ = random_vars(jl.GRN(), x, train_arg=False)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax.jit(jl.GRN(dtype=jdt).apply)(
        {"params": params}, jnp.asarray(x, jdt)).astype(jnp.float32))
    tmod = tl.GRN(16)
    tmod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(dtype)).float()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_bridge_dense_layernorm_grn_leaves():
    rng = np.random.RandomState(0)
    k = rng.rand(3, 5).astype(np.float32)
    params = {"Dense_0": {"kernel": k, "bias": np.arange(5, dtype=np.float32)},
              "LayerNorm_0": {"scale": np.full(3, 2.0, np.float32),
                              "bias": np.ones(3, np.float32)},
              "GRN_0": {"gamma": np.full(5, 3.0, np.float32),
                        "beta": np.full(5, 4.0, np.float32)}}
    sd = from_flax(params, {})
    assert sorted(sd) == ["Dense_0.bias", "Dense_0.weight", "GRN_0.beta", "GRN_0.gamma",
                          "LayerNorm_0.bias", "LayerNorm_0.weight"]
    np.testing.assert_array_equal(sd["Dense_0.weight"].numpy(), k.T)   # (out, in)
    assert float(sd["LayerNorm_0.weight"][0]) == 2.0
    assert float(sd["GRN_0.gamma"][0]) == 3.0 and float(sd["GRN_0.beta"][0]) == 4.0
    for bad, err in [({"GRN_0": {"scale": np.ones(2)}}, KeyError),
                     ({"LayerNorm_0": {"mean": np.ones(2)}}, KeyError),
                     ({"Dense_0": {"embedding": np.ones((2, 2))}}, KeyError),
                     ({"Conv_0": {"kernel": np.ones((3, 3, 2))}}, ValueError)]:
        with pytest.raises(err):
            from_flax(bad, {})
