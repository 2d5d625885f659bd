"""PyTorch port parity: layers / backbone zoo / detector against the flax
modules, through the weight bridge (yololite_tpu_torch.convert).

Tolerance: rtol = atol = 1e-4 on every level output, fp32 on the CPU. Both
sides run the same fp32 convolutions but sum in different orders (XLA vs
oneDNN/ATen), which moves outputs of O(1..10) by ~1e-6 relative; 1e-4 leaves
room for the ~30 layers of accumulation and still catches any wrong weight,
layout or upsample index.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.deploy.fuse_head import fuse_head_params as jax_fuse_head_params
from yololite_tpu.models.detector import build_model_from_config as jax_build
from yololite_tpu.models.detector import count_params as jax_count_params
from yololite_tpu.models.layers import upsample_nearest_to as jax_upsample

from yololite_tpu_torch.convert import from_flax, load_flax
from yololite_tpu_torch.models.detector import build_model_from_config, count_params
from yololite_tpu_torch.models.layers import upsample_nearest_to

EDGE_N = {"arch": "YOLOLiteMS_CPU", "backbone": "mobilenetv4_conv_small_050",
          "depth_multiple": 0.65, "width_multiple": 0.60, "fpn_channels": 160,
          "head_depth": 1, "num_classes": 3, "num_anchors_per_level": 1}


def edge_cfg(img: int, **model_overrides):
    return {"model": dict(EDGE_N, **model_overrides), "training": {"img_size": img}}


def randomize_bn(params, batch_stats, seed: int = 1):
    """Non-identity BatchNorm statistics and affine terms, so a wrong BN
    mapping in the bridge shows up in the outputs."""
    rng = np.random.RandomState(seed)

    def walk(p, s):
        p_out, s_out = {}, {}
        for k, v in p.items():
            if k.startswith("BatchNorm_"):
                c = np.asarray(v["scale"]).shape[0]
                p_out[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.normal(0, 0.1, c).astype(np.float32)}
                s_out[k] = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            elif isinstance(v, dict):
                p_out[k], sub = walk(v, s.get(k, {}))
                if sub:
                    s_out[k] = sub
            else:
                p_out[k] = np.asarray(v)
        return p_out, s_out

    return walk(params, batch_stats)


@functools.lru_cache(maxsize=None)
def _jax_edge(img: int, overrides: tuple):
    m = jax_build(edge_cfg(img, **dict(overrides)), dtype=jnp.float32)
    v = jax.jit(lambda key, x: m.init({"params": key}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3), jnp.float32))
    params, bs = randomize_bn(jax.tree.map(np.asarray, v["params"]),
                              jax.tree.map(np.asarray, v["batch_stats"]))
    return m, params, bs


def jax_edge(img: int, **overrides):
    """(flax model, params, batch_stats) of an edge_n variant at `img`,
    seed 0 with randomized BatchNorm; cached, so callers must not mutate."""
    return _jax_edge(img, tuple(sorted(overrides.items())))


def jax_apply(m, params, bs, x):
    return jax.jit(lambda v, x: m.apply(v, x, train=False))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))


def port_from(m_jax, params, bs, img: int, fused: bool = False, **overrides):
    m = build_model_from_config(edge_cfg(img, **overrides), fused_head=fused)
    return load_flax(m, params, bs).eval()


def images(img: int, n: int = 2, seed: int = 0):
    return np.random.RandomState(seed).normal(0, 1, (n, img, img, 3)).astype(np.float32)


@pytest.mark.parametrize("img,fused,overrides", [
    (64, False, {}),
    (80, False, {}),                       # 3 -> 5 upsample: nearest-exact
    (64, True, {}),
    (80, False, {"depth_multiple": 1.0}),  # DWConvBlock n=2 naming
    (64, False, {"arch": "YOLOLiteMS", "use_p6": True}),  # ConvBlock + P6 head
    (64, False, {"use_p2": True}),         # P2 level: lateral2/smooth2/head2
], ids=["img64-split", "img80-split", "img64-fused", "img80-dw2", "full-p6", "p2"])
def test_detector_forward_matches_jax(img, fused, overrides):
    m_jax, params, bs = jax_edge(img, **overrides)
    if fused:
        import dataclasses
        params, ok = jax_fuse_head_params(params)
        assert ok
        m_jax = dataclasses.replace(m_jax, fused_head=True)
    x = images(img)
    want = jax_apply(m_jax, params, bs, x)
    port = port_from(m_jax, params, bs, img, fused=fused, **overrides)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_param_count_and_p6_registered():
    m_jax, params, _ = jax_edge(64)
    port = build_model_from_config(edge_cfg(64))
    assert count_params(port) == jax_count_params(params) == 549_640
    # P6 modules exist for checkpoint round-trips even though use_p6 is off
    assert "p6_down.Conv_0.weight" in port.state_dict()
    assert "smooth6.Conv_1.weight" in port.state_dict()


@pytest.mark.parametrize("hw,target", [((3, 3), (5, 5)), ((5, 5), (10, 10)),
                                       ((4, 6), (7, 13))])
def test_upsample_matches_jax_resize(hw, target):
    x = np.random.RandomState(0).rand(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x), target))
    got = upsample_nearest_to(torch.from_numpy(x).permute(0, 3, 1, 2), target)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_bridge_layouts_and_key_checks():
    _, params, bs = jax_edge(64)
    sd = from_flax(params, bs)
    k = np.asarray(params["backbone"]["UIB_0"]["ConvBNAct_0"]["Conv_0"]["kernel"])
    assert k.shape == (5, 5, 1, 32)               # 5x5 depthwise dw_start conv
    w = sd["backbone.UIB_0.ConvBNAct_0.Conv_0.weight"]
    assert tuple(w.shape) == (32, 1, 5, 5)
    np.testing.assert_array_equal(w.numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["smooth3.BatchNorm_0.running_var"].numpy(),
        np.asarray(bs["smooth3"]["BatchNorm_0"]["var"]))
    port = build_model_from_config(edge_cfg(64))
    missing = {k: v for k, v in params.items() if k != "lateral3"}
    with pytest.raises(KeyError, match="missing"):
        load_flax(port, missing, bs)
    extra = dict(params, extra_conv={"kernel": np.zeros((1, 1, 2, 2), np.float32)})
    with pytest.raises(KeyError, match="leftover"):
        load_flax(port, extra, bs)


def test_unported_options_raise():
    from yololite_tpu_torch.models.backbones import build_backbone
    with pytest.raises(KeyError, match="Unknown backbone"):
        build_backbone("no_such_backbone")
    # segmentation is ported: with_masks (or task: segment) builds the
    # ProtoNet and the mask-coefficient heads
    for overrides in ({"with_masks": True}, {"task": "segment"}):
        seg = build_model_from_config(edge_cfg(64, **overrides))
        assert seg.with_masks and hasattr(seg, "protonet") and hasattr(seg.head3, "mcoef")
    # training, its augmentation, data and spatial parallelism are ported
    # (a spatial mesh on cuda needs a card a rank, as JAX's make_mesh a
    # device); the orbax backend still raises
    from yololite_tpu_torch.train.loop import train_from_config
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=f"mesh 1x{n} needs {n} devices"):
        train_from_config({"model": {}, "training": {"augment": True, "spatial_parallel": n}},
                          device="cuda")
    with pytest.raises(NotImplementedError, match="item 8c"):
        train_from_config({"model": {}, "training": {"augment": False,
                                                     "checkpoint_backend": "orbax_async"}},
                          device="cpu")
