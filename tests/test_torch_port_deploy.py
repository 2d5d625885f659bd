"""PyTorch port: deploy rewrites (normalize folding, head fusion).

The folded, fused port on raw uint8 must equal (a) its own unfolded, split
forward on the normalized image and (b) the JAX folded, fused forward, at
rtol = atol = 1e-4 in fp32. Folding is exact algebra but moves the rounding
(the stem kernel is scaled by 1/(255*std) before the sum, and the bias term
arrives through a second convolution), so outputs agree to float rounding
accumulated through the network, not bit for bit.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.deploy.fold_norm import fold_normalization as jax_fold
from yololite_tpu.deploy.fold_norm import folded_stem as jax_folded_stem
from yololite_tpu.deploy.fold_norm import raw_cast as jax_raw_cast
from yololite_tpu.deploy.fuse_head import fuse_head_params as jax_fuse

from tests.test_torch_port_models import edge_cfg, jax_edge, port_from
from yololite_tpu_torch.deploy.fold_norm import (
    FoldedStemConv, fold_normalization, folded_stem, normalize_images, raw_cast,
)
from yololite_tpu_torch.deploy.fuse_head import fuse_head_params
from yololite_tpu_torch.models.detector import build_model_from_config

IMG = 64


def _u8(seed=0):
    return (np.random.RandomState(seed).rand(2, IMG, IMG, 3) * 255).astype(np.uint8)


def _port_folded_fused(params, bs):
    sd = port_from(None, params, bs, IMG).state_dict()
    sd, folded = fold_normalization(sd)
    sd, fused = fuse_head_params(sd)
    assert folded and fused
    assert "head3.fused_out.weight" in sd and "head3.box.weight" not in sd
    m = build_model_from_config(edge_cfg(IMG), fused_head=True)
    m.load_state_dict(sd)
    return folded_stem(m).eval()


def test_folded_fused_matches_unfolded_and_jax():
    m_jax, params, bs = jax_edge(IMG)
    u8 = _u8()
    x_u8 = torch.from_numpy(u8).permute(0, 3, 1, 2)

    port = port_from(m_jax, params, bs, IMG)
    port_ff = _port_folded_fused(params, bs)
    assert isinstance(port_ff.backbone.ConvBNAct_0.Conv_0, FoldedStemConv)
    with torch.no_grad():
        ref = port(normalize_images(x_u8, torch.float32))
        got = port_ff(raw_cast(x_u8, torch.float32))

    fp, fbs, ok = jax_fold(params, bs)
    assert ok
    fp, ok = jax_fuse(fp)
    m_ff = dataclasses.replace(m_jax, fused_head=True)

    def jax_fn(v, x):
        with jax_folded_stem():
            return m_ff.apply(v, jax_raw_cast(x, jnp.float32), train=False)
    want = jax.jit(jax_fn)({"params": fp, "batch_stats": fbs}, jnp.asarray(u8))

    for g, r, w in zip(got, ref, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_fold_and_fuse_are_noops_when_not_applicable():
    sd = {"lateral3.weight": torch.zeros(4, 4, 1, 1)}
    assert fold_normalization(sd) == (sd, False)
    assert fuse_head_params(sd) == (sd, False)


def test_correction_map_cached_per_size():
    _, params, bs = jax_edge(IMG)
    conv = _port_folded_fused(params, bs).backbone.ConvBNAct_0.Conv_0
    a = conv.correction(IMG, IMG)
    assert conv.correction(IMG, IMG) is a
    assert tuple(a.shape) == (1, conv.out_channels, IMG // 2, IMG // 2)
    assert tuple(conv.correction(96, 96).shape[2:]) == (48, 48)


def test_focus_stem_folds_like_jax():
    """cs3darknet_focus_s (configs/custom/custom.yaml): the stem conv sees 12
    channels after the 2x2 space-to-depth, so the slope is tiled 4 times and
    the correction map is built from a 12-channel constant image."""
    from tests.test_torch_port_zoo_detectors import (
        config, jax_model, jax_variables, port_model,
    )
    rel = "configs/custom/custom.yaml"
    m_jax, (params, bs) = jax_model(rel), jax_variables(rel)
    u8 = _u8(seed=4)
    x_u8 = torch.from_numpy(u8).permute(0, 3, 1, 2)

    port = port_model(rel, params, bs)
    sd, folded = fold_normalization(port.state_dict())
    sd, fused = fuse_head_params(sd)
    assert folded and fused
    key = "backbone.Focus_0.ConvBNAct_0.Conv_0.weight"
    assert sd[key].shape[1] == 12 and not torch.equal(sd[key], port.state_dict()[key])
    port_ff = build_model_from_config(config(rel), fused_head=True)
    port_ff.load_state_dict(sd)
    folded_stem(port_ff).eval()
    stem = port_ff.backbone.Focus_0.ConvBNAct_0.Conv_0
    assert isinstance(stem, FoldedStemConv)
    assert tuple(stem.correction(IMG // 2, IMG // 2).shape) == (1, stem.out_channels,
                                                              IMG // 2, IMG // 2)
    with torch.no_grad():
        ref = port(normalize_images(x_u8, torch.float32))
        got = port_ff(raw_cast(x_u8, torch.float32))

    fp, fbs, ok = jax_fold(params, bs)
    assert ok
    fp, ok = jax_fuse(fp)
    m_ff = dataclasses.replace(m_jax, fused_head=True)

    def jax_fn(v, x):
        with jax_folded_stem():
            return m_ff.apply(v, jax_raw_cast(x, jnp.float32), train=False)
    want = jax.jit(jax_fn)({"params": fp, "batch_stats": fbs}, jnp.asarray(u8))

    for g, r, w in zip(got, ref, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
