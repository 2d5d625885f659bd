"""PyTorch port parity: anchors and anchor-free decode against the JAX ops.

Tolerance: rtol = atol = 1e-5 in fp32. The ops are elementwise, but
sigmoid/softplus/exp are computed by different library routines (XLA vs
ATen), which differ by a few ulp; boxes are O(100) px, so 1e-5 relative is
~1e-3 px at the image edge.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yololite_tpu.ops.anchors import level_shapes_for as jax_level_shapes
from yololite_tpu.ops.anchors import make_anchors as jax_make_anchors
from yololite_tpu.ops.decode import decode_anchorfree as jax_decode_anchorfree
from yololite_tpu.ops.decode import decode_flat as jax_decode_flat

from yololite_tpu_torch.ops.anchors import level_shapes_for, make_anchors
from yololite_tpu_torch.ops.decode import decode_anchorfree, decode_flat

IMG = 80
SHAPES = ((10, 10), (5, 5), (3, 3))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_anchors_match():
    assert level_shapes_for(IMG, (8, 16, 32)) == jax_level_shapes(IMG, (8, 16, 32))
    pts, strides = make_anchors(SHAPES, IMG, device="cpu")
    jp, js = jax_make_anchors(SHAPES, IMG)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(js))


@pytest.mark.parametrize("exp_clamp", [(-4.0, 4.0), (-10.0, 8.0)])
@pytest.mark.parametrize("wh_mode", ["v8", "softplus", "exp"])
@pytest.mark.parametrize("center_mode", ["v8", "simple"])
def test_decode_flat_matches(center_mode, wh_mode, exp_clamp):
    n = sum(h * w for h, w in SHAPES)
    preds = np.random.RandomState(0).normal(0, 4, (2, n, 5 + 3 + 4)).astype(np.float32)
    pts, strides = jax_make_anchors(SHAPES, IMG)
    kw = dict(center_mode=center_mode, wh_mode=wh_mode, exp_clamp=exp_clamp,
              img_size=IMG, num_classes=3)
    want = jax_decode_flat(jnp.asarray(preds), pts, strides, **kw)
    got = decode_flat(torch.from_numpy(preds), torch.tensor(np.asarray(pts)),
                      torch.tensor(np.asarray(strides)), **kw)
    for key in ("box", "obj", "cls", "ctr", "wh", "coef"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        _close(got[key], want[key])


@pytest.mark.parametrize("clamp", [True, False])
def test_decode_anchorfree_matches(clamp):
    rng = np.random.RandomState(1)
    levels = [rng.normal(0, 3, (2, 1, h, w, 8)).astype(np.float32) for h, w in SHAPES]
    want = jax_decode_anchorfree([jnp.asarray(x) for x in levels], IMG, clamp=clamp)
    got = decode_anchorfree([torch.from_numpy(x) for x in levels], IMG, clamp=clamp)
    for key in ("box", "obj", "cls", "coef"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        _close(got[key], want[key])
