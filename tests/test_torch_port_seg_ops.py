"""PyTorch port parity, mask ops (`ops/masks.py`) against the JAX package's
`ops/masks.py` on the same numpy-seeded inputs (CPU).

Tolerances, each with its reason:
  - the box crop: exact, also for boxes whose edges sit on pixel centres and
    for a prototype grid whose step (img_size / Hp) is not a binary fraction
    (both round that step to fp32 before the multiply);
  - assembled masks: 1e-6 absolute (probabilities; an fp32 matmul over K
    summed in another order), and equal after the crop's zeros;
  - the upsample: 1e-6 absolute, and binarized equal away from 0.5 +- 1e-6;
  - RLE encode / decode / area, box rasterization: exact (the same numpy
    code); `assemble_masks_np`: exact (the same numpy code).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.ops import masks as jm

from yololite_tpu_torch.ops import masks as pm


def _case(seed, b=2, d=7, hp=24, k=8, img=100.0):
    rng = np.random.RandomState(seed)
    protos = rng.normal(0, 1, (b, hp, hp, k)).astype(np.float32)
    coef = np.tanh(rng.normal(0, 1, (b, d, k))).astype(np.float32)
    xy = rng.uniform(-10, img, (b, d, 2))
    wh = rng.uniform(1, img / 2, (b, d, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # edges exactly on pixel centres, as the fp32 grid computes them
    step = np.float32(img / hp)
    centres = (np.arange(hp, dtype=np.float32) + np.float32(0.5)) * step
    boxes[:, 0, :] = [centres[2], centres[4], centres[9], centres[13]]
    boxes[:, 1, :] = [centres[0], centres[0], centres[hp - 1], centres[hp - 1]]
    return protos, coef, boxes


@pytest.mark.parametrize("img,hp", [(100.0, 24), (64.0, 16), (640.0, 160)])
def test_crop_is_exact_on_pixel_centres(img, hp):
    protos, coef, boxes = _case(1, hp=hp, img=img)
    ones = np.ones((2, 7, hp, hp), np.float32)
    want = np.stack([np.asarray(jm.crop_mask_to_box(jnp.asarray(ones[i]),
                                                     jnp.asarray(boxes[i]), img))
                     for i in range(2)])
    got = pm.crop_mask_to_box(torch.from_numpy(ones), torch.from_numpy(boxes), img).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1 and want[:, 1].sum() > 0     # the edge boxes keep pixels


def test_assemble_masks_match_jax():
    protos, coef, boxes = _case(2)
    want = np.asarray(jm.assemble_masks_batch(jnp.asarray(protos), jnp.asarray(coef),
                                              jnp.asarray(boxes), 100.0))
    got = pm.assemble_masks_batch(torch.from_numpy(protos), torch.from_numpy(coef),
                                  torch.from_numpy(boxes), 100.0).numpy()
    assert got.shape == want.shape == (2, 7, 24, 24)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)
    for crop, logits in ((False, False), (True, True), (False, True)):
        w1 = np.asarray(jm.assemble_masks(jnp.asarray(protos[0]), jnp.asarray(coef[0]),
                                          jnp.asarray(boxes[0]), 100.0, crop, logits))
        g1 = pm.assemble_masks(torch.from_numpy(protos[0]), torch.from_numpy(coef[0]),
                               torch.from_numpy(boxes[0]), 100.0, crop, logits).numpy()
        np.testing.assert_allclose(g1, w1, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        pm.assemble_masks_np(protos[0], coef[0], boxes[0], 100.0),
        jm.assemble_masks_np(protos[0], coef[0], boxes[0], 100.0))
    # with a gradient the assembly runs out of place: the same values, and
    # its gradient is JAX's
    tp = torch.from_numpy(protos).requires_grad_(True)
    g = pm.assemble_masks_batch(tp, torch.from_numpy(coef), torch.from_numpy(boxes), 100.0)
    np.testing.assert_array_equal(g.detach().numpy(), got)
    g.sum().backward()
    wg = jax.grad(lambda p: jm.assemble_masks_batch(p, jnp.asarray(coef), jnp.asarray(boxes),
                                                    100.0).sum())(jnp.asarray(protos))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wg), atol=1e-5, rtol=0)
    # the crop leaves its input alone
    ones = torch.ones(2, 7, 24, 24)
    pm.crop_mask_to_box(ones, torch.from_numpy(boxes), 100.0)
    assert bool((ones == 1).all())


def test_upsample_masks_match_jax():
    rng = np.random.RandomState(3)
    m = rng.rand(2, 3, 16, 16).astype(np.float32)
    want = np.asarray(jm.upsample_masks(jnp.asarray(m), (64, 64), threshold=None))
    got = pm.upsample_masks(torch.from_numpy(m), (64, 64), threshold=None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    wb = np.asarray(jm.upsample_masks(jnp.asarray(m), (64, 64)))
    gb = pm.upsample_masks(torch.from_numpy(m), (64, 64)).numpy()
    assert gb.dtype == np.uint8
    far = np.abs(want - 0.5) > 1e-6
    np.testing.assert_array_equal(gb[far], wb[far])


def test_rle_helpers_and_box_rasterization_are_exact():
    rng = np.random.RandomState(4)
    for shape in ((1, 1), (5, 7), (33, 20)):
        for p in (0.0, 0.3, 1.0):
            mask = (rng.rand(*shape) < p).astype(np.uint8)
            got, want = pm.rle_encode_np(mask), jm.rle_encode_np(mask)
            assert got["size"] == want["size"]
            np.testing.assert_array_equal(got["counts"], want["counts"])
            assert got["counts"].dtype == want["counts"].dtype
            np.testing.assert_array_equal(pm.rle_decode_np(got), jm.rle_decode_np(want))
            np.testing.assert_array_equal(pm.rle_decode_np(got), mask)
            assert pm.rle_area(got) == jm.rle_area(want) == int(mask.sum())
    boxes = rng.uniform(-5, 70, (6, 4)).astype(np.float32)
    np.testing.assert_array_equal(pm.rasterize_box_masks_np(boxes, 64, 16),
                                  jm.rasterize_box_masks_np(boxes, 64, 16))
