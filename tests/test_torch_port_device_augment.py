"""PyTorch port parity: photometric augmentation on the device
(`data/device_augment.py`) against the JAX package's `photometric_augment`
(CPU).

jax.random streams cannot be reproduced in torch, so the port is held to the
reference in two parts:
  - `apply` on JAX's own draws (rebuilt key by key as `photometric_augment`
    draws them) equals JAX's output within 1 level: the same float32 colour
    product, summed in another order, may round the other way at a half;
  - `draw` has JAX's distribution: branch and probability frequencies within
    5 standard errors at 200,000 images, and each branch's matrix and bias
    means within 5 standard errors of JAX's own draws at 50,000.
The hue and saturation matrices equal JAX's to 1e-6; zero probabilities are
the identity.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yololite_tpu.data import device_augment as J

from yololite_tpu_torch.data import device_augment as P


def _jax_draws(key, shape, p_color, p_noise):
    """Every random number of J.photometric_augment(images, key), rebuilt."""
    batch = shape[0]
    k_color, k_noise, k_gauss, k_sigma, _k_which, k_dir = jax.random.split(key, 6)
    m, b = J._color_params(k_color, batch, p_color)
    u = np.asarray(jax.random.uniform(k_noise, (batch,)))
    sigma = jnp.sqrt(jax.random.uniform(k_sigma, (batch,), minval=5.0, maxval=20.0))
    return {"m": torch.tensor(np.asarray(m)), "b": torch.tensor(np.asarray(b)),
            "do_noise": torch.from_numpy(u < p_noise * 0.5),
            "do_blur": torch.from_numpy((u >= p_noise * 0.5) & (u < p_noise)),
            "sigma": torch.tensor(np.asarray(sigma)),
            "noise": torch.tensor(np.asarray(jax.random.normal(k_gauss, shape, jnp.float32))),
            "horizontal": torch.tensor(np.asarray(jax.random.uniform(k_dir, (batch,))) < 0.5)}


@pytest.mark.parametrize("p_color,p_noise", [(0.4, 0.15), (1.0, 1.0), (0.7, 0.5)])
def test_apply_on_jax_draws_matches_jax(p_color, p_noise):
    rng = np.random.RandomState(0)
    images = (rng.rand(16, 24, 40, 3) * 255).astype(np.uint8)
    images[:, 8:16] = rng.randint(0, 256, (16, 1, 1, 3))
    differ = 0
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(J.photometric_augment(jnp.asarray(images), key, p_color, p_noise))
        draws = _jax_draws(key, images.shape, p_color, p_noise)
        got = P.apply(torch.from_numpy(images), draws).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1
        differ += int((d > 0).sum())
    assert differ <= 1e-3 * 6 * images.size


def test_hue_and_saturation_matrices_match_jax():
    theta = np.linspace(-math.pi, math.pi, 37).astype(np.float32)
    np.testing.assert_allclose(P.hue_matrix(torch.from_numpy(theta)).numpy(),
                               np.asarray(J._hue_matrix(jnp.asarray(theta))), atol=1e-6, rtol=0)
    s = np.linspace(0.5, 1.5, 21).astype(np.float32)
    np.testing.assert_allclose(P.saturation_matrix(torch.from_numpy(s)).numpy(),
                               np.asarray(J._saturation_matrix(jnp.asarray(s))),
                               atol=1e-6, rtol=0)


def test_zero_probabilities_are_the_identity():
    images = torch.from_numpy((np.random.RandomState(1).rand(4, 9, 11, 3) * 255)
                              .astype(np.uint8))
    out = P.photometric_augment(images, torch.Generator().manual_seed(3), 0.0, 0.0)
    assert torch.equal(out, images)


def _within(share, p, n, k=5.0):
    return abs(share - p) <= k * math.sqrt(p * (1 - p) / n)


def test_draw_frequencies():
    n = 200_000
    d = P.draw((n, 1, 1, 3), torch.Generator().manual_seed(0), 0.4, 0.15)
    on = d["color_on"].numpy()
    assert _within(on.mean(), 0.4, n)
    branch = d["branch"].numpy()
    for k in range(5):
        assert _within((branch == k).mean(), 0.2, n)
    assert _within(d["do_noise"].float().mean().item(), 0.075, n)
    assert _within(d["do_blur"].float().mean().item(), 0.075, n)
    assert not (d["do_noise"] & d["do_blur"]).any()
    assert _within(d["horizontal"].float().mean().item(), 0.5, n)
    s2 = d["sigma"].numpy().astype(np.float64) ** 2
    assert 5.0 <= s2.min() and s2.max() <= 20.0
    assert abs(s2.mean() - 12.5) <= 5 * math.sqrt(15.0 ** 2 / 12 / n)
    off = ~on
    eye = np.eye(3, dtype=np.float32)
    assert (d["m"].numpy()[off] == eye).all() and (d["b"].numpy()[off] == 0).all()
    shuffle = on & (branch == 4)
    perms = {tuple(np.argmax(m, 1)) for m in d["m"].numpy()[shuffle]}
    assert perms == {tuple(p) for p in P.PERMS}


def test_branch_moments_match_jax_draws():
    """Each branch's mean matrix and bias (and their spread) from the port's
    draws against JAX's own at 50,000 images with p_color = 1."""
    n = 50_000
    pm = P.color_params(n, torch.Generator().manual_seed(7), 1.0)
    jm, jb = (np.asarray(a) for a in J._color_params(jax.random.PRNGKey(7), n, 1.0))
    # JAX's branch index: the draw it makes last (ks[9] of 10 splits)
    jbranch = np.asarray(jax.random.randint(jax.random.split(jax.random.PRNGKey(7), 10)[9],
                                            (n,), 0, 5))
    for k in range(5):
        sel_p = pm["branch"].numpy() == k
        sel_j = jbranch == k
        for a, b in ((pm["m"].numpy()[sel_p], jm[sel_j]), (pm["b"].numpy()[sel_p], jb[sel_j])):
            se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b)) + 1e-7
            assert (np.abs(a.mean(0) - b.mean(0)) <= 5 * se).all(), k
            np.testing.assert_allclose(a.std(0), b.std(0), rtol=0.05, atol=1e-6)


def test_train_step_stream_is_keyed_by_micro_step():
    """The Trainer's generator for a micro-step gives the same draws each
    time (a resumed run replays them) and other draws for another step."""
    from yololite_tpu_torch.train.steps import Trainer

    class _Stub(torch.nn.Module):
        pass

    cfg = {"training": {"device_augment": True, "augment": True, "seed": 3}}
    tr = Trainer(_Stub(), cfg, device="cpu")
    assert tr.device_augment
    a = P.draw((2, 4, 4, 3), tr.aug_generator(5))
    b = P.draw((2, 4, 4, 3), tr.aug_generator(6))
    c = P.draw((2, 4, 4, 3), tr.aug_generator(5))
    assert torch.equal(a["noise"], c["noise"]) and torch.equal(a["m"], c["m"])
    assert not torch.equal(a["noise"], b["noise"])
    off = Trainer(_Stub(), {"training": {"device_augment": True, "augment": False}},
                  device="cpu")
    assert not off.device_augment
