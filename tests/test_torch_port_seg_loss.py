"""PyTorch port parity, the segmentation loss and steps: SimOTA's mask term
(`mask_losses`, `metrics["mask"]`), its gradients, and the Trainer's seg
train and eval steps, against the JAX package (CPU, fp32).

Inputs are numpy-seeded: level maps with K = 8 tanh coefficients after the
class logits, prototypes at stride 4 and GT masks at prototype resolution.
Tolerances, each with its reason:
  - which positives carry a mask loss: exactly JAX's (`lax.top_k` over the
    0/1 positive mask takes the first positives by anchor index; the port's
    stable descending sort does the same), checked with more positives than
    `max_pos_masks` in an image;
  - loss components, `mask` included: 1e-5 relative (fp32 sums of a few
    thousand terms in another order);
  - gradients w.r.t. the level maps and the prototypes: 1e-5 of the
    largest gradient (backward sums in another order);
  - the Trainer's seg step: losses 1e-3 relative over 2 steps at 128 px
    (the train-mode BatchNorm gap of tests/test_torch_port_train.py); eval
    masks of matched detections 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.losses.simota import LossConfig as JaxLossConfig
from yololite_tpu.losses.simota import SimOTALoss as JaxSimOTALoss
from yololite_tpu.models.detector import build_model_from_config as jax_build
from yololite_tpu.train.steps import Trainer as JaxTrainer

from tests.test_torch_port_loss import config, make_case
from tests.test_torch_port_models import EDGE_N
from tests.test_torch_port_zoo import nhwc, random_vars
from yololite_tpu_torch.losses import LossConfig, SimOTALoss
from yololite_tpu_torch.losses.simota import mask_losses
from yololite_tpu_torch.models.detector import build_model_from_config
from yololite_tpu_torch.train.steps import Trainer

K, HP = 8, 16


def seg_case(seed, B=3, M=6, C=3):
    """make_case's levels with K coefficient channels appended, prototypes
    and GT masks (each GT's box with a random notch)."""
    levels, t = make_case(seed, B, M, C)
    rng = np.random.RandomState(1000 + seed)
    levels = [np.concatenate([lv, rng.uniform(-1, 1, lv.shape[:-1] + (K,))
                              .astype(np.float32)], -1) for lv in levels]
    protos = rng.normal(0, 1, (B, HP, HP, K)).astype(np.float32)
    c = (np.arange(HP) + 0.5) * 4.0
    b = t["boxes"][..., None, None, :]
    masks = ((c[:, None] >= b[..., 1]) & (c[:, None] <= b[..., 3]) & (c[None, :] >= b[..., 0])
             & (c[None, :] <= b[..., 2]) & (rng.rand(B, M, HP, HP) > 0.2))
    return levels, protos, dict(t, masks=masks.astype(np.float32))


def _port(levels, protos, t, cfg, grad=False):
    lv = [torch.from_numpy(l).requires_grad_(grad) for l in levels]
    pr = torch.from_numpy(protos).requires_grad_(grad)
    total, m = SimOTALoss(LossConfig.from_config(cfg))(
        lv, {k: torch.from_numpy(v) for k, v in t.items()}, pr, return_assignment=True)
    return total, m, lv, pr


def _jax(levels, protos, t, cfg):
    loss = JaxSimOTALoss(JaxLossConfig.from_config(cfg))
    tj = {k: jnp.asarray(v) for k, v in t.items()}

    def f(lv, pr):
        return loss(lv, tj, pr)

    (total, m), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(l) for l in levels], jnp.asarray(protos))
    return total, m, grads


@pytest.mark.parametrize("seed,max_pos", [(0, 64), (2, 2), (3, 1)])
def test_mask_loss_and_gradients_match_jax(seed, max_pos):
    """max_pos 2 and 1: more positives than the cap in every image with a
    GT, so the first positives by index must be the ones JAX picks."""
    cfg = config(max_pos_masks=max_pos, lambda_mask=6.125)
    levels, protos, t = seg_case(seed)
    total, m, lv, pr = _port(levels, protos, t, cfg, grad=True)
    jt, jm, (jg_lv, jg_pr) = _jax(levels, protos, t, cfg)
    npos = m["pos_mask"].sum(-1)
    if max_pos < 64:
        assert (npos[:-1] > max_pos).all()        # the last image has no GT
    for k in ("box", "obj", "cls", "mask", "npos", "pos"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=1e-5)
    assert float(m["mask"].detach()) > 0.1
    total.backward()
    for g, w in zip([l.grad for l in lv] + [pr.grad], list(jg_lv) + [jg_pr]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


def test_mask_losses_pick_the_first_positives():
    """Ties in the positive mask resolve to the lowest anchor indices: with
    P = 2, moving a third positive's coefficients changes nothing."""
    cfg = LossConfig(num_classes=3, img_size=64, max_pos_masks=2)
    rng = np.random.RandomState(5)
    coef = torch.from_numpy(rng.uniform(-1, 1, (1, 84, K)).astype(np.float32))
    protos = torch.from_numpy(rng.normal(0, 1, (1, HP, HP, K)).astype(np.float32))
    boxes = torch.tensor([[[8.0, 8.0, 40.0, 40.0]]])
    gt = torch.from_numpy((rng.rand(1, 1, HP, HP) > 0.5).astype(np.float32))
    pos = torch.zeros(1, 84, dtype=torch.bool)
    pos[0, [10, 30, 50]] = True
    matched = torch.zeros(1, 84, dtype=torch.int64)
    a = mask_losses(cfg, coef, protos, boxes, gt, pos, matched)
    coef2 = coef.clone()
    coef2[0, 50] = -coef2[0, 50]
    b = mask_losses(cfg, coef2, protos, boxes, gt, pos, matched)
    coef2[0, 30] = -coef2[0, 30]
    c = mask_losses(cfg, coef2, protos, boxes, gt, pos, matched)
    assert torch.equal(a, b) and not torch.equal(a, c)


SEG = dict(EDGE_N, fpn_channels=54, with_masks=True, num_prototypes=K)


def _seg_train_cfg(img):
    return {"model": dict(SEG), "loss": config()["loss"],
            "training": {"img_size": img, "lr": 1e-3, "optimizer": "adamw",
                         "weight_decay": 5e-4, "ema": True, "amp": False}}


def _seg_batches(n, img, B=2, M=5, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    hp = img // 4
    for _ in range(n):
        xy = rng.uniform(0, img * 0.6, (B, M, 2))
        wh = rng.uniform(img * 0.1, img * 0.4, (B, M, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        c = (np.arange(hp) + 0.5) * 4.0
        b = boxes[..., None, None, :]
        masks = ((c[:, None] >= b[..., 1]) & (c[:, None] <= b[..., 3])
                 & (c[None, :] >= b[..., 0]) & (c[None, :] <= b[..., 2])).astype(np.uint8)
        out.append({"image": (rng.rand(B, img, img, 3) * 255).astype(np.uint8),
                    "boxes": boxes, "labels": rng.randint(0, 3, (B, M)).astype(np.int32),
                    "mask": np.arange(M)[None] < rng.randint(1, M + 1, (B, 1)),
                    "masks_packed": np.packbits(masks, axis=-1),
                    "image_id": np.arange(B, dtype=np.int64)})
    return out


def test_seg_train_and_eval_steps_match_jax():
    img = 128
    cfg = _seg_train_cfg(img)
    m = jax_build(cfg, dtype=jnp.float32)
    params, stats = random_vars(m, nhwc(2, 64, 3))
    jt = JaxTrainer(m, cfg, total_updates=10)
    js = jt.state_from_weights(params, stats)
    pt = Trainer(build_model_from_config(cfg), cfg, total_updates=10, device="cpu")
    ps = pt.state_from_weights(params, stats)
    for i, batch in enumerate(_seg_batches(2, img)):
        js, jm = jt.train_step(js, jt.put_batch(batch), jt.lr_vector(1e-3))
        ps, pm = pt.train_step(ps, pt.put_batch(batch), pt.lr_vector(1e-3))
        for k in ("total", "box", "obj", "cls", "mask", "npos"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    batch = _seg_batches(1, img, seed=9)[0]
    batch["image_id"][-1] = -1                       # a padding image
    jvars = {"params": params, "batch_stats": stats}
    jm, jd = jt.eval_step(jvars, jt.put_batch(batch), conf_th=0.001, iou_th=0.65)
    pm, pd = pt.eval_step(pt.variables_from_flax(params, stats), pt.put_batch(batch),
                          conf_th=0.001, iou_th=0.65)
    for k in ("total", "mask"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert pd["masks"].shape == (2, 300, img // 4, img // 4)
    for b in range(2):
        jv, pv = np.asarray(jd["valid"][b]), pd["valid"][b].numpy()
        assert jv.sum() == pv.sum() > 0
        np.testing.assert_array_equal(pd["idx"][b].numpy()[pv], np.asarray(jd["idx"][b])[jv])
        np.testing.assert_allclose(pd["masks"][b].numpy()[pv], np.asarray(jd["masks"][b])[jv],
                                   atol=1e-5, rtol=0)
