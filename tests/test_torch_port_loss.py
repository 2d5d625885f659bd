"""PyTorch port parity: box ops and the SimOTA loss against the JAX package.

Inputs are made from a seed with numpy and go through both packages in fp32
on the CPU. Tolerances, each with its reason:
  - the assignment (match matrix, pos_mask, matched_gt) is discrete: exactly
    equal, also on equal-cost ties (JAX's `lax.top_k` takes the lower index
    first; the port's stable sort does the same);
  - CIoU / IoU: 1e-6 absolute (the same fp32 ops in the same order; only the
    transcendental `atan` may round differently in the last place);
  - loss components: 1e-5 relative (sums over a few thousand anchors of
    terms equal to ~1 ulp);
  - gradients w.r.t. the level outputs (`jax.grad` vs autograd): 1e-4
    relative to the largest gradient (backward sums run in another order).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yololite_tpu.losses.simota import LossConfig as JaxLossConfig
from yololite_tpu.losses.simota import SimOTALoss as JaxSimOTALoss
from yololite_tpu.losses.simota import _assign_single as jax_assign_single
from yololite_tpu.ops import boxes as jax_boxes
from yololite_tpu.ops.anchors import make_anchors as jax_make_anchors
from yololite_tpu.ops.decode import decode_flat as jax_decode_flat
from yololite_tpu.ops.decode import flatten_levels as jax_flatten

from yololite_tpu_torch.losses import LossConfig, SimOTALoss
from yololite_tpu_torch.losses.simota import assign, losses
from yololite_tpu_torch.ops import boxes
from yololite_tpu_torch.ops.anchors import make_anchors
from yololite_tpu_torch.ops.decode import decode_flat, flatten_levels

IMG = 64
SHAPES = [(8, 8), (4, 4), (2, 2)]
# the standard recipe's loss block (configs/train/standard_train.yaml)
STANDARD_LOSS = {"lambda_box": 6.5, "lambda_obj": 1.0, "lambda_cls": 1.5,
                 "cls_smoothing": 0.03, "size_prior_w": 0.2, "ar_prior_w": 0.1,
                 "center_radius_cells": 3.5, "topk_limit": 20, "area_cells_min": 0.0,
                 "area_cells_max": 256, "area_tol": 1.75, "iou_cost_w": 3.0,
                 "center_cost_w": 0.5, "assign_cls_weight": 1.0}


def config(C=3, **loss):
    return {"model": {"num_classes": C}, "training": {"img_size": IMG},
            "loss": dict(STANDARD_LOSS, **loss)}


def random_pairs(rng, n):
    xy = rng.uniform(-20, 60, (n, 2))
    wh = rng.uniform(0, 40, (n, 2))
    a = np.concatenate([xy, xy + wh], -1)
    b = a + rng.normal(0, 8, (n, 4))
    b[: n // 8] = a[: n // 8]                      # identical pairs
    b[n // 8: n // 4, 2:] = b[n // 8: n // 4, :2]  # degenerate (zero-size) targets
    return a.astype(np.float32), b.astype(np.float32)


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a, b = random_pairs(rng, 256)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(boxes.bbox_ciou(ta, tb).numpy(),
                               np.asarray(jax_boxes.bbox_ciou(a, b)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(boxes.box_iou_pairwise(ta, tb).numpy(),
                               np.asarray(jax_boxes.box_iou_pairwise(a, b)), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(boxes.box_iou_matrix(ta[:40], tb[:30]).numpy(),
                                  np.asarray(jax_boxes.box_iou_matrix(a[:40], b[:30])))
    xywh = rng.uniform(0, 50, (64, 4)).astype(np.float32)
    np.testing.assert_array_equal(boxes.xywh_to_xyxy(torch.from_numpy(xywh)).numpy(),
                                  np.asarray(jax_boxes.xywh_to_xyxy(xywh)))
    np.testing.assert_array_equal(boxes.xyxy_to_xywh(tb).numpy(),
                                  np.asarray(jax_boxes.xyxy_to_xywh(b)))


def test_ciou_gradient_matches_jax_and_alpha_is_detached():
    rng = np.random.RandomState(1)
    a, b = random_pairs(rng, 64)
    a[:, 2:] += 1.0                                   # positive-size predictions
    want = jax.grad(lambda p: jnp.sum(jax_boxes.bbox_ciou(p, b)))(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    boxes.bbox_ciou(ta, torch.from_numpy(b)).sum().backward()
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), atol=1e-4 * scale, rtol=0)


def make_case(seed, B=3, M=6, C=3, kind="random"):
    """Raw level maps and padded targets. kinds: random; orphan (a 2x2 GT
    no level gate admits, rescued to its nearest anchor); ties (all-zero
    predictions: equal costs wherever the geometry is symmetric)."""
    rng = np.random.RandomState(seed)
    scale = 0.0 if kind == "ties" else 1.5
    levels = [(rng.normal(0, 1, (B, 1, h, w, 5 + C)) * scale).astype(np.float32)
              for h, w in SHAPES]
    xy = rng.uniform(0, 44, (B, M, 2))
    wh = rng.uniform(4, 30, (B, M, 2))
    if kind == "ties":                       # GT corners on the 4-px grid
        xy, wh = np.round(xy / 4) * 4, np.round(wh / 4) * 4 + 4
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    mask = rng.rand(B, M) > 0.3
    mask[:, 0] = True
    mask[-1] = False                          # an image with no GT
    if kind == "orphan":                      # with area_cells_min 4 (see the test)
        gt[0, :2] = [[0.0, 0.0, 20.0, 20.0], [50.0, 50.0, 52.0, 52.0]]
        mask[0, :2], mask[0, 2:] = True, False
    return levels, {"boxes": gt, "labels": labels, "mask": mask}


def jax_decoded(levels, cfg):
    flat, shapes = jax_flatten([jnp.asarray(l) for l in levels])
    pts, strides = jax_make_anchors(shapes, IMG)
    d = jax_decode_flat(flat.astype(jnp.float32), pts, strides, exp_clamp=(-10.0, 8.0),
                        num_classes=cfg.num_classes)
    return d, strides


def port_decoded(levels, cfg):
    flat, shapes = flatten_levels([torch.from_numpy(l) for l in levels])
    pts, strides = make_anchors(shapes, IMG, device="cpu")
    d = decode_flat(flat, pts, strides, exp_clamp=(-10.0, 8.0), num_classes=cfg.num_classes)
    return d, strides


@pytest.mark.parametrize("seed,kind", [(0, "random"), (1, "random"), (2, "random"),
                                       (3, "orphan"), (4, "ties"), (5, "ties")])
def test_assignment_equals_jax_exactly(seed, kind):
    raw = config(area_cells_min=4.0) if kind == "orphan" else config()
    levels, t = make_case(seed, kind=kind)
    jcfg, pcfg = JaxLossConfig.from_config(raw), LossConfig.from_config(raw)
    jd, jstrides = jax_decoded(levels, jcfg)
    labels = np.clip(t["labels"], 0, 2)
    want_match, want_iou = jax.vmap(partial(jax_assign_single, jcfg),
                                    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))(
        jd["box"], jd["ctr"], jd["wh"], jd["obj"], jd["cls"],
        jnp.asarray(t["boxes"]), jnp.asarray(labels), jnp.asarray(t["mask"]), jstrides)
    pd, pstrides = port_decoded(levels, pcfg)
    got_match, got_iou = assign(pcfg, pd["box"], pd["ctr"], pd["wh"], pd["obj"], pd["cls"],
                                torch.from_numpy(t["boxes"]), torch.from_numpy(labels).long(),
                                torch.from_numpy(t["mask"]), pstrides)
    np.testing.assert_array_equal(got_match.numpy(), np.asarray(want_match))
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou), atol=1e-6, rtol=0)
    assert not got_match[-1].any()                        # the empty image
    assert got_match.any(-1).sum() > 0
    if kind == "orphan":                                  # the rescued GT is matched
        assert got_match[0, :, 1].any()


def _both_losses(levels, t, cfg_raw, img_valid=None):
    jl = JaxSimOTALoss(JaxLossConfig.from_config(cfg_raw))
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    jv = None if img_valid is None else jnp.asarray(img_valid)
    (jtot, jm), jg = jax.value_and_grad(
        lambda lv: jl(lv, jt, img_valid=jv), has_aux=True)([jnp.asarray(l) for l in levels])
    pl = SimOTALoss(LossConfig.from_config(cfg_raw))
    tl = [torch.tensor(l, requires_grad=True) for l in levels]
    pv = None if img_valid is None else torch.from_numpy(img_valid)
    ptot, pm = pl(tl, {k: torch.from_numpy(v) for k, v in t.items()}, img_valid=pv)
    ptot.backward()
    return (jtot, jm, jg), (ptot, pm, [l.grad for l in tl])


@pytest.mark.parametrize("seed,kind,extra", [
    (0, "random", {}), (1, "random", {"cls_smoothing": 0.0}),
    (3, "orphan", {"area_cells_min": 4.0}),
    (4, "ties", {}), (6, "random", {"topk_limit": 40, "wh_mode": "exp",
                                    "center_mode": "simple"}),
])
def test_loss_and_gradients_match_jax(seed, kind, extra):
    levels, t = make_case(seed, kind=kind)
    (jtot, jm, jg), (ptot, pm, pg) = _both_losses(levels, t, config(**extra))
    for k in ("box", "obj", "cls", "pos", "npos"):
        np.testing.assert_allclose(float(pm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(ptot.detach()), float(jtot), rtol=1e-5)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jg)
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4 * scale, rtol=0)


def test_quirks_img_valid_and_batch_sum():
    """Per-image means summed over the batch (not divided by B), `pos` the
    fraction of images with a positive, padding images zeroed by img_valid."""
    levels, t = make_case(7, B=4)
    img_valid = np.array([True, True, False, True])
    (jtot, jm, _), (ptot, pm, _) = _both_losses(levels, t, config(), img_valid)
    np.testing.assert_allclose(float(ptot.detach()), float(jtot), rtol=1e-5)
    np.testing.assert_allclose(float(pm["pos"]), float(jm["pos"]), rtol=0)
    one = SimOTALoss(LossConfig.from_config(config()))
    single = sum(float(one([torch.from_numpy(l[i:i + 1]) for l in levels],
                           {k: torch.from_numpy(v[i:i + 1]) for k, v in t.items()})[0])
                 for i in range(4))
    full = float(one([torch.from_numpy(l) for l in levels],
                     {k: torch.from_numpy(v) for k, v in t.items()})[0])
    np.testing.assert_allclose(full, single, rtol=1e-5)


def test_approx_topk_is_exact_in_the_port():
    """standard_train.yaml sets approx_topk: true (TPU-only lax.approx_max_k;
    exact on the CPU): the port takes the exact top-k either way."""
    levels, t = make_case(8)
    (jtot, _, _), (ptot, _, _) = _both_losses(levels, t, config(approx_topk=True))
    np.testing.assert_allclose(float(ptot.detach()), float(jtot), rtol=1e-5)


def test_hard_negative_count_and_returned_assignment():
    levels, t = make_case(9)
    loss = SimOTALoss(LossConfig.from_config(config()))
    _, m = loss([torch.from_numpy(l) for l in levels],
                {k: torch.from_numpy(v) for k, v in t.items()}, return_assignment=True)
    assert m["pos_mask"].shape == (3, 84) and m["matched_gt"].dtype == torch.int64
    assert int(m["pos_mask"].sum()) == int(m["npos"])


def test_mask_loss_raises():
    """Prototypes and GT masks add the mask term (segmentation), equal to
    JAX's; without them the loss has no "mask" metric."""
    levels, t = make_case(0)
    rng = np.random.RandomState(0)
    levels = [np.concatenate([lv, np.tanh(rng.normal(0, 1, lv.shape[:-1] + (4,)))
                              .astype(np.float32)], -1) for lv in levels]
    protos = rng.normal(0, 1, (3, 16, 16, 4)).astype(np.float32)
    masks = (rng.rand(3, 6, 16, 16) > 0.5).astype(np.float32)
    loss = SimOTALoss(LossConfig.from_config(config()))
    total, m = loss([torch.from_numpy(l) for l in levels],
                    {**{k: torch.from_numpy(v) for k, v in t.items()},
                     "masks": torch.from_numpy(masks)}, protos=torch.from_numpy(protos))
    jt, jm = JaxSimOTALoss(JaxLossConfig.from_config(config()))(
        [jnp.asarray(l) for l in levels], {**{k: jnp.asarray(v) for k, v in t.items()},
                                          "masks": jnp.asarray(masks)}, jnp.asarray(protos))
    np.testing.assert_allclose(float(m["mask"]), float(jm["mask"]), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-5)
    _, plain = loss([torch.from_numpy(l) for l in levels],
                    {k: torch.from_numpy(v) for k, v in t.items()})
    assert "mask" not in plain


def test_losses_function_batches_images():
    """`losses` returns per-image [B] terms: image b alone gives row b."""
    levels, t = make_case(10)
    cfg = LossConfig.from_config(config())
    d, strides = port_decoded(levels, cfg)
    args = (torch.from_numpy(t["boxes"]), torch.from_numpy(t["labels"]).long(),
            torch.from_numpy(t["mask"]), strides)
    full = losses(cfg, d, *args)
    for b in range(3):
        db = {k: v[b:b + 1] for k, v in d.items()}
        one = losses(cfg, db, *(a[b:b + 1] for a in args[:3]), strides)
        for f, o in zip(full[:5], one[:5]):
            np.testing.assert_allclose(f[b].detach().numpy(), o[0].detach().numpy(),
                                       rtol=1e-6)


def test_loss_backward_after_serving_under_inference_mode():
    """The anchor grid is cached per device; a grid first made while
    serving (inference_mode) must still be usable by training's autograd."""
    levels, t = make_case(11)
    with torch.inference_mode():
        make_anchors(SHAPES, IMG, device="cpu")
    loss = SimOTALoss(LossConfig.from_config(config()))
    tl = [torch.tensor(l, requires_grad=True) for l in levels]
    total, _ = loss(tl, {k: torch.from_numpy(v) for k, v in t.items()})
    total.backward()
    assert all(l.grad is not None for l in tl)
