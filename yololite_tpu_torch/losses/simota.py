"""SimOTA-hybrid anchor-free loss, batched over images (port of
`losses/simota.py`).

The JAX version vmaps a per-image function; here every tensor carries the
batch as its leading dim ([B, N, M] for anchors x padded GTs), so one pass of
batched ops covers the batch and nothing loops over images in Python.

  (a) decode all preds to xyxy (v8 centre, softplus wh, exp clamp (-10, 8));
  (b) candidates: centre radius `max(r_cells * stride + 0.1 * max(gt_wh), 15)`
      AND the area-in-cells level gate;
  (c) orphan rescue: a GT with no candidate takes its nearest anchor;
  (d) cost = 3 (1 - IoU) + w_cls clsCost + objCost + 0.5 centreNorm
      + 0.2 sizeCost + 0.1 arCost, BIG (1e9) on non-candidates;
  (e) dynamic k = int(sum of the top-k IoUs) per GT, clamped to [1, K];
  (f) an anchor matched to several GTs keeps the one of least cost;
  losses: CIoU box, CE with smoothing for cls, BCE obj with IoU targets at
  positives + the top-K hard negatives, K = max(64, 3 npos).
The reference's quirks are kept: per-image means are summed over the batch
(not divided by B), and "pos" is the fraction of images with a positive.

Discrete outputs equal JAX's on equal fp32 inputs: `lax.top_k` puts the
lower index first among equal values, so top-k here is a stable descending
sort and a slice (`torch.topk` promises no order among ties); `argmin` and
`argmax` take the first index, as torch's do. The assignment is detached.
The loss block's `approx_topk` (JAX's TPU-only `lax.approx_max_k`, exact on
the CPU) is not read: the port always takes the exact top-k.

With prototypes and GT masks (segmentation) a YOLACT mask loss is added,
`lambda_mask` x the per-image mean over at most `max_pos_masks` positives
(the first ones by anchor index, as `lax.top_k` picks among ties) of the
BCE of the assembled mask logits against the GT mask, cropped to the GT box
and normalized by the crop's area; images without positives add 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from yololite_tpu_torch.ops.anchors import make_anchors
from yololite_tpu_torch.ops.boxes import bbox_ciou, box_iou_matrix
from yololite_tpu_torch.ops.decode import decode_flat, flatten_levels
from yololite_tpu_torch.ops.masks import box_crop

BIG = 1e9


@dataclasses.dataclass(frozen=True)
class LossConfig:
    num_classes: int
    img_size: int
    lambda_box: float = 5.0
    lambda_obj: float = 1.0
    lambda_cls: float = 0.5
    assign_cls_weight: float = 0.5
    center_mode: str = "v8"
    wh_mode: str = "softplus"
    center_radius_cells: float = 2.0
    topk_limit: int = 20
    cls_smoothing: float = 0.05
    area_cells_min: float = 4.0
    area_cells_max: float = 256.0
    area_tol: float = 1.25
    size_prior_w: float = 0.20
    ar_prior_w: float = 0.10
    iou_cost_w: float = 3.0
    center_cost_w: float = 0.5
    # instance segmentation: the YOLACT mask loss
    lambda_mask: float = 6.125
    max_pos_masks: int = 64   # positives with a mask loss per image, at most

    @classmethod
    def from_config(cls, cfg: dict) -> "LossConfig":
        """Build from a merged config dict (loss block keys as in
        configs/train/standard_train.yaml)."""
        lo = cfg.get("loss", {}) or {}
        tr = cfg.get("training", {}) or {}
        m = cfg.get("model", {}) or {}
        return cls(
            num_classes=int(m.get("num_classes", 3)),
            img_size=int(tr.get("img_size", 640)),
            lambda_box=float(lo.get("lambda_box", 5.0)),
            lambda_obj=float(lo.get("lambda_obj", 1.0)),
            lambda_cls=float(lo.get("lambda_cls", 0.5)),
            assign_cls_weight=float(lo.get("assign_cls_weight", 0.5)),
            center_mode=str(lo.get("center_mode", "v8")),
            wh_mode=str(lo.get("wh_mode", "softplus")),
            center_radius_cells=float(lo.get("center_radius_cells",
                                             lo.get("center_radius", 2.0))),
            topk_limit=int(lo.get("topk_limit", 20)),
            cls_smoothing=float(lo.get("cls_smoothing", 0.05)),
            area_cells_min=float(lo.get("area_cells_min", 4.0)),
            area_cells_max=float(lo.get("area_cells_max", 256.0)),
            area_tol=float(lo.get("area_tol", 1.25)),
            size_prior_w=float(lo.get("size_prior_w", 0.20)),
            ar_prior_w=float(lo.get("ar_prior_w", 0.10)),
            iou_cost_w=float(lo.get("iou_cost_w", 3.0)),
            center_cost_w=float(lo.get("center_cost_w", 0.5)),
            lambda_mask=float(lo.get("lambda_mask", 6.125)),
            max_pos_masks=int(lo.get("max_pos_masks", 64)),
        )


def _bce_logits(logits, targets):
    """Elementwise BCE-with-logits (stable), JAX's formula, with JAX's
    derivatives at a logit of exactly 0: `jnp.maximum` sends half the
    gradient to each tied side and `jnp.abs` has slope 1 there (torch's
    `clamp` has 1 and `abs` 0), which makes the derivative 0 for a 0 target."""
    abs_l = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
            + torch.log1p(torch.exp(-abs_l)))


def _ce_smoothed(logits, labels, num_classes: int, smoothing: float):
    """Cross entropy with label smoothing (torch CrossEntropyLoss semantics)."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels, num_classes).to(logits.dtype)
    target = onehot * (1.0 - smoothing) + smoothing / num_classes
    return -torch.sum(target * logp, dim=-1)


def _topk_desc(x: torch.Tensor, k: int):
    """`lax.top_k` along the last dim: descending, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot_bool(idx: torch.Tensor, n: int) -> torch.Tensor:
    """idx [...] -> [..., n] bool, True at idx."""
    out = torch.zeros(*idx.shape, n, dtype=torch.bool, device=idx.device)
    return out.scatter_(-1, idx[..., None], True)


@torch.no_grad()
def assign(cfg: LossConfig, pred_xyxy, pred_ctr, pred_wh, pred_obj, pred_cls,
           gt_xyxy, gt_labels, gt_mask, strides):
    """SimOTA assignment of a batch: preds [B,N,4] [B,N,2] [B,N,2] [B,N]
    [B,N,C], GTs [B,M,4] [B,M] [B,M] bool, strides [N]. Returns (match
    [B,N,M] bool, iou [B,N,M]); `_assign_single` of the JAX package on each
    image."""
    N = pred_xyxy.shape[1]
    M = gt_xyxy.shape[1]
    K = min(cfg.topk_limit, N)

    iou = box_iou_matrix(pred_xyxy, gt_xyxy)                          # [B,N,M]
    gt_ctr = (gt_xyxy[..., :2] + gt_xyxy[..., 2:]) * 0.5              # [B,M,2]
    gt_wh = torch.clamp(gt_xyxy[..., 2:] - gt_xyxy[..., :2], min=1.0)  # [B,M,2]

    dist_sq = torch.sum((pred_ctr[:, :, None, :] - gt_ctr[:, None, :, :]) ** 2, -1)
    s_col = strides[None, :, None]                                    # [1,N,1]

    # (b) min-radius guard and level gate (area_tol applied to the bounds)
    raw_r = cfg.center_radius_cells * s_col + 0.10 * gt_wh.amax(-1)[:, None, :]
    r_pix = torch.clamp(raw_r, min=15.0)
    center_mask = dist_sq <= r_pix ** 2
    gt_area = torch.prod(gt_wh, -1)[:, None, :]                       # [B,1,M]
    area_cells = gt_area / (s_col ** 2)
    amin = cfg.area_cells_min / cfg.area_tol
    amax = cfg.area_cells_max * cfg.area_tol
    level_mask = (area_cells >= amin) & (area_cells <= amax)
    valid = center_mask & level_mask & gt_mask[:, None, :]

    # (c) orphan rescue
    orphan = (~valid.any(1)) & gt_mask                                # [B,M]
    nearest = torch.argmin(dist_sq, dim=1)                            # [B,M]
    rescue = _one_hot_bool(nearest, N).transpose(1, 2) & orphan[:, None, :]
    valid = valid | rescue

    # (d) cost; prob[n, label[m]] by gather (the JAX one-hot matmul's value)
    cls_prob = torch.sigmoid(pred_cls)                                # [B,N,C]
    class_probs = torch.gather(cls_prob, 2, gt_labels[:, None, :].expand(-1, N, -1))
    cls_cost = 1.0 - class_probs
    obj_cost = -torch.sigmoid(pred_obj)[..., None]

    p_area = torch.clamp(torch.prod(pred_wh, -1), min=1e-9)[..., None]   # [B,N,1]
    dlog = torch.abs(torch.log(p_area) - torch.log(torch.clamp(gt_area, min=1e-9)))
    size_cost = dlog / (1.0 + dlog)

    p_ar = torch.log(torch.clamp(
        pred_wh[..., 0] / torch.clamp(pred_wh[..., 1], min=1e-9), min=1e-9))[..., None]
    g_ar = torch.log(gt_wh[..., 0] / gt_wh[..., 1])[:, None, :]
    dar = torch.abs(p_ar - g_ar)
    ar_cost = dar / (1.0 + dar)

    center_norm = dist_sq / (gt_wh[..., 0] ** 2 + gt_wh[..., 1] ** 2 + 1e-6)[:, None, :]

    cost = (cfg.iou_cost_w * (1.0 - iou)
            + cfg.assign_cls_weight * cls_cost
            + obj_cost
            + cfg.center_cost_w * center_norm
            + cfg.size_prior_w * size_cost
            + cfg.ar_prior_w * ar_cost)
    cost = torch.where(valid, cost, torch.full_like(cost, BIG))

    # (e) dynamic k via static top-k + rank mask
    iou_masked = torch.where(valid, iou, torch.zeros_like(iou))
    topk_ious = _topk_desc(iou_masked.transpose(1, 2), K)[0]          # [B,M,K]
    dynamic_ks = torch.clamp(topk_ious.sum(-1).to(torch.int32), 1, K)  # [B,M]

    neg_cost_sorted, idx = _topk_desc(-cost.transpose(1, 2), K)       # [B,M,K]
    rank_ok = torch.arange(K, device=cost.device)[None, None, :] < dynamic_ks[..., None]
    # never select an invalid (cost BIG) anchor when dynamic_k exceeds the
    # number of valid candidates
    rank_ok = rank_ok & (-neg_cost_sorted < BIG * 0.5)
    # the K indices of one row are distinct, so a plain scatter is the max
    B = cost.shape[0]
    match_mt = torch.zeros(B, M, N, dtype=torch.bool, device=cost.device).scatter_(
        2, idx, rank_ok)                                              # [B,M,N]
    match = match_mt.transpose(1, 2) & gt_mask[:, None, :]            # [B,N,M]

    # (f) conflict resolution by min cost
    n_matched = match.sum(-1)                                         # [B,N]
    best_gt = torch.argmin(torch.where(match, cost, torch.full_like(cost, BIG)), dim=-1)
    exclusive = _one_hot_bool(best_gt, M) & match
    match = torch.where((n_matched > 1)[..., None], exclusive, match)
    return match, iou


def losses(cfg: LossConfig, decoded: Dict[str, torch.Tensor], gt_xyxy, gt_labels,
           gt_mask, strides):
    """Per-image losses [B] (box, obj, cls, has_pos, npos) and the assignment
    (pos_mask [B,N], matched_gt [B,N]); `_loss_single` of the JAX package on
    each image."""
    pred_xyxy, pred_obj, pred_cls = decoded["box"], decoded["obj"], decoded["cls"]
    N = pred_xyxy.shape[1]
    match, iou = assign(cfg, pred_xyxy.detach(), decoded["ctr"].detach(),
                        decoded["wh"].detach(), pred_obj.detach(), pred_cls.detach(),
                        gt_xyxy, gt_labels, gt_mask, strides)
    pos_mask = match.any(-1)                                          # [B,N]
    matched_gt = torch.argmax(match.to(torch.uint8), dim=-1)          # [B,N]
    npos = pos_mask.sum(-1)                                           # [B]
    npos_div = torch.clamp(npos, min=1)
    zero = pred_xyxy.new_zeros(())

    # box: CIoU over positives, per-image mean
    tgt_box = torch.gather(gt_xyxy, 1, matched_gt[..., None].expand(-1, -1, 4))
    ciou = bbox_ciou(pred_xyxy, tgt_box)
    loss_box = torch.where(pos_mask, 1.0 - ciou, zero).sum(-1) / npos_div

    # cls: CE with smoothing over positives
    labels_at = torch.gather(gt_labels, 1, matched_gt)
    ce = _ce_smoothed(pred_cls, labels_at, cfg.num_classes, cfg.cls_smoothing)
    loss_cls = torch.where(pos_mask, ce, zero).sum(-1) / npos_div

    # obj: IoU-valued targets at positives (each positive has exactly one
    # match, so the masked sum is the row gather) + hard-negative top-K
    iou_at_match = torch.clamp(torch.where(match, iou, torch.zeros_like(iou)).sum(-1),
                               0.0, 1.0)
    obj_t = torch.where(pos_mask, iou_at_match, zero)
    bce = _bce_logits(pred_obj, obj_t)
    pos_obj = torch.where(pos_mask, bce, zero).sum(-1) / npos_div

    neg_scores = torch.where(pos_mask, torch.full_like(bce, -torch.inf), bce)
    # jnp.sort(x)[::-1]: a stable ascending sort, reversed (equal values
    # then run from the higher index down, which sets where the gradient
    # lands on ties at the K boundary)
    neg_sorted = torch.sort(neg_scores, dim=-1, stable=True).values.flip(-1)
    n_neg = N - npos
    k_neg = torch.minimum(torch.clamp(3 * npos, min=64), n_neg)
    take = torch.arange(N, device=bce.device)[None, :] < k_neg[:, None]
    neg_obj = torch.where(take, neg_sorted, zero).sum(-1) / torch.clamp(k_neg, min=1)

    has_pos = (npos > 0).to(torch.float32)
    loss_obj = has_pos * pos_obj + neg_obj
    return (has_pos * loss_box, loss_obj, has_pos * loss_cls, has_pos, npos,
            pos_mask, matched_gt)


def mask_losses(cfg: LossConfig, coef, protos, gt_xyxy, gt_masks, pos_mask,
                matched_gt) -> torch.Tensor:
    """Per-image mask losses [B] (`_mask_loss_single` of the JAX package on
    each image): coef [B,N,K] tanh coefficients, protos [B,Hp,Wp,K], gt_masks
    [B,M,Hp,Wp] in {0,1}, pos_mask / matched_gt [B,N]."""
    B, N, K = coef.shape
    _, hp, wp, _ = protos.shape
    vals, pick = _topk_desc(pos_mask.to(torch.float32), min(cfg.max_pos_masks, N))
    sel_valid = vals > 0.0                                          # [B,P]
    P = pick.shape[1]
    gt_idx = torch.gather(matched_gt, 1, pick)                      # [B,P]
    boxes = torch.gather(gt_xyxy, 1, gt_idx[..., None].expand(B, P, 4))
    target = torch.gather(gt_masks.to(torch.float32), 1,
                          gt_idx[..., None, None].expand(B, P, hp, wp))
    c = torch.gather(coef.to(torch.float32), 1, pick[..., None].expand(B, P, K))
    logits = torch.bmm(c, protos.to(torch.float32).reshape(B, hp * wp, K)
                       .transpose(1, 2)).reshape(B, P, hp, wp)
    bce = _bce_logits(logits, target)
    crop = box_crop(boxes, hp, wp, float(cfg.img_size)).to(torch.float32)
    per_pos = (bce * crop).sum((2, 3)) / torch.clamp(crop.sum((2, 3)), min=1.0)
    n_sel = sel_valid.sum(-1)
    return (torch.where(sel_valid, per_pos, torch.zeros_like(per_pos)).sum(-1)
            / torch.clamp(n_sel, min=1))


class SimOTALoss:
    """Callable loss over raw per-level predictions + padded targets.

    targets: dict with
      boxes  [B, M, 4] xyxy pixels (padded rows arbitrary),
      labels [B, M] int,
      mask   [B, M] bool (True for real GTs),
      masks  [B, M, Hp, Wp] GT masks in {0,1} (segmentation, with `protos`).
    """

    def __init__(self, cfg: LossConfig):
        self.cfg = cfg

    def __call__(self, preds_levels: Sequence[torch.Tensor],
                 targets: Dict[str, torch.Tensor], protos: Optional[torch.Tensor] = None,
                 img_size: Optional[int] = None, img_valid: Optional[torch.Tensor] = None,
                 return_assignment: bool = False):
        """`img_size` overrides cfg.img_size (multi-scale training: the
        radius/area gates scale with the actual input). `img_valid` [B] bool
        zeroes the padding images of a padded final eval batch. With
        `return_assignment` the metrics also hold `pos_mask` and
        `matched_gt` [B, N]."""
        cfg = self.cfg
        if img_size is not None and int(img_size) != cfg.img_size:
            cfg = dataclasses.replace(cfg, img_size=int(img_size))
        flat, shapes = flatten_levels(preds_levels)
        flat = flat.float()
        pts, strides = make_anchors(shapes, cfg.img_size, device=flat.device)
        decoded = decode_flat(flat, pts, strides, center_mode=cfg.center_mode,
                              wh_mode=cfg.wh_mode, exp_clamp=(-10.0, 8.0),
                              img_size=None, num_classes=cfg.num_classes)
        gt_boxes = targets["boxes"].float()
        # padded rows stay numerically safe (w/h >= 1 via the gt_wh clamp;
        # labels clamped into range)
        gt_labels = torch.clamp(targets["labels"].long(), 0, cfg.num_classes - 1)
        gt_mask = targets["mask"].bool()

        lb, lo, lc, has_pos, npos, pos_mask, matched_gt = losses(
            cfg, decoded, gt_boxes, gt_labels, gt_mask, strides)
        B = gt_boxes.shape[0]
        if img_valid is not None:
            w = img_valid.to(lb.dtype)
            lb, lo, lc = lb * w, lo * w, lc * w
            has_pos = has_pos * w
        loss_box = cfg.lambda_box * lb.sum()
        loss_obj = cfg.lambda_obj * lo.sum()
        loss_cls = cfg.lambda_cls * lc.sum()
        total = loss_box + loss_obj + loss_cls
        metrics = {"box": loss_box, "obj": loss_obj, "cls": loss_cls,
                   "pos": has_pos.sum() / max(B, 1),   # reference quirk: images w/ pos
                   "npos": npos.sum()}
        if protos is not None and "masks" in targets:
            lm = mask_losses(cfg, decoded["coef"], protos, gt_boxes, targets["masks"],
                             pos_mask, matched_gt)
            # per-image means summed over the batch, 0 for images without positives
            loss_mask = cfg.lambda_mask * (lm * has_pos).sum()
            total = total + loss_mask
            metrics["mask"] = loss_mask
        if return_assignment:
            metrics["pos_mask"], metrics["matched_gt"] = pos_mask, matched_gt
        return total, metrics
