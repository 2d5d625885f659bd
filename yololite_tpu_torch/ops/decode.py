"""Anchor-free decode: raw head maps -> (boxes xyxy px, obj logits, cls logits).

Port of `ops/decode.py`.
Center modes:
  v8:     px = (sigmoid(tx) * 2 - 0.5 + gx) * stride
  simple: px = (sigmoid(tx) + gx) * stride
WH modes:
  v8:       pw = (sigmoid(tw) * 2)^2 * stride
  softplus: pw = softplus(tw) * stride
  exp:      pw = exp(clamp(tw)) * stride   (clamp (-4,4) infer / (-10,8) loss)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from yololite_tpu_torch.ops.anchors import make_anchors


def flatten_levels(preds_levels: Sequence[torch.Tensor]):
    """List of per-level maps [B,A,S,S,E] or [B,S,S,E] -> ([B,N,E], level shapes)."""
    flat, shapes = [], []
    for p in preds_levels:
        if p.ndim == 4:
            b, h, w, e = p.shape
            flat.append(p.reshape(b, h * w, e))
        elif p.ndim == 5:
            b, a, h, w, e = p.shape
            flat.append(p.reshape(b, a * h * w, e))
        else:
            raise ValueError(f"bad pred level shape {tuple(p.shape)}")
        shapes.append((h, w))
    return torch.cat(flat, dim=1), tuple(shapes)


def decode_flat(preds_flat: torch.Tensor, anchor_points: torch.Tensor,
                strides: torch.Tensor, *, center_mode: str = "v8",
                wh_mode: str = "softplus",
                exp_clamp: Tuple[float, float] = (-4.0, 4.0),
                img_size: Optional[int] = None,
                num_classes: Optional[int] = None):
    """Decode flattened raw predictions [B,N,5+C(+K)].

    Returns dict: box [B,N,4] xyxy px; obj [B,N] logits; cls [B,N,C] logits;
    ctr [B,N,2]; wh [B,N,2]; coef [B,N,K] (empty unless `num_classes` is given
    and a tail follows the class logits).
    """
    s = strides[None, :, None]
    a = anchor_points[None, :, :]
    txy = preds_flat[..., 0:2]
    twh = preds_flat[..., 2:4]

    if center_mode == "v8":
        xy = (torch.sigmoid(txy) * 2.0 - 0.5 + a) * s
    elif center_mode == "simple":
        xy = (torch.sigmoid(txy) + a) * s
    else:
        raise ValueError(f"center_mode {center_mode!r}")

    if wh_mode == "v8":
        wh = torch.square(torch.sigmoid(twh) * 2.0) * s
    elif wh_mode == "softplus":
        wh = F.softplus(twh) * s
    elif wh_mode == "exp":
        wh = torch.exp(torch.clamp(twh, exp_clamp[0], exp_clamp[1])) * s
    else:
        raise ValueError(f"wh_mode {wh_mode!r}")

    box = torch.cat([xy - 0.5 * wh, xy + 0.5 * wh], dim=-1)
    if img_size is not None:
        box = torch.clamp(box, 0.0, float(img_size) - 1.0)

    if num_classes is None:
        cls = preds_flat[..., 5:]
        coef = preds_flat[..., :0]
    else:
        cls = preds_flat[..., 5:5 + num_classes]
        coef = preds_flat[..., 5 + num_classes:]
    return {"box": box, "obj": preds_flat[..., 4], "cls": cls, "ctr": xy,
            "wh": wh, "coef": coef}


def decode_anchorfree(preds_levels: Sequence[torch.Tensor], img_size: int, *,
                      center_mode: str = "v8", wh_mode: str = "softplus",
                      clamp: bool = True, num_classes: Optional[int] = None):
    """Decode per-level raw maps.

    Returns {"box": [B,N,4] xyxy px (clamped), "obj": [B,N,1], "cls": [B,N,C],
    "coef": [B,N,K]}.
    """
    flat, shapes = flatten_levels(preds_levels)
    pts, strides = make_anchors(shapes, img_size, device=flat.device)
    d = decode_flat(flat, pts, strides, center_mode=center_mode, wh_mode=wh_mode,
                    exp_clamp=(-4.0, 4.0), img_size=img_size if clamp else None,
                    num_classes=num_classes)
    return {"box": d["box"], "obj": d["obj"][..., None], "cls": d["cls"],
            "coef": d["coef"]}
