"""Instance-mask assembly: prototypes x coefficients, per-box crop (YOLACT
style). Port of `ops/masks.py`.

  - the ProtoNet emits prototypes P [Hp, Wp, K] at stride 4;
  - every anchor predicts K tanh mask coefficients c;
  - an instance mask is sigmoid(P @ c), cropped to the detection box;
  - masks are assembled only for the fixed `max_det` slots (or the loss's
    positives), the crop is a rectangle test at pixel centres, and the
    upsample to the frame happens once at the end (on the host for serving).

On the card this is one batched matmul (cuBLAS), a sigmoid and the crop's
row and column multiplies, in place when no gradient is needed (the mask
tensor of a b128 serving call is [128, 300, 160, 160] fp32, 3.9 GB): the
JAX package computes it in plain XLA too, not in a Pallas kernel. The
numpy helpers (RLE, box rasterization, the host assembly) are the JAX
module's own numpy code, copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _centres(n: int, img_size: float, device) -> torch.Tensor:
    """(arange(n) + 0.5) * (img_size / n) in fp32: the factor is rounded to
    fp32 first, as JAX multiplies an fp32 array by a weakly typed Python
    float, so pixels on a box edge fall on the same side in both."""
    step = float(np.float32(float(img_size) / n))
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * step


def _box_rows_cols(boxes: torch.Tensor, hp: int, wp: int, img_size: float):
    """[..., 4] xyxy boxes in image pixels -> (in_y bool [..., Hp, 1], in_x
    bool [..., 1, Wp]): the pixel-centre rows and columns inside each box
    (edges included)."""
    ys = _centres(hp, img_size, boxes.device)
    xs = _centres(wp, img_size, boxes.device)
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    return (ys[:, None] >= y1) & (ys[:, None] <= y2), (xs >= x1) & (xs <= x2)


def box_crop(boxes: torch.Tensor, hp: int, wp: int, img_size: float) -> torch.Tensor:
    """[..., 4] xyxy boxes in image pixels -> bool [..., Hp, Wp]: the pixel
    centres inside each box (edges included)."""
    in_y, in_x = _box_rows_cols(boxes, hp, wp, img_size)
    return in_y & in_x


def crop_mask_to_box(masks: torch.Tensor, boxes: torch.Tensor,
                     img_size: float, inplace: bool = False) -> torch.Tensor:
    """Zero mask pixels outside each box: masks [..., D, Hp, Wp], boxes
    [..., D, 4] xyxy in image pixels. The crop is a product of a row and a
    column factor, so no [..., Hp, Wp] crop tensor is made."""
    in_y, in_x = (t.to(masks.dtype) for t in _box_rows_cols(boxes, *masks.shape[-2:],
                                                             img_size))
    if inplace:
        return masks.mul_(in_y).mul_(in_x)
    return masks * in_y * in_x


def assemble_masks_batch(protos: torch.Tensor, coeffs: torch.Tensor,
                         boxes: torch.Tensor, img_size: float, crop: bool = True,
                         logits: bool = False) -> torch.Tensor:
    """protos [B, Hp, Wp, K] x coeffs [B, D, K] (x boxes [B, D, 4]) ->
    masks [B, D, Hp, Wp] (fp32 probabilities, or logits with `logits`):
    one batched matmul (B, D, K) @ (B, K, Hp*Wp)."""
    b, hp, wp, k = protos.shape
    m = torch.bmm(coeffs.float(), protos.float().reshape(b, hp * wp, k).transpose(1, 2))
    m = m.reshape(b, -1, hp, wp)
    inplace = not m.requires_grad          # the matmul's output is ours to overwrite
    if not logits:
        m = m.sigmoid_() if inplace else torch.sigmoid(m)
    if crop:
        m = crop_mask_to_box(m, boxes, img_size, inplace)
    return m


def assemble_masks(protos: torch.Tensor, coeffs: torch.Tensor, boxes: torch.Tensor,
                   img_size: float, crop: bool = True,
                   logits: bool = False) -> torch.Tensor:
    """protos [Hp, Wp, K] x coeffs [D, K] -> masks [D, Hp, Wp]."""
    return assemble_masks_batch(protos[None], coeffs[None], boxes[None], img_size,
                                crop, logits)[0]


def upsample_masks(masks: torch.Tensor, out_hw: Tuple[int, int],
                   threshold: Optional[float] = 0.5) -> torch.Tensor:
    """[..., Hp, Wp] -> [..., H, W] bilinear at pixel centres (JAX's
    `jax.image.resize`, no antialiasing: the masks only grow); optionally
    binarized at `threshold` to uint8."""
    lead = masks.shape[:-2]
    x = masks.reshape(-1, 1, *masks.shape[-2:]).float()
    up = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)
    up = up.reshape(*lead, *out_hw)
    if threshold is not None:
        return (up > threshold).to(torch.uint8)
    return up


# ---- numpy helpers (host side) ------------------------------------------- #
def rle_encode_np(mask) -> dict:
    """Binary [H, W] mask -> COCO-style uncompressed RLE: column-major scan,
    alternating run lengths starting with a run of zeros (pycocotools'
    `frPyObjects` convention)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    flat = (mask > 0).flatten(order="F")
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(idx)
    if flat.size and flat[0]:  # counts must start with a zero-run
        counts = np.concatenate([[0], counts])
    return {"size": [int(h), int(w)], "counts": counts.astype(np.uint32)}


def rle_decode_np(rle: dict) -> np.ndarray:
    """COCO uncompressed RLE -> binary [H, W] uint8 mask."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[: h * w].reshape((h, w), order="F")


def rle_area(rle: dict) -> int:
    """Foreground pixel count from the run lengths (no decode)."""
    counts = np.asarray(rle["counts"], np.int64)
    return int(counts[1::2].sum())


def rasterize_box_masks_np(boxes, img_size: int, proto_size: int) -> np.ndarray:
    """GT boxes -> rectangular masks [M, proto, proto] (for box-only labels)."""
    m = len(boxes)
    out = np.zeros((m, proto_size, proto_size), np.float32)
    scale = proto_size / float(img_size)
    for i, (x1, y1, x2, y2) in enumerate(np.asarray(boxes, np.float32)):
        xa, ya = int(round(x1 * scale)), int(round(y1 * scale))
        xb, yb = int(round(x2 * scale)), int(round(y2 * scale))
        out[i, max(0, ya):max(0, yb), max(0, xa):max(0, xb)] = 1.0
    return out


def assemble_masks_np(protos, coeffs, boxes, img_size: float,
                      crop: bool = True) -> np.ndarray:
    """numpy twin of `assemble_masks` for host-only runners: protos
    [Hp,Wp,K] x coeffs [D,K] -> [D,Hp,Wp] probabilities cropped to boxes
    (letterbox pixels)."""
    protos = np.asarray(protos, np.float32)
    coeffs = np.asarray(coeffs, np.float32)
    hp, wp, _ = protos.shape
    m = 1.0 / (1.0 + np.exp(-np.einsum("hwk,dk->dhw", protos, coeffs)))
    if crop and len(boxes):
        ys = (np.arange(hp, dtype=np.float32) + 0.5) * (img_size / hp)
        xs = (np.arange(wp, dtype=np.float32) + 0.5) * (img_size / wp)
        b = np.asarray(boxes, np.float32)
        in_x = (xs[None, None, :] >= b[:, 0, None, None]) & \
               (xs[None, None, :] <= b[:, 2, None, None])
        in_y = (ys[None, :, None] >= b[:, 1, None, None]) & \
               (ys[None, :, None] <= b[:, 3, None, None])
        m = m * (in_x & in_y)
    return m
