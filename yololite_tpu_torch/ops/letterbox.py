"""Letterbox preprocessing geometry and the host-side resize (port of
`ops/letterbox.py`).

  scale = min(s/h, s/w); the resized image is centred on an s x s canvas of
  value 114 with integer pads (pad_x, pad_y) = ((s - nw)//2, (s - nh)//2);
  boxes map back through pad and scale and are clipped to the image.

The resize is bilinear with half-pixel centres and no antialiasing, rounded to
uint8 (what `cv2.INTER_LINEAR` does, to within one intensity level), written in
PyTorch so the package needs neither cv2 nor PIL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114


def letterbox_params(h: int, w: int, img_size: int) -> Tuple[float, int, int]:
    """(scale, pad_x, pad_y) mapping an (h, w) image into a centred
    img_size x img_size canvas."""
    scale = min(img_size / float(h), img_size / float(w))
    nw, nh = int(round(w * scale)), int(round(h * scale))
    return scale, (img_size - nw) // 2, (img_size - nh) // 2


def _resize_bilinear(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """uint8 HWC (or HW) -> uint8 (nh, nw[, C]), half-pixel bilinear."""
    if img.shape[:2] == (nh, nw):
        return img.copy()
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.float32)
    x = x[None, :, :, None] if x.ndim == 2 else x[None]
    x = x.permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                      antialias=False)
    y = y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)[0]
    y = y.numpy()
    return y[..., 0] if img.ndim == 2 else y


def letterbox_image(img: np.ndarray, img_size: int, pad_value: int = PAD_VALUE):
    """Resize-keep-aspect + centred pad -> (canvas uint8 [S,S,C], scale, pad_x, pad_y)."""
    h, w = img.shape[:2]
    scale, pad_x, pad_y = letterbox_params(h, w, img_size)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    resized = _resize_bilinear(img, nw, nh)
    canvas = np.full((img_size, img_size, img.shape[2] if img.ndim == 3 else 1),
                     pad_value, dtype=img.dtype)
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized.reshape(
        nh, nw, canvas.shape[2])
    return canvas, scale, pad_x, pad_y


def resize_image(img: np.ndarray, img_size: int):
    """Plain square resize -> (img, sx, sy)."""
    h, w = img.shape[:2]
    return (_resize_bilinear(img, img_size, img_size), img_size / float(w),
            img_size / float(h))


def unletterbox_boxes(boxes_xyxy: np.ndarray, scale, pad_x: float, pad_y: float,
                      orig_w: int, orig_h: int) -> np.ndarray:
    """Map canvas boxes back to original pixels and clip. `scale` is a float
    (letterbox) or an (sx, sy) pair (plain resize)."""
    sx, sy = (scale if isinstance(scale, (tuple, list)) else (scale, scale))
    b = np.asarray(boxes_xyxy, dtype=np.float32).copy()
    b[..., [0, 2]] = (b[..., [0, 2]] - pad_x) / max(sx, 1e-12)
    b[..., [1, 3]] = (b[..., [1, 3]] - pad_y) / max(sy, 1e-12)
    b[..., [0, 2]] = b[..., [0, 2]].clip(0, orig_w - 1)
    b[..., [1, 3]] = b[..., [1, 3]].clip(0, orig_h - 1)
    return b
