"""Shadow and sun-flare effects (port of `data/weather.py`, the two effects
that the `strong` augmentation preset draws).

Both are photometric: labels are unchanged. The offline weather tool (rain,
snow, fog, dataset copies) is not ported: it writes JPEG files, and the port
has no JPEG encoder.
"""

from __future__ import annotations

import numpy as np

from yololite_tpu_torch.data import imgops


def add_sunflare(img: np.ndarray, rng: np.random.RandomState):
    h, w = img.shape[:2]
    cx = rng.randint(0, w)
    cy = rng.randint(0, h // 2)   # flare in the upper half (reference flare_roi)
    overlay = img.astype(np.float32)
    max_r = int(min(h, w) * rng.uniform(0.3, 0.6))
    for r in range(max_r, 0, -max(1, max_r // 10)):
        alpha = 0.08 * (r / max_r)
        circle = np.zeros_like(overlay)
        imgops.fill_circle(circle, (cx, cy), r, (255, 240, 200))
        overlay = overlay * (1 - alpha) + circle * alpha
    return np.clip(overlay, 0, 255).astype(np.uint8)


def add_shadow(img: np.ndarray, rng: np.random.RandomState,
               strength: float = 0.5, dimension: int = 5):
    h, w = img.shape[:2]
    # random polygon in the lower half (reference shadow_roi=(0,0.5,1,1))
    pts = np.stack([rng.randint(0, w, dimension),
                    rng.randint(h // 2, h, dimension)], axis=1)
    mask = np.zeros((h, w), np.uint8)
    imgops.fill_convex_poly(mask, imgops.convex_hull(pts), 255)
    mask = imgops.box_blur_u8(mask, 25).astype(np.float32) / 255.0
    out = img.astype(np.float32) * (1 - strength * mask[..., None])
    return np.clip(out, 0, 255).astype(np.uint8)
