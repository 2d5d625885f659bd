"""Photometric augmentation on the device, inside the train step (port of
`data/device_augment.py`, `training.device_augment: true`).

The host pipeline then keeps the geometry only (`photometric=False`). Every
host colour op is affine in RGB, so the colour OneOf becomes one per-image
3x3 matrix and bias, chosen from five branches (brightness/contrast, colour
jitter, an HSV-like shift, RGB shift, channel shuffle) with probability
`p_color`; then gaussian noise or a 3-tap mean along H or W (`roll` at the
borders) with probability `p_noise`; then round (half to even) and clip to
uint8. Hue and saturation act in RGB (a rotation about the gray axis, a lerp
towards luma), not through uint8 HSV.

The work is split in two: `draw` takes every random number from an explicit
`torch.Generator`, and `apply` is a pure function of the images and the
drawn tensors. The JAX package draws from `jax.random`, whose streams torch
cannot reproduce: only the distribution is the reference's, which the tests
hold; `apply` on JAX's draws equals JAX's output within one level.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# ITU-R BT.601 luma, as cv2's RGB2GRAY
LUMA = (0.299, 0.587, 0.114)
# the 6 permutations of 3 channels (channel_shuffle's sample space)
PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
_HUE_C = ((0.701, -0.587, -0.114), (-0.299, 0.413, -0.114), (-0.300, -0.588, 0.886))
_HUE_S = ((0.168, 0.330, -0.497), (-0.328, 0.035, 0.292), (1.250, -1.050, -0.203))


def saturation_matrix(s: torch.Tensor) -> torch.Tensor:
    """lerp(gray, img, s) as [..., 3, 3] matrices (luma-preserving)."""
    eye = torch.eye(3, dtype=torch.float32, device=s.device)
    gray = torch.tensor(LUMA, dtype=torch.float32, device=s.device).expand(3, 3)
    s = s[..., None, None]
    return s * eye + (1.0 - s) * gray


def hue_matrix(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about the gray axis (YIQ hue rotate) by theta radians, as
    [..., 3, 3] matrices."""
    dev = theta.device
    base = torch.tensor(LUMA, dtype=torch.float32, device=dev).expand(3, 3)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    return (base + c * torch.tensor(_HUE_C, dtype=torch.float32, device=dev)
            + s * torch.tensor(_HUE_S, dtype=torch.float32, device=dev))


def _uniform(n, lo, hi, gen, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def color_params(batch: int, gen: torch.Generator, p_color: float = 0.4,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """Per-image (m [B,3,3], b [B,3]) of the colour OneOf, with the branch
    (0-4) and whether it applies, as JAX's `_color_params` draws them."""
    eye = torch.eye(3, dtype=torch.float32, device=device)
    alpha = 1.0 + _uniform(batch, -0.2, 0.2, gen, device)
    beta = _uniform(batch, -0.2, 0.2, gen, device) * 255.0
    m_bc = alpha[:, None, None] * eye
    b_bc = beta[:, None].expand(batch, 3)

    sat = 1.0 + _uniform(batch, -0.15, 0.15, gen, device)
    hue = _uniform(batch, -0.05, 0.05, gen, device) * (2.0 * math.pi)
    m_cj = hue_matrix(hue) @ saturation_matrix(sat) @ m_bc

    hue2 = _uniform(batch, -5.0, 5.0, gen, device) * (math.pi / 90.0)
    sat2 = 1.0 + _uniform(batch, -0.12, 0.12, gen, device)
    val2 = _uniform(batch, -15.0, 15.0, gen, device)
    m_hsv = hue_matrix(hue2) @ saturation_matrix(sat2)
    b_hsv = val2[:, None].expand(batch, 3)

    b_rgb = torch.randint(-20, 21, (batch, 3), generator=gen, device=device).float()
    m_rgb = eye.expand(batch, 3, 3)

    pidx = torch.randint(0, 6, (batch,), generator=gen, device=device)
    perms = torch.tensor(PERMS, device=device)
    m_sh = torch.nn.functional.one_hot(perms[pidx], 3).float()
    zeros = torch.zeros(batch, 3, device=device)

    ms = torch.stack([m_bc, m_cj, m_hsv, m_rgb, m_sh], 1)     # [B,5,3,3]
    bs = torch.stack([b_bc, b_bc, b_hsv, b_rgb, zeros], 1)    # [B,5,3]
    branch = torch.randint(0, 5, (batch,), generator=gen, device=device)
    rows = torch.arange(batch, device=device)
    on = torch.rand(batch, generator=gen, device=device) < p_color
    m = torch.where(on[:, None, None], ms[rows, branch], eye)
    b = torch.where(on[:, None], bs[rows, branch], zeros)
    return {"m": m, "b": b, "branch": branch, "color_on": on}


def draw(shape, gen: torch.Generator, p_color: float = 0.4, p_noise: float = 0.15,
         device="cpu") -> Dict[str, torch.Tensor]:
    """Every random number of one batch [B,H,W,3]: the colour matrix and
    bias, the unit-normal noise and its sigma, the noise/blur choice and the
    blur direction."""
    batch = shape[0]
    out = color_params(batch, gen, p_color, device)
    u = torch.rand(batch, generator=gen, device=device)
    out["do_noise"] = u < p_noise * 0.5
    out["do_blur"] = (u >= p_noise * 0.5) & (u < p_noise)
    out["sigma"] = torch.sqrt(_uniform(batch, 5.0, 20.0, gen, device))
    out["noise"] = torch.randn(tuple(shape), generator=gen, device=device)
    out["horizontal"] = torch.rand(batch, generator=gen, device=device) < 0.5
    return out


def apply(images_u8: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B,H,W,3] uint8 -> uint8 through the drawn parameters `p`."""
    x = images_u8.to(torch.float32)
    m, b = p["m"], p["b"]
    # per pixel: out_c = sum_d m[c, d] * in_d + b_c (d in order, no matmul:
    # a TF32 matmul would round the product)
    y = b[:, None, None, :] + x[..., 0:1] * m[:, None, None, :, 0]
    y = y + x[..., 1:2] * m[:, None, None, :, 1]
    y = y + x[..., 2:3] * m[:, None, None, :, 2]
    per_image = {k: p[k][:, None, None, None]
                 for k in ("do_noise", "sigma", "horizontal", "do_blur")}
    y = torch.where(per_image["do_noise"], y + p["noise"] * per_image["sigma"], y)
    blur_w = (torch.roll(y, 1, 2) + y + torch.roll(y, -1, 2)) / 3.0
    blur_h = (torch.roll(y, 1, 1) + y + torch.roll(y, -1, 1)) / 3.0
    blur = torch.where(per_image["horizontal"], blur_w, blur_h)
    y = torch.where(per_image["do_blur"], blur, y)
    return torch.clamp(torch.round(y), 0.0, 255.0).to(torch.uint8)


def photometric_augment(images_u8: torch.Tensor, gen: torch.Generator,
                        p_color: float = 0.4, p_noise: float = 0.15) -> torch.Tensor:
    """Draw from `gen` (on the images' device) and apply."""
    return apply(images_u8, draw(images_u8.shape, gen, p_color, p_noise,
                                 images_u8.device))
