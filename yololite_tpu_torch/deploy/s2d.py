"""Space-to-depth stem (deploy-time, exact; port of `deploy/s2d.py`).

The zoo's stem is a 3x3 stride-2 conv over 3 channels. Packing each
non-overlapping 2x2 pixel block into channels ([B,H,W,3] uint8 ->
[B,H/2,W/2,12], a byte shuffle on the host, `pack_s2d`) turns it into a 2x2
stride-1 conv over 12 channels with the same outputs. The stem pads (1,1),
so output p reads input rows 2p-1..2p+1: tap ki maps to block position pi
and phase di by ki = 2*pi + di - 1 ((pi,di) = (0,0) falls outside the 3x3
kernel and stays zero), and the rewritten conv pads (1,0) in blocks. Phases
are (di,dj)-major, channel-minor.

`S2DStemConv` runs that conv plus the folded-normalize correction (the
constant b/a, tiled over the 4 phases, through the same rewritten kernel;
see `fold_norm.py`), cached per input size like `FoldedStemConv`'s. The
(1,0) padding is computed as a (1,1)-padded conv whose last row and column
are dropped: they are the only outputs that read the bottom/right pad, so
the rest equal the (1,0)-padded conv's, without copying the input into a
padded buffer. Its convs are cuDNN's; the JAX package has no kernel here.

Apply after `fold_normalization`, to a 3-channel 3x3 stem only: a Focus
stem (12 channels already) keeps s2d off, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yololite_tpu_torch import native
from yololite_tpu_torch.deploy.fold_norm import A, B, find_stem


def rewrite_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """[O, 3k, 3, 3] -> [O, 12k, 2, 2] fp32, an exact tap remapping."""
    w = np.asarray(torch.as_tensor(w).detach().cpu(), np.float32)
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d stem rewrite expects a 3x3 kernel, got {w.shape}")
    w2 = np.zeros((cout, 4 * cin, 2, 2), np.float32)
    for pi in range(2):
        for di in range(2):
            ki = 2 * pi + di - 1
            if not 0 <= ki <= 2:
                continue
            for pj in range(2):
                for dj in range(2):
                    kj = 2 * pj + dj - 1
                    if not 0 <= kj <= 2:
                        continue
                    ph = di * 2 + dj
                    w2[:, ph * cin:(ph + 1) * cin, pi, pj] = w[:, :, ki, kj]
    return torch.from_numpy(w2)


def rewrite_stem_to_s2d(state_dict: Dict[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor], bool]:
    """The state_dict with its 3-channel 3x3 stem kernel rewritten to 2x2x12
    (after `fold_normalization`). Returns (state_dict', ok); ok is False for
    a Focus stem or no stem."""
    key = find_stem(state_dict)
    if key is None:
        return state_dict, False
    w = state_dict[key]
    if w.shape[1] != 3 or tuple(w.shape[2:]) != (3, 3):
        return state_dict, False
    out = dict(state_dict)
    out[key] = rewrite_stem_kernel(w).to(device=w.device, dtype=w.dtype)
    return out, True


def pack_s2d(images: np.ndarray) -> np.ndarray:
    """Host pack [B,H,W,C] (or [H,W,C]) -> [...,H/2,W/2,4C]; uint8 through
    the host C++ library, other types through numpy."""
    squeeze = images.ndim == 3
    if squeeze:
        images = images[None]
    out = (native.pack_s2d(images) if images.dtype == np.uint8
           else native.pack_s2d_plain(images))
    return out[0] if squeeze else out


def pack_s2d_device(images: torch.Tensor) -> torch.Tensor:
    """The same pack of a [B,H,W,C] tensor where it lies (a view and a permute)."""
    b, h, w, c = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d pack needs even H,W, got {(h, w)}")
    return (images.view(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, h // 2, w // 2, 4 * c))


class S2DStemConv(nn.Conv2d):
    """The rewritten stem: 2x2/s1 over the 12-channel packed input, padded
    (1,0) in blocks, plus the cached folded-normalize correction."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=1, padding=1, bias=False)
        self._corr: Dict[tuple, torch.Tensor] = {}

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        # (1,1)-padded conv without its last row and column == (1,0)-padded
        return super().forward(x)[:, :, :x.shape[2], :x.shape[3]]

    def correction(self, h: int, w: int) -> torch.Tensor:
        wt = self.weight
        key = (h, w, wt.dtype, wt.device, wt._version, wt.data_ptr())
        corr = self._corr.get(key)
        if corr is None:
            c = torch.as_tensor(np.tile(B / A, self.in_channels // 3), device=wt.device)
            ones = c.to(wt.dtype)[None, :, None, None].expand(1, self.in_channels, h, w)
            with torch.no_grad():
                corr = self._conv(ones.contiguous())
            self._corr = {key: corr}
        return corr

    def forward(self, x):
        return self._conv(x) + self.correction(x.shape[2], x.shape[3])


def s2d_stem(model: nn.Module) -> nn.Module:
    """Swap the backbone's 3x3 stem conv for an `S2DStemConv` of the rewritten
    shape (load the rewritten state_dict afterwards). The model must then be
    fed the packed batch, `raw_cast`."""
    key = find_stem(model.state_dict())
    if key is None or model.get_parameter(key).shape[1] != 3:
        raise ValueError("no 3-channel 3x3 stem conv to rewrite")
    parent = model.get_submodule(key[:-len(".Conv_0.weight")])
    conv = parent.Conv_0
    stem = S2DStemConv(4 * conv.in_channels, conv.out_channels)
    parent.Conv_0 = stem.to(device=conv.weight.device, dtype=conv.weight.dtype)
    return model
