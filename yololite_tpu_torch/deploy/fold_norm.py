"""Fold ImageNet input normalization into the stem conv (deploy-time, exact).

Port of `deploy/fold_norm.py`. Normalization is affine per channel,
x_n = a*x + b, and the convolution is linear, so

    conv(w)(a*x + b) = conv(w*a)(x) + conv(w*a)((b/a) * ones)

including the zero padding (both right-hand terms zero-pad). The first term
is the stem conv with its kernel scaled by `a` (`fold_normalization`); the
second does not depend on the batch, so `FoldedStemConv` computes it once per
(input size, dtype, device) as a [1, C, H, W] map and adds it. The model then
consumes the raw uint8 image cast to the compute dtype (0..255 is exact in
bf16) and never materializes the normalized image.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
A = (1.0 / (255.0 * _STD)).astype(np.float32)
B = (-_MEAN / _STD).astype(np.float32)

STEM_KEY = "backbone.ConvBNAct_0.Conv_0.weight"


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """NCHW uint8 -> ImageNet-normalized `dtype` (x/255 - mean)/std in fp32."""
    mean = torch.as_tensor(_MEAN, device=images_u8.device)[None, :, None, None]
    std = torch.as_tensor(_STD, device=images_u8.device)[None, :, None, None]
    x = images_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)


def raw_cast(images_u8: torch.Tensor, dtype) -> torch.Tensor:
    """Input transform matching folded parameters."""
    return images_u8.to(dtype)


def fold_normalization(state_dict: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], bool]:
    """Scale the stem conv kernel by the per-channel slope `a`.
    Returns (state_dict', ok); ok is False when no 3-channel stem is found."""
    w = state_dict.get(STEM_KEY)
    if w is None or w.ndim != 4 or w.shape[1] != 3:
        return state_dict, False
    out = dict(state_dict)
    a = torch.as_tensor(A, device=w.device)[None, :, None, None]
    out[STEM_KEY] = (w.to(torch.float32) * a).to(w.dtype)
    return out, True


class FoldedStemConv(nn.Conv2d):
    """The stem conv of a folded model: conv(x) + the cached correction map
    conv((b/a) * ones) through the same (scaled) kernel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._corr: Dict[tuple, torch.Tensor] = {}

    def correction(self, h: int, w: int) -> torch.Tensor:
        wt = self.weight
        key = (h, w, wt.dtype, wt.device, wt._version, wt.data_ptr())
        corr = self._corr.get(key)
        if corr is None:
            c = torch.as_tensor(B / A, device=wt.device).to(wt.dtype)
            ones = c[None, :, None, None].expand(1, 3, h, w).contiguous()
            with torch.no_grad():
                corr = F.conv2d(ones, wt, None, self.stride, self.padding,
                                self.dilation, self.groups)
            self._corr = {key: corr}
        return corr

    def forward(self, x):
        return super().forward(x) + self.correction(x.shape[2], x.shape[3])


def folded_stem(model: nn.Module) -> nn.Module:
    """Swap the backbone's stem conv for a `FoldedStemConv` holding the same
    (already scaled) weights. The model must then be fed `raw_cast` input."""
    parent = model.backbone.ConvBNAct_0
    conv = parent.Conv_0
    folded = FoldedStemConv(conv.in_channels, conv.out_channels, conv.kernel_size,
                            stride=conv.stride, padding=conv.padding,
                            groups=conv.groups, bias=conv.bias is not None)
    folded.to(device=conv.weight.device, dtype=conv.weight.dtype)
    folded.load_state_dict(conv.state_dict())
    parent.Conv_0 = folded
    return model
