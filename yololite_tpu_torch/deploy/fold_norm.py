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

The stem conv is found by name: the backbone's `ConvBNAct_0` conv with a
3-channel input, or the conv of a `Focus_0` stem with a 12-channel input
(after the 2x2 space-to-depth, whose channels repeat R, G, B four times).
JAX's interceptor instead corrects every conv with a 3- or 12-channel input,
which also hits the 12-channel SE convs of EfficientNetV2-B0/B1 (ROADMAP
Queue 3); the port folds only the stem.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
A = (1.0 / (255.0 * _STD)).astype(np.float32)
B = (-_MEAN / _STD).astype(np.float32)

# candidate stem conv weights, in the order the JAX `_find_stem` tries them
STEM_KEYS = ("backbone.ConvBNAct_0.Conv_0.weight",
             "backbone.Focus_0.ConvBNAct_0.Conv_0.weight")


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """NCHW uint8 -> ImageNet-normalized `dtype` (x/255 - mean)/std in fp32."""
    mean = torch.as_tensor(_MEAN, device=images_u8.device)[None, :, None, None]
    std = torch.as_tensor(_STD, device=images_u8.device)[None, :, None, None]
    x = images_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)


def raw_cast(images_u8: torch.Tensor, dtype) -> torch.Tensor:
    """Input transform matching folded parameters."""
    return images_u8.to(dtype)


def find_stem(state_dict: Dict[str, torch.Tensor]) -> Optional[str]:
    """Key of the stem conv weight (3 or 12 input channels), or None."""
    for key in STEM_KEYS:
        w = state_dict.get(key)
        if w is not None and w.ndim == 4 and w.shape[1] in (3, 12):
            return key
    return None


def fold_normalization(state_dict: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict[str, torch.Tensor], bool]:
    """Scale the stem conv kernel by the per-channel slope `a` (tiled over
    the Focus stem's 4 RGB groups). Returns (state_dict', ok); ok is False
    when no stem is found."""
    key = find_stem(state_dict)
    if key is None:
        return state_dict, False
    w = state_dict[key]
    out = dict(state_dict)
    a = torch.as_tensor(np.tile(A, w.shape[1] // 3), device=w.device)
    out[key] = (w.to(torch.float32) * a[None, :, None, None]).to(w.dtype)
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
            cin = self.in_channels
            c = torch.as_tensor(np.tile(B / A, cin // 3), device=wt.device).to(wt.dtype)
            ones = c[None, :, None, None].expand(1, cin, h, w).contiguous()
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
    key = find_stem(model.state_dict())
    if key is None:
        raise ValueError("no 3- or 12-channel stem conv to fold")
    parent = model.get_submodule(key[:-len(".Conv_0.weight")])
    conv = parent.Conv_0
    folded = FoldedStemConv(conv.in_channels, conv.out_channels, conv.kernel_size,
                            stride=conv.stride, padding=conv.padding,
                            groups=conv.groups, bias=conv.bias is not None)
    folded.to(device=conv.weight.device, dtype=conv.weight.dtype)
    folded.load_state_dict(conv.state_dict())
    parent.Conv_0 = folded
    return model
