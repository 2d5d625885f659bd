"""Building blocks of the edge detectors (PyTorch, NCHW, eval-mode BatchNorm).

Port of `yololite_tpu/models/layers.py` for the blocks the MobileNetV4-Conv-S
backbone and the YOLOLiteMS neck/heads need: ConvBNAct, ConvBlock, DWConvBlock,
UIB and the nearest upsample. The other blocks of the zoo (MBConv, FusedMBConv,
BasicBlock, ConvNeXtV2, CS3, Focus, HGBlock) come with the other backbones.

Submodules carry the names flax gives their counterparts (`Conv_0`,
`BatchNorm_0`, `ConvBNAct_2`, ...), so a flax parameter path maps onto a torch
`state_dict` key by a plain rename (see `yololite_tpu_torch/convert.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ACTS = {
    "silu": F.silu,
    "relu": F.relu,
    "relu6": F.relu6,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "hardswish": F.hardswish,
    None: lambda x: x,
    "none": lambda x: x,
}


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return int(new_v)


class BatchNorm(nn.Module):
    """Inference BatchNorm (eps 1e-5) holding flax's scale/bias/mean/var as
    weight/bias/running_mean/running_var. Training-mode statistics wait for
    the training slice."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
           bias: bool = True) -> nn.Conv2d:
    """flax `nn.Conv` with symmetric padding kernel//2 (explicit or SAME at
    stride 1 — the only cases the ported blocks use)."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     groups=groups, bias=bias)


class ConvBNAct(nn.Module):
    """Conv2D (no bias) -> BatchNorm -> activation."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: Optional[str] = "silu"):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.act = ACTS[act]

    def forward(self, x):
        return self.act(self.BatchNorm_0(self.Conv_0(x)))


class ConvBlock(nn.Module):
    """n x (Conv3x3-BN-act): the FPN smooth block of the non-CPU variant."""

    def __init__(self, cin: int, features: int, n: int = 1, act: str = "silu"):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"ConvBNAct_{i}",
                            ConvBNAct(cin if i == 0 else features, features, 3, 1,
                                      act=act))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"ConvBNAct_{i}")(x)
        return x


class DWConvBlock(nn.Module):
    """n x (DWConv3x3 -> Conv1x1 -> BN -> ReLU); BN only after the pointwise."""

    def __init__(self, cin: int, features: int, n: int = 1):
        super().__init__()
        self.n = n
        c = cin
        for i in range(n):
            self.add_module(f"Conv_{2 * i}", conv2d(c, c, 3, groups=c, bias=False))
            self.add_module(f"Conv_{2 * i + 1}", conv2d(c, features, 1, bias=False))
            self.add_module(f"BatchNorm_{i}", BatchNorm(features))
            c = features

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Conv_{2 * i}")(x)
            x = getattr(self, f"Conv_{2 * i + 1}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
        return x


class UIB(nn.Module):
    """Universal Inverted Bottleneck (MobileNetV4): optional start-DW ->
    1x1 expand -> optional mid-DW -> 1x1 project. Inner ConvBNAct_<i> count
    only the convs that exist, as flax's auto-names do."""

    def __init__(self, cin: int, features: int, expand: float = 4.0,
                 dw_start: int = 0, dw_mid: int = 3, stride: int = 1,
                 act: str = "relu"):
        super().__init__()
        stride_on_mid = dw_mid > 0
        mid = make_divisible(cin * expand)
        convs = []
        if dw_start > 0:
            convs.append(ConvBNAct(cin, cin, dw_start, 1 if stride_on_mid else stride,
                                   groups=cin, act=None))
        convs.append(ConvBNAct(cin, mid, 1, 1, act=act))
        if dw_mid > 0:
            convs.append(ConvBNAct(mid, mid, dw_mid, stride, groups=mid, act=act))
        convs.append(ConvBNAct(mid, features, 1, 1, act=None))
        self.n = len(convs)
        for i, m in enumerate(convs):
            self.add_module(f"ConvBNAct_{i}", m)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = x
        for i in range(self.n):
            h = getattr(self, f"ConvBNAct_{i}")(h)
        return h + x if self.residual else h


def upsample_nearest_to(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of an NCHW map to (H, W).

    The JAX version repeats for exact x2 and otherwise calls
    `jax.image.resize(..., "nearest")`, which samples at pixel centres: that
    is torch's `nearest-exact`, not its legacy `nearest`. At exact x2
    `nearest-exact` is the repeat, so one call covers both cases."""
    return F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")
