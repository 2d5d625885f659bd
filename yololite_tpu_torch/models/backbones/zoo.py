"""Backbone zoo (PyTorch port of `yololite_tpu/models/backbones/zoo.py`).

Same interface as the JAX zoo: `build_backbone(name) -> (module, feature_info)`,
the module returns one NCHW feature map per stage, and feature_info is a list
of {"num_chs", "reduction"}. `_specs()` holds the same data as the JAX zoo's
table (all 16 backbones), so the two can be compared entry by entry.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

from torch import nn

from yololite_tpu_torch.models.layers import (
    UIB, BasicBlock, ConvBNAct, ConvNeXtV2Block, CS3Stage, Focus, FusedMBConv,
    HGBlock, MBConv, make_divisible,
)

BlockSpec = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _b(kind: str, **kwargs) -> BlockSpec:
    return (kind, tuple(sorted(kwargs.items())))


# Each class is named as its flax counterpart, so `<class>_<n>` is the flax name.
_BLOCK_CLASSES = {
    "conv": ConvBNAct,
    "mb": MBConv,
    "fused": FusedMBConv,
    "uib": UIB,
    "basic": BasicBlock,
    "cnx": ConvNeXtV2Block,
    "cs3": CS3Stage,
    "focus": Focus,
    "hg": HGBlock,
}


class StagedBackbone(nn.Module):
    """Generic staged feature extractor. Emits one feature map per stage.

    Blocks are named `<Class>_<n>` with one counter per class across stem and
    stages, as flax names them."""

    def __init__(self, stem, stages, in_chs: int = 3):
        super().__init__()
        counters: Dict[str, int] = {}
        c = in_chs

        def make(spec) -> str:
            nonlocal c
            kind, kw = spec
            cls = _BLOCK_CLASSES[kind]
            kw = dict(kw)
            cname = cls.__name__
            name = f"{cname}_{counters.get(cname, 0)}"
            counters[cname] = counters.get(cname, 0) + 1
            self.add_module(name, cls(c, **kw))
            c = kw["features"]
            return name

        self.stem_names = [make(s) for s in stem]
        self.stage_names = [[make(s) for s in stage] for stage in stages]

    def forward(self, x):
        for name in self.stem_names:
            x = getattr(self, name)(x)
        feats = []
        for stage in self.stage_names:
            for name in stage:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats


# --------------------------------------------------------------------------- #
# Architecture definitions
# --------------------------------------------------------------------------- #

def _scale_depth(n: int, mult: float) -> int:
    return int(math.ceil(n * mult))


# --------------------------------------------------------------------------- #
# Architecture definitions
# --------------------------------------------------------------------------- #

def _mobilenetv4_conv_small(width: float = 1.0):
    """MobileNetV4-Conv-S (paper table; timm 'mobilenetv4_conv_small[_050]')."""
    c = lambda v: make_divisible(v * width)
    stem = (_b("conv", features=c(32), kernel=3, stride=2, act="relu"),)
    stages = (
        # r4
        (_b("conv", features=c(32), kernel=3, stride=2, act="relu"),
         _b("conv", features=c(32), kernel=1, stride=1, act="relu")),
        # r8
        (_b("conv", features=c(96), kernel=3, stride=2, act="relu"),
         _b("conv", features=c(64), kernel=1, stride=1, act="relu")),
        # r16
        (_b("uib", features=c(96), expand=3.0, dw_start=5, dw_mid=5, stride=2),
         _b("uib", features=c(96), expand=2.0, dw_start=0, dw_mid=3),
         _b("uib", features=c(96), expand=2.0, dw_start=0, dw_mid=3),
         _b("uib", features=c(96), expand=2.0, dw_start=0, dw_mid=3),
         _b("uib", features=c(96), expand=2.0, dw_start=0, dw_mid=3),
         _b("uib", features=c(96), expand=4.0, dw_start=3, dw_mid=0)),
        # r32 — ends with the wide 1x1 "final conv" (timm blocks stage
        # `cn_r1_k1_s1_e1_c960`, scaled by width): it is part of features_only
        # output, so C5 fed to the FPN is 960*width channels, exactly as the
        # reference sees through timm feature_info (model_v2.py:94-101).
        (_b("uib", features=c(128), expand=6.0, dw_start=3, dw_mid=3, stride=2),
         _b("uib", features=c(128), expand=4.0, dw_start=5, dw_mid=5),
         _b("uib", features=c(128), expand=4.0, dw_start=0, dw_mid=5),
         _b("uib", features=c(128), expand=3.0, dw_start=0, dw_mid=5),
         _b("uib", features=c(128), expand=4.0, dw_start=0, dw_mid=3),
         _b("uib", features=c(128), expand=4.0, dw_start=0, dw_mid=3),
         _b("conv", features=c(960), kernel=1, stride=1, act="relu")),
    )
    info = [(4, c(32)), (8, c(64)), (16, c(96)), (32, c(960))]
    return stem, stages, info


def _efficientnet_lite(width: float, depth: float):
    """EfficientNet-Lite (no SE, ReLU6, fixed stem=32/head) — tf_efficientnet_lite0-4."""
    c = lambda v: make_divisible(v * width)
    d = lambda n: _scale_depth(n, depth)
    stem = (_b("conv", features=32, kernel=3, stride=2, act="relu6"),)  # lite: stem fixed

    def stage(reps, **kw):
        blocks = []
        for i in range(reps):
            b = dict(kw)
            if i > 0:
                b["stride"] = 1
            blocks.append(_b("mb", act="relu6", **b))
        return tuple(blocks)

    stages = (
        stage(1, features=c(16), expand=1.0, kernel=3, stride=1),                       # r2
        stage(d(2), features=c(24), expand=6.0, kernel=3, stride=2),                    # r4
        stage(d(2), features=c(40), expand=6.0, kernel=5, stride=2),                    # r8
        stage(d(3), features=c(80), expand=6.0, kernel=3, stride=2) +
        stage(d(3), features=c(112), expand=6.0, kernel=5, stride=1),                   # r16
        stage(d(4), features=c(192), expand=6.0, kernel=5, stride=2) +
        stage(1, features=c(320), expand=6.0, kernel=3, stride=1),                      # r32 (lite: last stage not repeated)
    )
    info = [(2, c(16)), (4, c(24)), (8, c(40)), (16, c(112)), (32, c(320))]
    return stem, stages, info


def _efficientnetv2_b(width: float, depth: float):
    """EfficientNetV2-B0/B1/B2 (fused early stages + SE MBConv later)."""
    c = lambda v: make_divisible(v * width)
    d = lambda n: _scale_depth(n, depth)
    stem = (_b("conv", features=c(32), kernel=3, stride=2, act="silu"),)

    def fused(reps, feats, e, s):
        return tuple(_b("fused", features=feats, expand=e, kernel=3,
                        stride=(s if i == 0 else 1)) for i in range(reps))

    def mb(reps, feats, e, k, s):
        return tuple(_b("mb", features=feats, expand=e, kernel=k, act="silu",
                        se_ratio=0.25, stride=(s if i == 0 else 1)) for i in range(reps))

    stages = (
        fused(d(1), c(16), 1.0, 1),                    # r2
        fused(d(2), c(32), 4.0, 2),                    # r4
        fused(d(2), c(48), 4.0, 2),                    # r8
        mb(d(3), c(96), 4.0, 3, 2) + mb(d(5), c(112), 6.0, 3, 1),   # r16
        mb(d(8), c(192), 6.0, 3, 2),                   # r32
    )
    info = [(2, c(16)), (4, c(32)), (8, c(48)), (16, c(112)), (32, c(192))]
    return stem, stages, info


def _resnet18():
    stem = (_b("conv", features=64, kernel=7, stride=2, act="relu"),
            _b("conv", features=64, kernel=3, stride=2, act="relu"))  # conv stride-2 in place of maxpool (TPU-friendlier)
    stages = (
        (_b("basic", features=64), _b("basic", features=64)),                     # r4
        (_b("basic", features=128, stride=2), _b("basic", features=128)),         # r8
        (_b("basic", features=256, stride=2), _b("basic", features=256)),         # r16
        (_b("basic", features=512, stride=2), _b("basic", features=512)),         # r32
    )
    info = [(4, 64), (8, 128), (16, 256), (32, 512)]
    return stem, stages, info


def _convnextv2_tiny():
    dims = (96, 192, 384, 768)
    depths = (3, 3, 9, 3)
    stem = (_b("conv", features=dims[0], kernel=4, stride=4, act=None),)
    stages = []
    for i, (dim, dep) in enumerate(zip(dims, depths)):
        blocks = []
        if i > 0:
            blocks.append(_b("conv", features=dim, kernel=2, stride=2, act=None))
        blocks += [_b("cnx", features=dim) for _ in range(dep)]
        stages.append(tuple(blocks))
    info = [(4, dims[0]), (8, dims[1]), (16, dims[2]), (32, dims[3])]
    return stem, tuple(stages), info


def _cs3darknet_focus(width: float, depths: Sequence[int]):
    c = lambda v: make_divisible(v * width)
    stem = (_b("focus", features=c(64), kernel=3),)  # r2
    chans = [c(128), c(256), c(512), c(1024)]
    stages = []
    for ch, n in zip(chans, depths):
        stages.append((_b("conv", features=ch, kernel=3, stride=2, act="silu"),
                       _b("cs3", features=ch, n=n)))
    info = [(4, chans[0]), (8, chans[1]), (16, chans[2]), (32, chans[3])]
    return stem, tuple(stages), info


def _hgnetv2_b0():
    stem = (_b("conv", features=16, kernel=3, stride=2, act="relu"),
            _b("conv", features=16, kernel=3, stride=1, act="relu"))
    stages = (
        (_b("conv", features=16, kernel=3, stride=2, act="relu"),
         _b("hg", mid=16, features=64, layers=6)),                                # r4
        (_b("conv", features=64, kernel=3, stride=2, act="relu"),
         _b("hg", mid=32, features=256, layers=6)),                               # r8
        (_b("conv", features=256, kernel=3, stride=2, act="relu"),
         _b("hg", mid=64, features=512, layers=6, residual=True),
         _b("hg", mid=64, features=512, layers=6, residual=True)),                # r16
        (_b("conv", features=512, kernel=3, stride=2, act="relu"),
         _b("hg", mid=128, features=1024, layers=6)),                             # r32
    )
    info = [(4, 64), (8, 256), (16, 512), (32, 1024)]
    return stem, stages, info


def _mobilenetv3_large():
    """MobileNetV3-Large-1.0 (paper Table 1; SE where specified, hardswish)."""
    stem = (_b("conv", features=16, kernel=3, stride=2, act="hardswish"),)
    stages = (
        (_b("mb", features=16, expand=1.0, kernel=3, stride=1, act="relu"),),     # r2
        (_b("mb", features=24, expand=4.0, kernel=3, stride=2, act="relu"),
         _b("mb", features=24, expand=3.0, kernel=3, stride=1, act="relu")),      # r4
        (_b("mb", features=40, expand=3.0, kernel=5, stride=2, act="relu", se_ratio=0.25),
         _b("mb", features=40, expand=3.0, kernel=5, stride=1, act="relu", se_ratio=0.25),
         _b("mb", features=40, expand=3.0, kernel=5, stride=1, act="relu", se_ratio=0.25)),  # r8
        (_b("mb", features=80, expand=6.0, kernel=3, stride=2, act="hardswish"),
         _b("mb", features=80, expand=2.5, kernel=3, stride=1, act="hardswish"),
         _b("mb", features=80, expand=2.3, kernel=3, stride=1, act="hardswish"),
         _b("mb", features=80, expand=2.3, kernel=3, stride=1, act="hardswish"),
         _b("mb", features=112, expand=6.0, kernel=3, stride=1, act="hardswish", se_ratio=0.25),
         _b("mb", features=112, expand=6.0, kernel=3, stride=1, act="hardswish", se_ratio=0.25)),  # r16
        (_b("mb", features=160, expand=6.0, kernel=5, stride=2, act="hardswish", se_ratio=0.25),
         _b("mb", features=160, expand=6.0, kernel=5, stride=1, act="hardswish", se_ratio=0.25),
         _b("mb", features=160, expand=6.0, kernel=5, stride=1, act="hardswish", se_ratio=0.25),
         _b("conv", features=960, kernel=1, stride=1, act="hardswish")),          # r32
    )
    info = [(2, 16), (4, 24), (8, 40), (16, 112), (32, 960)]
    return stem, stages, info


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #

def _specs() -> Dict[str, tuple]:
    return {
        "mobilenetv4_conv_small": _mobilenetv4_conv_small(1.0),
        "mobilenetv4_conv_small_050": _mobilenetv4_conv_small(0.5),
        "tf_efficientnet_lite0": _efficientnet_lite(1.0, 1.0),
        "tf_efficientnet_lite1": _efficientnet_lite(1.0, 1.1),
        "tf_efficientnet_lite2": _efficientnet_lite(1.1, 1.2),
        "tf_efficientnet_lite3": _efficientnet_lite(1.2, 1.4),
        "tf_efficientnet_lite4": _efficientnet_lite(1.4, 1.8),
        "tf_efficientnetv2_b0": _efficientnetv2_b(1.0, 1.0),
        "tf_efficientnetv2_b1": _efficientnetv2_b(1.0, 1.1),
        "tf_efficientnetv2_b2": _efficientnetv2_b(1.1, 1.2),
        "resnet18": _resnet18(),
        "convnextv2_tiny": _convnextv2_tiny(),
        "cs3darknet_focus_s": _cs3darknet_focus(0.5, (1, 2, 2, 1)),
        "cs3darknet_focus_m": _cs3darknet_focus(0.75, (2, 4, 4, 2)),
        "hgnetv2_b0": _hgnetv2_b0(),
        "mobilenetv3_large_100": _mobilenetv3_large(),
    }


BACKBONES = sorted(_specs().keys())


def _spec(name: str):
    name = name.strip()
    if name not in _specs():
        raise KeyError(f"Unknown backbone {name!r}. Available: {BACKBONES}")
    return _specs()[name]


def backbone_feature_info(name: str) -> List[Dict[str, int]]:
    _, _, info = _spec(name)
    return [{"reduction": r, "num_chs": ch} for r, ch in info]


def build_backbone(name: str):
    """Returns (StagedBackbone module, feature_info list)."""
    stem, stages, info = _spec(name)
    return StagedBackbone(stem, stages), [{"reduction": r, "num_chs": ch}
                                          for r, ch in info]
