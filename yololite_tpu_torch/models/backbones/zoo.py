"""Backbone zoo (PyTorch port of `yololite_tpu/models/backbones/zoo.py`).

Same interface as the JAX zoo: `build_backbone(name) -> (module, feature_info)`,
the module returns one NCHW feature map per stage, and feature_info is a list
of {"num_chs", "reduction"}. Only the MobileNetV4-Conv-S specs are ported so
far; the other backbones of the JAX zoo raise `KeyError` naming what is.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from torch import nn

from yololite_tpu_torch.models.layers import UIB, ConvBNAct, make_divisible

BlockSpec = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _b(kind: str, **kwargs) -> BlockSpec:
    return (kind, tuple(sorted(kwargs.items())))


_BLOCK_CLASSES = {"conv": (ConvBNAct, "ConvBNAct"), "uib": (UIB, "UIB")}


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
            cls, cname = _BLOCK_CLASSES[kind]
            kw = dict(kw)
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
        # r32, ending with the wide 1x1 "final conv" (960*width channels)
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


def _specs() -> Dict[str, tuple]:
    return {
        "mobilenetv4_conv_small": _mobilenetv4_conv_small(1.0),
        "mobilenetv4_conv_small_050": _mobilenetv4_conv_small(0.5),
    }


BACKBONES = sorted(_specs().keys())


def _spec(name: str):
    name = name.strip()
    if name not in _specs():
        raise KeyError(f"Backbone {name!r} is not ported yet. Ported: {BACKBONES}")
    return _specs()[name]


def backbone_feature_info(name: str) -> List[Dict[str, int]]:
    _, _, info = _spec(name)
    return [{"reduction": r, "num_chs": ch} for r, ch in info]


def build_backbone(name: str):
    """Returns (StagedBackbone module, feature_info list)."""
    stem, stages, info = _spec(name)
    return StagedBackbone(stem, stages), [{"reduction": r, "num_chs": ch}
                                          for r, ch in info]
