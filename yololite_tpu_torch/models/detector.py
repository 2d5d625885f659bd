"""YOLOLiteMS detector: backbone -> top-down FPN -> decoupled anchor-free heads.

PyTorch port of `yololite_tpu/models/detector.py`. Inside the model tensors are
NCHW (channels_last in memory on the card); the per-level outputs keep the JAX
layout [B, A, S, S, 5+C] so decode and NMS see the same tensors in both
packages. Submodule names are the flax names (`backbone`, `lateral5`,
`smooth3`, `head4`, `p6_down`, ...), so checkpoints map by a plain rename.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from yololite_tpu_torch.models.backbones import backbone_feature_info, build_backbone
from yololite_tpu_torch.models.layers import (
    GRN, BatchNorm, ConvBNAct, ConvBlock, DWConvBlock, conv2d, upsample_nearest_to,
)


def pick_out_indices(feature_info: List[Dict[str, int]], take: int = 3):
    """Last `take` stages: (indices, reductions, channels)."""
    n = len(feature_info)
    out_idx = list(range(n - take, n))
    reductions = [feature_info[i]["reduction"] for i in out_idx]
    chs = [feature_info[i]["num_chs"] for i in out_idx]
    return out_idx, reductions, chs


class DetectHead(nn.Module):
    """Decoupled head: DW trunk + 1x1 box/obj/cls, or one `fused_out` 1x1 conv
    whose output channels are box|obj|cls (deploy/fuse_head.py).

    With num_prototypes K > 0 the head also emits tanh mask coefficients
    (`mcoef`, after cls in the fused order), and the per-level layout
    becomes [B, A, S, S, 5 + C + K]."""

    def __init__(self, num_anchors: int, num_classes: int, fpn_channels: int,
                 head_depth: int = 1, p_obj: float = 0.01, fused: bool = False,
                 num_prototypes: int = 0):
        super().__init__()
        self.A, self.C, self.K = num_anchors, num_classes, num_prototypes
        self.head_depth, self.fused = head_depth, fused
        for i in range(head_depth):
            self.add_module(f"DWConvBlock_{i}",
                            DWConvBlock(fpn_channels, fpn_channels, n=1))
        A, C, K = num_anchors, num_classes, num_prototypes
        # bias init values of the split heads (reference make_head; mcoef 0)
        self.bias_init = {"box": 0.0,
                          "obj": -math.log((1.0 - p_obj) / p_obj),
                          "cls": (-math.log(C)) if C > 1 else 0.0}
        if fused:
            self.fused_out = conv2d(fpn_channels, A * (5 + C + K), 1)
        else:
            self.box = conv2d(fpn_channels, A * 4, 1)
            self.obj = conv2d(fpn_channels, A * 1, 1)
            self.cls = conv2d(fpn_channels, A * C, 1)
            if K > 0:
                self.mcoef = conv2d(fpn_channels, A * K, 1)

    def forward(self, p):
        for i in range(self.head_depth):
            p = getattr(self, f"DWConvBlock_{i}")(p)
        A, C, K = self.A, self.C, self.K
        if self.fused:
            out = self.fused_out(p).permute(0, 2, 3, 1)              # [B,S,S,tot]
            box, obj = out[..., :A * 4], out[..., A * 4:A * 5]
            cls, coef = out[..., A * 5:A * (5 + C)], out[..., A * (5 + C):]
        else:
            box, obj, cls = (m(p).permute(0, 2, 3, 1)
                             for m in (self.box, self.obj, self.cls))
            coef = self.mcoef(p).permute(0, 2, 3, 1) if K > 0 else None
        B, S1, S2, _ = box.shape
        parts = [box.reshape(B, S1, S2, A, 4), obj.reshape(B, S1, S2, A, 1),
                 cls.reshape(B, S1, S2, A, C)]
        if K > 0:
            parts.append(torch.tanh(coef.reshape(B, S1, S2, A, K)))
        out = torch.cat(parts, dim=-1)                              # [B,S,S,A,E]
        return out.permute(0, 3, 1, 2, 4)                           # [B,A,S,S,E]


class ProtoNet(nn.Module):
    """Mask prototypes from P3: ConvBNAct -> nearest x2 -> ConvBNAct -> 1x1,
    [B, C, S3, S3] -> [B, K, 2 S3, 2 S3] (stride 4)."""

    def __init__(self, fpn_channels: int, num_prototypes: int = 32):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(fpn_channels, fpn_channels, 3, 1, act="silu")
        self.ConvBNAct_1 = ConvBNAct(fpn_channels, fpn_channels, 3, 1, act="silu")
        self.proto_out = conv2d(fpn_channels, num_prototypes, 1)

    def forward(self, p3):
        h = self.ConvBNAct_0(p3)
        h = upsample_nearest_to(h, (p3.shape[2] * 2, p3.shape[3] * 2))
        return self.proto_out(self.ConvBNAct_1(h))


class YOLOLiteMS(nn.Module):
    """Multi-scale anchor-free detector (both reference variants)."""

    def __init__(self, backbone: str = "resnet18", num_classes: int = 3,
                 fpn_channels: int = 128,
                 num_anchors_per_level: Tuple[int, ...] = (1, 1, 1, 1),
                 depth_multiple: float = 1.0, width_multiple: float = 1.0,
                 head_depth: int = 1, use_p6: bool = False, use_p2: bool = False,
                 cpu_variant: bool = False, with_masks: bool = False,
                 num_prototypes: int = 32, fused_head: bool = False):
        super().__init__()
        self.backbone_name = backbone
        self.num_classes = num_classes
        self.num_anchors_per_level = tuple(num_anchors_per_level)
        self.use_p6, self.use_p2 = use_p6, use_p2
        self.cpu_variant = cpu_variant
        self.fused_head = fused_head
        self.with_masks = with_masks
        self.num_prototypes = num_prototypes
        self.scaled_fpn_channels = int(fpn_channels * width_multiple)
        self.smooth_depth = max(1, round(2 * depth_multiple))
        self.config = dict(backbone=backbone, num_classes=num_classes,
                           fpn_channels=fpn_channels,
                           num_anchors_per_level=self.num_anchors_per_level,
                           depth_multiple=depth_multiple,
                           width_multiple=width_multiple, head_depth=head_depth,
                           use_p6=use_p6, use_p2=use_p2, cpu_variant=cpu_variant,
                           with_masks=with_masks, num_prototypes=num_prototypes,
                           fused_head=fused_head)

        self.backbone, info = build_backbone(backbone)
        self.out_idx, _, in_chs = pick_out_indices(info, 4 if use_p2 else 3)
        ch = self.scaled_fpn_channels
        levels = (["2"] if use_p2 else []) + ["3", "4", "5"]
        for lv, c_in in zip(levels, in_chs):
            self.add_module(f"lateral{lv}", conv2d(c_in, ch, 1))
            self.add_module(f"smooth{lv}", self._smooth())
        anchors = self.get_num_anchors_per_level()
        K = num_prototypes if with_masks else 0
        for li, lv in enumerate(levels + (["6"] if use_p6 else [])):
            self.add_module(f"head{lv}", DetectHead(anchors[li], num_classes, ch,
                                                    head_depth, fused=fused_head,
                                                    num_prototypes=K))
        # Registered even without P6 so checkpoints round-trip (the reference
        # builds them unconditionally); computed only when use_p6 is set.
        self.p6_down = ConvBNAct(ch, ch, 3, 2, act="relu" if cpu_variant else "silu")
        self.smooth6 = self._smooth()
        if with_masks:
            self.protonet = ProtoNet(ch, num_prototypes)

    # ---- static self-description ----------------------------------------- #
    @property
    def feature_info(self):
        return backbone_feature_info(self.backbone_name)

    @property
    def fpn_strides(self) -> List[int]:
        _, reductions, _ = pick_out_indices(self.feature_info,
                                            4 if self.use_p2 else 3)
        return list(reductions) + ([reductions[-1] * 2] if self.use_p6 else [])

    @property
    def level_names(self) -> List[str]:
        return ((["p2"] if self.use_p2 else []) + ["p3", "p4", "p5"]
                + (["p6"] if self.use_p6 else []))

    def get_strides(self) -> List[int]:
        return list(self.fpn_strides)

    def get_num_anchors_per_level(self) -> Tuple[int, ...]:
        ns = self.num_anchors_per_level
        if len(ns) >= 3:
            a3, a4, a5 = int(ns[0]), int(ns[1]), int(ns[2])
        else:
            a3 = a4 = a5 = int(ns[0]) if len(ns) else 1
        amap = {"p2": a3, "p3": a3, "p4": a4, "p5": a5, "p6": a5}
        return tuple(amap[n] for n in self.level_names)

    def _smooth(self):
        ch, d = self.scaled_fpn_channels, self.smooth_depth
        if self.cpu_variant:
            return DWConvBlock(ch, ch, n=d)
        return ConvBlock(ch, ch, n=d, act="silu")

    # ---------------------------------------------------------------------- #
    def forward(self, x):
        """x: NCHW image tensor -> list of per-level [B,A,S,S,5+C(+K)] maps;
        with masks, (that list, prototypes [B, 2 S3, 2 S3, K] NHWC as in
        JAX)."""
        feats = self.backbone(x)
        feats = [feats[i] for i in self.out_idx]
        if self.use_p2:
            c2, c3, c4, c5 = feats
        else:
            c3, c4, c5 = feats

        def up_add(a, b):
            return upsample_nearest_to(a, (b.shape[2], b.shape[3])) + b

        p5 = self.smooth5(self.lateral5(c5))
        p4 = self.smooth4(up_add(p5, self.lateral4(c4)))
        p3 = self.smooth3(up_add(p4, self.lateral3(c3)))
        outs = []
        if self.use_p2:
            p2 = self.smooth2(up_add(p3, self.lateral2(c2)))
            outs.append(self.head2(p2))
        outs += [self.head3(p3), self.head4(p4), self.head5(p5)]
        if self.use_p6:
            outs.append(self.head6(self.smooth6(self.p6_down(p5))))
        elif self.training:
            # JAX computes p6_down/smooth6 and discards them without use_p6,
            # so in training their BatchNorm statistics still move
            self.smooth6(self.p6_down(p5))
        if self.with_masks:
            return outs, self.protonet(p3).permute(0, 2, 3, 1)
        return outs


def build_model_from_config(cfg: Dict[str, Any], **overrides) -> YOLOLiteMS:
    """Construct the detector from a merged config dict (model + training)."""
    m = cfg.get("model", {})
    tr = cfg.get("training", {})
    arch = str(m.get("arch", "YOLOLiteMS"))
    napl = m.get("num_anchors_per_level", 1)
    if isinstance(napl, int):
        napl = (napl,) * 4
    with_masks = bool(m.get("with_masks", False)) or \
        str(m.get("task", tr.get("task", "detect"))).lower() in ("segment", "seg")
    kw = dict(
        backbone=str(m.get("backbone", "resnet18")).strip(),
        num_classes=int(m.get("num_classes", 3)),
        fpn_channels=int(m.get("fpn_channels", 128)),
        num_anchors_per_level=tuple(int(a) for a in napl),
        depth_multiple=float(m.get("depth_multiple", 1.0)),
        width_multiple=float(m.get("width_multiple", 1.0)),
        head_depth=int(m.get("head_depth", 1)),
        use_p6=bool(tr.get("use_p6", m.get("use_p6", False))),
        use_p2=bool(tr.get("use_p2", m.get("use_p2", False))),
        cpu_variant=arch.upper().endswith("_CPU"),
        with_masks=with_masks,
        num_prototypes=int(m.get("num_prototypes", 32)),
    )
    kw.update(overrides)
    return YOLOLiteMS(**kw)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in the JAX package's scheme: conv and Linear weights
    U(+-1/sqrt(fan_in)) from the generator (torch's default bound), biases 0
    except the head obj/cls biases, BatchNorm and LayerNorm identity, GRN
    gamma/beta 0 (flax's init). Nothing is drawn from torch's global RNG.
    Weights differ from `init_model`'s for the same seed."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            mod.weight.copy_(torch.rand(mod.weight.shape, generator=gen) * 2 * bound
                             - bound)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, GRN):
            mod.gamma.zero_()
            mod.beta.zero_()
    for mod in model.modules():
        if isinstance(mod, DetectHead) and not mod.fused:
            for part in ("box", "obj", "cls"):
                getattr(mod, part).bias.fill_(mod.bias_init[part])
    return model


def count_params(model: nn.Module) -> int:
    """Trainable parameter count (BatchNorm running stats excluded, as in JAX)."""
    return int(sum(p.numel() for p in model.parameters()))
