"""Import torch/timm backbone weights into a zoo backbone's flax-layout tree
(port of `yololite_tpu/models/backbones/torch_import.py`).

Given a torch `state_dict` saved from the matching timm model
(`torch.save(timm.create_model(name, pretrained=True).state_dict(), path)`
on any machine with timm), `convert_backbone` maps its tensors onto the
backbone's parameters in flax's layout, which the checkpoint writer saves
and both packages read (`train/loop.py`'s `pretrained_backbone`).

Execution-order slot matching, not per-architecture key tables. Both sides
list their parameters in execution order:

  * torch: `state_dict` insertion order (module registration order, which for
    the supported timm families is execution order);
  * the zoo: a slot plan simulated from the spec tables of
    `models/backbones/zoo.py` that build the `StagedBackbone`, whose blocks
    carry flax's `ClassName_i` names (one counter per class and parent).

Slots are typed (conv / bn / linear / ln / scale) and every assignment is
shape-checked after the torch -> flax layout transform (conv OIHW -> HWIO,
depthwise (C,1,kh,kw) -> (kh,kw,1,C), linear (O,I) -> (I,O)). A mismatch
raises naming both sides.

Supported: the architectures whose block structure matches timm's
registration order one to one (`SUPPORTED_IMPORTS`); other zoo names raise
`UnsupportedBackbone`. resnet18: the zoo's stem replaces timm's maxpool by
a strided 3x3 conv with no torch counterpart; that conv and its BatchNorm
keep their fresh initialization and are listed in the report's
`skipped_flax`. Host work with numpy; no device is touched.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["UnsupportedBackbone", "plan_flax_slots", "group_torch_slots",
           "convert_backbone", "SUPPORTED_IMPORTS"]

SUPPORTED_IMPORTS = (
    "mobilenetv4_conv_small", "mobilenetv4_conv_small_050",
    "tf_efficientnet_lite0", "tf_efficientnet_lite1", "tf_efficientnet_lite2",
    "tf_efficientnet_lite3", "tf_efficientnet_lite4",
    "tf_efficientnetv2_b0", "tf_efficientnetv2_b1", "tf_efficientnetv2_b2",
    "resnet18",
)

# slots with no torch counterpart (kept at their fresh init): resnet18's
# second stem conv, which replaces timm's parameterless maxpool
_SKIP_FLAX: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "resnet18": (("ConvBNAct_1",),),
}


class UnsupportedBackbone(ValueError):
    pass


@dataclass
class Slot:
    kind: str                      # conv | bn | linear | ln | scale | other
    path: Tuple[str, ...] = ()     # module path in the zoo (its side only)
    has_bias: bool = False         # conv/linear bias present
    tensors: Dict[str, np.ndarray] = field(default_factory=dict)  # torch side
    torch_prefix: str = ""


# --------------------------------------------------------------------------- #
# The zoo's side: the blocks' flax names in execution order.
# --------------------------------------------------------------------------- #

class _Namer:
    """flax's auto-naming: ClassName_{per-class call index}."""

    def __init__(self):
        self.counts: Dict[str, int] = {}

    def next(self, cls: str) -> str:
        i = self.counts.get(cls, 0)
        self.counts[cls] = i + 1
        return f"{cls}_{i}"


def _convbnact(namer: _Namer, base: Tuple[str, ...]) -> List[Slot]:
    name = namer.next("ConvBNAct")
    sub = _Namer()
    return [Slot("conv", base + (name, sub.next("Conv"))),
            Slot("bn", base + (name, sub.next("BatchNorm")))]


def _expand_block(kind: str, kw: Dict[str, Any], c_in: int,
                  namer: _Namer, base: Tuple[str, ...]) -> Tuple[List[Slot], int]:
    """The ordered slots of one zoo block; returns (slots, c_out)."""
    out: List[Slot] = []
    if kind == "conv":
        return _convbnact(namer, base), int(kw["features"])

    if kind == "uib":
        name = namer.next("UIB")
        sub = _Namer()
        if int(kw.get("dw_start", 0)) > 0:
            out += _convbnact(sub, base + (name,))
        out += _convbnact(sub, base + (name,))          # 1x1 expand
        if int(kw.get("dw_mid", 3)) > 0:
            out += _convbnact(sub, base + (name,))      # dw mid
        out += _convbnact(sub, base + (name,))          # 1x1 project
        return out, int(kw["features"])

    if kind == "mb":
        name = namer.next("MBConv")
        sub = _Namer()
        if float(kw.get("expand", 6.0)) != 1.0:
            out += _convbnact(sub, base + (name,))      # 1x1 expand
        out += _convbnact(sub, base + (name,))          # dw kxk
        if float(kw.get("se_ratio", 0.0)) > 0:
            se = sub.next("SqueezeExcite")
            se_sub = _Namer()
            out += [Slot("conv", base + (name, se, se_sub.next("Conv")), has_bias=True),
                    Slot("conv", base + (name, se, se_sub.next("Conv")), has_bias=True)]
        out += _convbnact(sub, base + (name,))          # 1x1 project
        return out, int(kw["features"])

    if kind == "fused":
        name = namer.next("FusedMBConv")
        sub = _Namer()
        out += _convbnact(sub, base + (name,))
        if float(kw.get("expand", 4.0)) != 1.0:
            out += _convbnact(sub, base + (name,))
        return out, int(kw["features"])

    if kind == "basic":
        name = namer.next("BasicBlock")
        sub = _Namer()
        out += _convbnact(sub, base + (name,))
        out += _convbnact(sub, base + (name,))
        if int(kw.get("stride", 1)) != 1 or c_in != int(kw["features"]):
            out += _convbnact(sub, base + (name,))      # downsample
        return out, int(kw["features"])

    if kind == "focus":
        name = namer.next("Focus")
        return _convbnact(_Namer(), base + (name,)), int(kw["features"])

    raise UnsupportedBackbone(f"block kind {kind!r} has no torch-import slot mapping")


def plan_flax_slots(name: str) -> List[Slot]:
    """The zoo backbone's typed slots in execution order."""
    from yololite_tpu_torch.models.backbones.zoo import _specs
    if name not in SUPPORTED_IMPORTS:
        raise UnsupportedBackbone(f"torch import not supported for {name!r}; supported: "
                                  f"{SUPPORTED_IMPORTS}")
    stem, stages, _ = _specs()[name]
    namer = _Namer()
    slots: List[Slot] = []
    c = 3
    for kind, kw in list(stem) + [b for stage in stages for b in stage]:
        s, c = _expand_block(kind, dict(kw), c, namer, ())
        slots += s
    return slots


# --------------------------------------------------------------------------- #
# The torch side: an ordered state_dict grouped into typed slots.
# --------------------------------------------------------------------------- #

def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def group_torch_slots(state_dict) -> List[Slot]:
    """Group state_dict items (in insertion order) into typed slots."""
    items = [(k, _np(v)) for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")]
    slots: List[Slot] = []
    i = 0
    while i < len(items):
        k, v = items[i]
        prefix = k.rsplit(".", 1)[0] if "." in k else ""
        leaf = k.rsplit(".", 1)[-1]
        rest = dict((kk.rsplit(".", 1)[-1], vv) for kk, vv in items[i + 1:i + 4]
                    if kk.rsplit(".", 1)[0] == prefix)
        if leaf == "weight" and v.ndim in (4, 2):
            s = Slot("conv" if v.ndim == 4 else "linear", tensors={"weight": v},
                     torch_prefix=prefix, has_bias="bias" in rest)
            if s.has_bias:
                s.tensors["bias"] = rest["bias"]
                i += 1
            slots.append(s)
            i += 1
        elif leaf == "weight" and v.ndim == 1:
            if "running_mean" in rest:   # BatchNorm
                slots.append(Slot("bn", tensors={
                    "weight": v, "bias": rest["bias"],
                    "running_mean": rest["running_mean"],
                    "running_var": rest["running_var"]}, torch_prefix=prefix))
                i += 4
            elif "bias" in rest:         # LayerNorm / affine pair
                slots.append(Slot("ln", tensors={"weight": v, "bias": rest["bias"]},
                                  torch_prefix=prefix))
                i += 2
            else:                        # a lone per-channel scale (layer_scale)
                slots.append(Slot("scale", tensors={"weight": v}, torch_prefix=prefix))
                i += 1
        elif leaf == "gamma":
            slots.append(Slot("scale", tensors={"weight": v.reshape(-1)},
                              torch_prefix=prefix))
            i += 1
        else:
            # an unknown standalone tensor: kept opaque; matching stops on it
            slots.append(Slot("other", tensors={leaf: v}, torch_prefix=prefix))
            i += 1
    return slots


# --------------------------------------------------------------------------- #
# Conversion
# --------------------------------------------------------------------------- #

def _node(tree: Dict, path: Sequence[str], leaf: str) -> Dict:
    node = tree
    for p in path:
        if p not in node:
            raise KeyError(f"flax tree missing {'/'.join(path)}")
        node = node[p]
    if leaf not in node:
        raise KeyError(f"flax tree missing {'/'.join(path)}/{leaf}")
    return node


def _set(tree: Dict, path: Sequence[str], leaf: str, value: np.ndarray) -> None:
    node = _node(tree, path, leaf)
    old = np.asarray(node[leaf])
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(f"shape mismatch at {'/'.join(path)}/{leaf}: "
                         f"flax {old.shape} vs torch {value.shape}")
    node[leaf] = value.astype(old.dtype)


def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def convert_backbone(name: str, state_dict, params, batch_stats):
    """Map a torch state_dict onto backbone `name`'s flax-layout (params,
    batch_stats) (nested dicts of numpy arrays, e.g. `convert.to_flax` of
    the zoo's module). Returns (params, batch_stats, report) with report =
    {"assigned": int, "skipped_flax": [paths], "leftover_torch": [prefixes],
    "folded_scales": int}."""
    plan = plan_flax_slots(name)
    tslots = group_torch_slots(state_dict)
    skip_prefixes = _SKIP_FLAX.get(name, ())

    p, bs = _copy(params), _copy(batch_stats)
    report = {"assigned": 0, "skipped_flax": [], "leftover_torch": [], "folded_scales": 0}
    ti = 0
    last_bn_path = None
    for slot in plan:
        if any(slot.path[:len(sp)] == sp for sp in skip_prefixes):
            report["skipped_flax"].append("/".join(slot.path))
            continue
        # fold a pending layer_scale into the previous BN's affine:
        # gamma * BN(x) is BN with (gamma * scale, gamma * bias)
        while ti < len(tslots) and tslots[ti].kind == "scale":
            if last_bn_path is None:
                raise ValueError(f"layer_scale at {tslots[ti].torch_prefix} "
                                 f"with no preceding BN to fold into")
            g = tslots[ti].tensors["weight"]
            for leaf in ("scale", "bias"):
                _set(p, last_bn_path, leaf,
                     np.asarray(_node(p, last_bn_path, leaf)[leaf]) * g)
            report["folded_scales"] += 1
            ti += 1
        if ti >= len(tslots):
            raise ValueError(f"torch state_dict exhausted at flax slot "
                             f"{'/'.join(slot.path)} ({slot.kind})")
        t = tslots[ti]
        ti += 1
        if t.kind != slot.kind:
            raise ValueError(f"slot kind mismatch: flax {'/'.join(slot.path)} wants "
                             f"{slot.kind}, torch {t.torch_prefix!r} is {t.kind}")
        if slot.kind == "conv":
            _set(p, slot.path, "kernel", np.transpose(t.tensors["weight"], (2, 3, 1, 0)))
            if slot.has_bias != t.has_bias:
                raise ValueError(f"conv bias mismatch at {'/'.join(slot.path)} "
                                 f"(flax bias={slot.has_bias}, torch bias={t.has_bias} "
                                 f"at {t.torch_prefix!r})")
            if t.has_bias:
                _set(p, slot.path, "bias", t.tensors["bias"])
        elif slot.kind == "bn":
            _set(p, slot.path, "scale", t.tensors["weight"])
            _set(p, slot.path, "bias", t.tensors["bias"])
            _set(bs, slot.path, "mean", t.tensors["running_mean"])
            _set(bs, slot.path, "var", t.tensors["running_var"])
            last_bn_path = slot.path
        else:
            raise ValueError(f"unhandled flax slot kind {slot.kind}")
        report["assigned"] += 1
    report["leftover_torch"] = [t.torch_prefix for t in tslots[ti:]]
    return p, bs, report
