"""Weight bridge between the JAX package's flax variables and this package's
state_dict, both ways.

Submodules of the port carry their flax names, so the bridge is a path map:
`a/b/Conv_0/kernel` -> `a.b.Conv_0.weight`, plus the layout transforms

  conv kernel HWIO (kh,kw,I,O) -> OIHW; a depthwise kernel (kh,kw,1,C)
      becomes (C,1,kh,kw) by the same (3,2,0,1) permutation;
  Dense kernel (in, out) -> Linear weight (out, in);
  conv and Dense bias -> bias;
  BatchNorm scale/bias (params) -> weight/bias,
  BatchNorm mean/var (batch_stats) -> running_mean/running_var;
  LayerNorm scale/bias -> weight/bias; GRN gamma/beta keep their names.
Any other leaf raises.

Inputs are nested dicts of numpy arrays, as `train/checkpoint.load_checkpoint`
returns them (this package's reader or flax's). `to_flax` is the inverse, and
`to_flax_params` maps any per-parameter tensors (Adam moments, an SGD trace)
into flax's params layout, for optimizer state in a checkpoint.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# leaf renames of the normalization layers, by flax module prefix
_NORM_NAMES = {
    "BatchNorm_": {"scale": "weight", "bias": "bias", "mean": "running_mean",
                   "var": "running_var"},
    "LayerNorm_": {"scale": "weight", "bias": "bias"},
    "GRN_": {"gamma": "gamma", "beta": "beta"},
}


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert_leaf(path, value) -> tuple:
    *parents, leaf = path
    arr = np.asarray(value)
    norm = next((names for prefix, names in _NORM_NAMES.items()
                 if parents and parents[-1].startswith(prefix)), None)
    if norm is not None:
        if leaf not in norm:
            raise KeyError(f"unexpected normalization leaf {'/'.join(path)}")
        name = norm[leaf]
    elif leaf == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"{'/'.join(path)}: expected a 4-D conv or 2-D Dense "
                             f"kernel, got shape {arr.shape}")
        name = "weight"
    elif leaf == "bias":
        name = "bias"
    else:
        raise KeyError(f"unexpected parameter leaf {'/'.join(path)}")
    key = ".".join(parents + [name])
    return key, torch.tensor(np.ascontiguousarray(arr, dtype=np.float32))


def from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax `params` and `batch_stats` -> a flat torch state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _walk(tree):
            key, t = _convert_leaf(path, value)
            if key in sd:
                raise KeyError(f"duplicate key {key}")
            sd[key] = t
    return sd


def load_flax(module: nn.Module, params: Mapping, batch_stats: Mapping) -> nn.Module:
    """Load flax variables into `module`; raises on any missing or leftover
    key, or a shape that differs."""
    sd = from_flax(params, batch_stats)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"flax -> torch key mismatch: missing {missing[:8]} "
                       f"({len(missing)}), leftover {extra[:8]} ({len(extra)})")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != "
                             f"model shape {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
    return module


def _flax_leaf_names(module: nn.Module) -> Dict[str, Tuple[str, str, str]]:
    """torch state_dict key -> (flax collection, flax leaf, layout) for every
    parameter and buffer of `module`; layout is "conv", "dense" or "same"."""
    from yololite_tpu_torch.models.layers import GRN, BatchNorm
    out = {}
    for prefix, mod in module.named_modules():
        def add(name, coll, leaf, layout="same"):
            out[f"{prefix}.{name}" if prefix else name] = (coll, leaf, layout)
        if isinstance(mod, nn.Conv2d):
            add("weight", "params", "kernel", "conv")
            if mod.bias is not None:
                add("bias", "params", "bias")
        elif isinstance(mod, nn.Linear):
            add("weight", "params", "kernel", "dense")
            add("bias", "params", "bias")
        elif isinstance(mod, BatchNorm):
            add("weight", "params", "scale")
            add("bias", "params", "bias")
            add("running_mean", "batch_stats", "mean")
            add("running_var", "batch_stats", "var")
        elif isinstance(mod, nn.LayerNorm):
            add("weight", "params", "scale")
            add("bias", "params", "bias")
        elif isinstance(mod, GRN):
            add("gamma", "params", "gamma")
            add("beta", "params", "beta")
    return out


def _to_flax_array(t: torch.Tensor, layout: str) -> np.ndarray:
    arr = t.detach().to("cpu", torch.float32).numpy()
    if layout == "conv":
        arr = arr.transpose(2, 3, 1, 0)
    elif layout == "dense":
        arr = arr.T
    return np.ascontiguousarray(arr)


def _nest(tree: dict, key: str, leaf: str, value) -> None:
    *parents, _ = key.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def to_flax(module: nn.Module, tensors: Optional[Mapping[str, torch.Tensor]] = None):
    """`module`'s state_dict (or `tensors`, keyed like it) -> nested flax
    (params, batch_stats) of numpy float32 arrays; the inverse of
    `from_flax`. Raises on a key the module has no flax name for."""
    names = _flax_leaf_names(module)
    tensors = module.state_dict() if tensors is None else tensors
    trees = {"params": {}, "batch_stats": {}}
    for key, t in tensors.items():
        if key not in names:
            raise KeyError(f"no flax name for {key}")
        coll, leaf, layout = names[key]
        _nest(trees[coll], key, leaf, _to_flax_array(t, layout))
    return trees["params"], trees["batch_stats"]


def to_flax_params(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> dict:
    """Per-parameter tensors keyed by `module.named_parameters()` names (Adam
    moments, an SGD trace) -> a nested tree in flax's params layout."""
    params, stats = to_flax(module, tensors)
    if stats:
        raise KeyError("to_flax_params got buffers, not parameters")
    return params


def from_flax_params(module: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of `to_flax_params`: a tree in flax's params layout -> a
    flat dict keyed by `module.named_parameters()` names (exact key set)."""
    flat = {}
    for path, value in _walk(tree):
        key, t = _convert_leaf(path, value)
        flat[key] = t
    want = {k for k, _ in module.named_parameters()}
    if set(flat) != want:
        raise KeyError(f"params tree keys differ from the module's: missing "
                       f"{sorted(want - set(flat))[:8]}, leftover {sorted(set(flat) - want)[:8]}")
    return flat
