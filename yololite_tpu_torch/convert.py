"""Weight bridge: the JAX package's flax variables -> this package's state_dict.

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
returns them (this package's reader or flax's).
"""

from __future__ import annotations

from typing import Dict, Mapping

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
