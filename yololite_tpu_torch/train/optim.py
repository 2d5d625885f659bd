"""Optimizer with backbone/neck/head LR groups (port of `train/optim.py`).

The JAX package runs an optax chain for the update direction and then scales
each leaf by `-lr[group]`:
    [clip_by_global_norm(c)] -> scale_by_adam (b1 .9, b2 .999, eps 1e-8,
    eps_root 0) -> [add_decayed_weights(wd)] -> x (-lr[group])     adamw
    [clip] -> scale_by_adam -> x (-lr[group])                       adam
    [clip] -> trace(0.9, nesterov) -> [add_decayed_weights] -> ...  sgd
Weight decay reaches every parameter (BatchNorm scale/bias and conv biases
too). Groups: `backbone` is 0, only `head3/4/5` are the head (2), anything
else (the FPN, `head2`, `head6`, `p6_down`) is the neck (1), a reference
quirk kept as is.

This module writes the same chain as plain tensor ops (`torch._foreach_*`),
not `torch.optim` classes: optax clips with `g * clip / norm` only when
`norm >= clip` (`clip_grad_norm_` adds 1e-6 to the norm), and its SGD adds
the weight decay after the momentum (`torch.optim.SGD` puts it inside). A
group at lr 0 (a frozen backbone) still updates its moments, as in JAX.

`state_dict()` gives the state in optax's chain layout (`{"0": {}, "1":
{"count", "mu", "nu"}, "2": {}}` for adamw with clip), keyed by parameter
name; `train/checkpoint` maps the moment trees to flax's params layout.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

GROUP_BACKBONE, GROUP_NECK, GROUP_HEAD = 0, 1, 2
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM = 0.9


def group_of(name: str) -> int:
    """Param group of a parameter by its top-level module name."""
    top = name.split(".")[0]
    if top == "backbone":
        return GROUP_BACKBONE
    if top in ("head3", "head4", "head5"):
        return GROUP_HEAD
    return GROUP_NECK


def group_index_tree(names: Sequence[str]) -> Dict[str, int]:
    """Per-parameter group index (0=backbone, 1=neck, 2=head) by name."""
    return {n: group_of(n) for n in names}


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _f32(x: float) -> float:
    """`x` rounded to float32, as JAX holds the LR vector and constants."""
    return float(np.float32(x))


class GroupedOptimizer:
    """The optax chain of `build_optimizer` plus `apply_updates_grouped`,
    over a fixed list of named parameters (updated in place)."""

    def __init__(self, cfg: Dict[str, Any], named_params: Sequence):
        tr = cfg.get("training", {})
        self.kind = str(tr.get("optimizer", "adamw")).lower()
        self.wd = float(tr.get("weight_decay", 1e-4) or 0.0)
        self.clip = float(tr.get("grad_clip", 0.0) or 0.0)
        self.hyper = {"base_lr": float(tr.get("lr", 1e-3)),
                      "bb_mult": float(tr.get("bb_lr_mult", 1.0) or 1.0),
                      "neck_mult": float(tr.get("neck_lr_mult", 1.0) or 1.0),
                      "head_mult": float(tr.get("head_lr_mult", 1.0) or 1.0)}
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        groups = group_index_tree(self.names)
        self.group_members: List[List[int]] = [
            [i for i, n in enumerate(self.names) if groups[n] == g] for g in range(3)]
        use_wd = self.wd > 0 and self.kind != "adam"
        direction = "trace" if self.kind == "sgd" else "adam"
        self.chain = (["clip"] if self.clip > 0 else []) + [direction] + \
            (["decay"] if use_wd else [])
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format)
                         for p in self.params]
        self.count = 0                                     # optax's int32 count
        if direction == "adam":
            self.mu, self.nu, self.trace = zeros(), zeros(), None
        else:
            self.mu = self.nu = None
            self.trace = zeros()

    # ------------------------------------------------------------------ #
    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: g if norm < clip else g / norm * clip
        (both branches written as a division then a product, so the kept
        branch is exact and nothing waits for the device)."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.clip
        one = torch.ones((), device=norm.device)
        den = torch.where(keep, one, norm)
        num = torch.where(keep, one, torch.full_like(norm, self.clip))
        grads = torch._foreach_div(grads, den)
        torch._foreach_mul_(grads, num)
        return grads

    def _adam(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - B2)
        self.count += 1
        bc1 = float(1.0 - np.power(np.float32(B1), np.float32(self.count), dtype=np.float32))
        bc2 = float(1.0 - np.power(np.float32(B2), np.float32(self.count), dtype=np.float32))
        mu_hat = torch._foreach_div(self.mu, _f32(bc1))
        denom = torch._foreach_div(self.nu, _f32(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        return torch._foreach_div(mu_hat, denom)

    def _sgd(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.trace(0.9, nesterov=True): t = g + 0.9 t; u = g + 0.9 t."""
        torch._foreach_mul_(self.trace, SGD_MOMENTUM)
        torch._foreach_add_(self.trace, grads)
        upd = torch._foreach_mul(self.trace, SGD_MOMENTUM)
        torch._foreach_add_(upd, grads)
        return upd

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr_vec: Sequence[float]) -> None:
        """One update: `grads` in `named_params` order, `lr_vec` the absolute
        [backbone, neck, head] LRs (see `Trainer.lr_vector`)."""
        grads = list(grads)
        if "clip" in self.chain:
            grads = self._clip(grads)
        upd = self._adam(grads) if self.trace is None else self._sgd(grads)
        if "decay" in self.chain:
            torch._foreach_add_(upd, self.params, alpha=self.wd)
        for g, members in enumerate(self.group_members):
            if members:
                torch._foreach_add_([self.params[i] for i in members],
                                    [upd[i] for i in members], alpha=-_f32(lr_vec[g]))

    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """optax's chain state layout; tensors keyed by parameter name."""
        named = lambda ts: dict(zip(self.names, ts))
        out = {}
        for i, name in enumerate(self.chain):
            if name == "adam":
                out[str(i)] = {"count": np.asarray(self.count, np.int32),
                               "mu": named(self.mu), "nu": named(self.nu)}
            elif name == "trace":
                out[str(i)] = {"trace": named(self.trace)}
            else:
                out[str(i)] = {}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore from `state_dict()`'s layout (tensors keyed by name)."""
        if sorted(state) != [str(i) for i in range(len(self.chain))]:
            raise KeyError(f"optimizer state has entries {sorted(state)}, the chain "
                           f"{self.chain} needs {len(self.chain)}")
        for i, name in enumerate(self.chain):
            entry = state[str(i)]
            if name == "adam":
                self.count = int(np.asarray(entry["count"]))
                for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
                    for t, n in zip(dst, self.names):
                        t.copy_(_tensor(entry[key][n]))
            elif name == "trace":
                for t, n in zip(self.trace, self.names):
                    t.copy_(_tensor(entry["trace"][n]))
