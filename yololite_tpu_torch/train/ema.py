"""Exponential moving average of the model's variables (port of
`train/ema.py`).

  decay ramp  d = decay * (1 - exp(-updates / warmup_limit)), with `updates`
              the post-increment update counter;
  warmup_limit = max(100, total_updates // 5);
  float tensors: ema = ema * d + value * (1 - d) (parameters and BatchNorm
  running statistics alike); other tensors are copied.
The EMA weights are what get validated and checkpointed.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def ema_warmup_limit(total_updates: int) -> int:
    return max(100, int(total_updates) // 5)


def ema_decay_at(updates: int, decay: float, warmup_limit: int) -> float:
    """The ramped decay for the post-increment counter `updates`, computed in
    double and rounded to float32 (JAX computes it in float32, where
    `1 - exp(-u)` cancels: the two differ by a few float32 ulps of `exp`
    over u, ~1e-6 relative at the first update)."""
    return float(np.float32(decay * (1.0 - math.exp(-updates / float(warmup_limit)))))


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], new: Sequence[torch.Tensor],
               updates: int, decay: float, warmup_limit: int) -> None:
    """One EMA step, in place on `ema`."""
    d = ema_decay_at(updates, decay, warmup_limit)
    floats = [(e, v) for e, v in zip(ema, new) if e.is_floating_point()]
    for e, v in zip(ema, new):
        if not e.is_floating_point():
            e.copy_(v)
    if floats:
        es, vs = [e for e, _ in floats], [v.to(e.dtype) for e, v in floats]
        torch._foreach_mul_(es, d)
        torch._foreach_add_(es, vs, alpha=float(np.float32(1.0) - np.float32(d)))
