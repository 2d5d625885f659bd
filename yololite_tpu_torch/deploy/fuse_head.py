"""Fuse the decoupled head's 1x1 convs into one conv (deploy-time, exact).

Port of `deploy/fuse_head.py`: a 1x1 conv is a matmul over channels, so
concatenating box|obj|cls(|mcoef) along the output channels gives one conv
whose output is the channel-concat of the originals, and the trunk activation
is read once instead of three times. Checkpoints keep the split layout; the
Predictor fuses at load time and builds the model with `fused_head=True`.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

_PARTS = ("box", "obj", "cls", "mcoef")  # concat order == DetectHead.fused


def fuse_head_params(state_dict: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], bool]:
    """Return (state_dict', ok) with every head{2..6} fused into
    `head<n>.fused_out`; ok is False when no split head is present."""
    heads = sorted({m.group(1) for k in state_dict
                    if (m := re.match(r"^(head\d+)\.box\.weight$", k))})
    if not heads:
        return state_dict, False
    out = dict(state_dict)
    for h in heads:
        parts = [p for p in _PARTS if f"{h}.{p}.weight" in state_dict]
        for leaf in ("weight", "bias"):
            out[f"{h}.fused_out.{leaf}"] = torch.cat(
                [state_dict[f"{h}.{p}.{leaf}"] for p in parts], dim=0)
            for p in parts:
                del out[f"{h}.{p}.{leaf}"]
    return out, True
