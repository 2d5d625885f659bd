"""Import torch/timm pretrained backbone weights into a zoo checkpoint (port
of `tools/import_backbone.py`).

Save the timm weights on any machine with torch and timm

    import timm, torch
    m = timm.create_model("mobilenetv4_conv_small_050", pretrained=True)
    torch.save(m.state_dict(), "mnv4_small_050.pth")

then

    python -m yololite_tpu_torch.tools.import_backbone \
        --backbone mobilenetv4_conv_small_050 --torch_state mnv4_small_050.pth \
        --out weights/mnv4_050_backbone.ckpt

and train with `model.pretrained_backbone: weights/mnv4_050_backbone.ckpt`
(or `--pretrained_backbone` on the train tool). The checkpoint is in flax's
layout, so the JAX package reads it too. Execution-order slot matching with
strict shape checks (`models/backbones/torch_import.py`). Host work with
numpy: no device is touched. timm's `tf_*` variants pad stride-2 convs
asymmetrically (SAME) where the zoo pads symmetrically: the imported weights
are an equivalent initialization that fine-tuning absorbs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from yololite_tpu_torch.convert import to_flax
from yololite_tpu_torch.models.backbones.torch_import import convert_backbone
from yololite_tpu_torch.models.backbones.zoo import build_backbone
from yololite_tpu_torch.models.detector import init_weights
from yololite_tpu_torch.train.checkpoint import save_checkpoint


def load_torch_state(path: str):
    """A state_dict from a `.pth`/`.pt` (`torch.save`, unwrapping "state_dict"
    and "model") or an `.npz`."""
    if path.endswith(".npz"):
        z = np.load(path)
        return {k: z[k] for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "items"):
        obj = obj["model"]
    return obj


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", required=True)
    ap.add_argument("--torch_state", required=True,
                    help=".pth/.pt (torch.save of a timm state_dict) or .npz")
    ap.add_argument("--out", required=True, help="output backbone .ckpt")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    sd = load_torch_state(args.torch_state)
    # fresh (seeded) weights for the slots timm has no tensor for
    params, batch_stats = to_flax(init_weights(build_backbone(args.backbone)[0], 0))
    p, bs, report = convert_backbone(args.backbone, sd, params, batch_stats)
    meta = {"backbone": args.backbone, "source": "torch_import",
            "torch_state": os.path.basename(args.torch_state),
            "assigned": report["assigned"],
            "skipped_flax": report["skipped_flax"],
            "leftover_torch": report["leftover_torch"],
            "folded_scales": report["folded_scales"]}
    save_checkpoint(args.out, p, bs, meta)
    print(f"assigned {report['assigned']} slots"
          + (f", kept fresh: {report['skipped_flax']}" if report["skipped_flax"] else "")
          + (f", torch leftovers (head): {report['leftover_torch']}"
             if report["leftover_torch"] else ""))
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
