"""Model info (port of `tools/model_info.py`): parameters, FLOPs/MACs and
strides per model config.

    python -m yololite_tpu_torch.tools.model_info --model configs/models/edge_n.yaml \
        [--img_size 640] [--num_classes 3] [--device cuda]
    python -m yololite_tpu_torch.tools.model_info --all     # configs/models/*.yaml

Parameters are `models/detector.count_params` (BatchNorm statistics
excluded), equal to the JAX package's count. FLOPs are counted by
`torch.utils.flop_counter.FlopCounterMode` over one eval forward at batch 1
on `device`: 2 x the multiply-adds of every convolution and matmul, each
kernel tap counted, those over the zero padding too. GMACs = GFLOPs / 2, as
JAX prints them.

JAX's figure is XLA's `cost_analysis` of the lowered eval forward, which
counts otherwise in three ways (held per config in
tests/test_torch_port_model_info.py):
  - XLA counts a convolution's taps over real input only, not those over
    the padding: the port counts more, most where maps are small next to
    their kernels (at 128 px, 1.9% of edge_n's count, 8.0% of yololite_m's);
  - XLA counts the discarded P6 branch (`p6_down` and `smooth6`, built and
    lowered without `use_p6`, whose output nothing reads); the port's eval
    forward does not run it;
  - XLA counts elementwise work and reductions (BatchNorm, activations,
    adds, biases, SE means, upsampling's broadcasts) at one FLOP an element
    and op; the port counts none (0.1-1.3% of XLA's figure at 128 px).
With the padded taps taken out and the P6 branch's convolutions added,
the port's count equals the sum of XLA's own counts of each convolution.
So the port's figure lies above XLA's where padding dominates (yololite_m
+7.8% at 128 px) and below where elementwise work does (edge_n -0.5%).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from yololite_tpu_torch.config.config import REPO_ROOT, read_yaml
from yololite_tpu_torch.models.detector import (build_model_from_config, count_params,
                                                init_weights)


def analyze(model_yaml: str, img_size: int = 640, num_classes: int = 3,
            device: str = "cuda") -> Dict[str, Any]:
    cfg = read_yaml(model_yaml)
    cfg.setdefault("model", {})["num_classes"] = num_classes
    cfg.setdefault("training", {})["img_size"] = img_size
    model = init_weights(build_model_from_config(cfg), 0).to(device).eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(torch.zeros(1, 3, img_size, img_size, device=device))
    flops = float(counter.get_total_flops())
    return {
        "model": os.path.splitext(os.path.basename(model_yaml))[0],
        "backbone": cfg["model"].get("backbone", "?"),
        "params_M": count_params(model) / 1e6,
        "flops_G": flops / 1e9,
        "macs_G": flops / 2e9,
        "strides": model.get_strides(),
        "img_size": img_size,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None)
    ap.add_argument("--img_size", type=int, default=640)
    ap.add_argument("--num_classes", type=int, default=3)
    ap.add_argument("--all", action="store_true", help="analyze the whole zoo")
    ap.add_argument("--device", default="cuda", help="cuda | cpu | cuda:<n>")
    return ap


def main(argv=None):
    """Prints the table; returns the rows that did not fail."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.all:
        targets = sorted(glob.glob(os.path.join(REPO_ROOT, "configs", "models", "*.yaml")))
    else:
        if not args.model:
            ap.error("--model or --all required")
        targets = [args.model]

    print(f"{'model':22s} {'backbone':28s} {'params(M)':>9s} {'GFLOPs':>8s} "
          f"{'GMACs':>8s}  strides")
    rows = []
    for t in targets:
        try:
            info = analyze(t, args.img_size, args.num_classes, args.device)
        except Exception as e:      # JAX's table goes on past a config that fails
            print(f"{os.path.basename(t):22s} FAILED: {e}")
            continue
        print(f"{info['model']:22s} {info['backbone']:28s} "
              f"{info['params_M']:9.3f} {info['flops_G']:8.2f} "
              f"{info['macs_G']:8.2f}  {info['strides']}")
        rows.append(info)
    return rows


if __name__ == "__main__":
    main()
