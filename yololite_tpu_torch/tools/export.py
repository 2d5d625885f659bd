"""Export CLI (port of `tools/export.py`).

    python -m yololite_tpu_torch.tools.export --weights best.ckpt --format nms \
        [--runtime pt2|onnx|tflite] [--quantize dynamic|fp16] [--batch B] [--fp32]
        [--device cuda]

Formats: "raw" (per-level maps), "decoded" (boxes and logits, NMS outside)
and "nms" (the whole graph, NMS included). Runtimes: "pt2" (the default, a
`torch.export` program on `--device`, the counterpart of JAX's StableHLO
artifact), "onnx" (fp32 "raw"/"decoded", `--dynamic_batch` for a symbolic
batch axis) and "tflite" (all three formats, traced on the CPU and written
by the port's own emitter; `--quantize fp16|dynamic` for float16 or int8
weights; it runs on a host CPU). Ends with JAX's load-back sanity run on one
zero batch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from yololite_tpu_torch.deploy.export import (
    export_model, export_onnx, export_tflite, load_exported,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--format", default="decoded", choices=["raw", "decoded", "nms"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--img_size", type=int, default=None)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--iou", type=float, default=0.65)
    ap.add_argument("--max_det", type=int, default=300)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--fp32", action="store_true", help="export in fp32 (default bf16)")
    ap.add_argument("--runtime", default="pt2", choices=["pt2", "tflite", "onnx"],
                    help="pt2: torch.export program for the card; onnx: opset-17 "
                         "ONNX for a host runtime; tflite: a TFLite file for a host CPU")
    ap.add_argument("--quantize", default=None, choices=[None, "dynamic", "fp16"],
                    help="tflite only")
    ap.add_argument("--dynamic_batch", action="store_true",
                    help="onnx only: symbolic batch axis")
    ap.add_argument("--device", default="cuda", help="pt2 only: cuda | cpu | cuda:<n>")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    common = dict(out_dir=args.out_dir, fmt=args.format, batch=args.batch,
                  img_size=args.img_size, conf=args.conf, iou=args.iou,
                  max_det=args.max_det)
    if args.runtime == "tflite":
        path = export_tflite(args.weights, quantize=args.quantize, **common)
    elif args.runtime == "onnx":
        path = export_onnx(args.weights, dynamic_batch=args.dynamic_batch, **common)
    else:
        path = export_model(args.weights, dtype=torch.float32 if args.fp32 else torch.bfloat16,
                            device=args.device, **common)
    # load-back sanity run
    call, meta = load_exported(path)
    out = call(np.zeros((args.batch, meta["img_size"], meta["img_size"], 3), np.uint8))
    print(f"Exported {args.format} artifact -> {path}")
    print(f"Sanity run OK; output tree: {type(out).__name__}")
    return path


if __name__ == "__main__":
    main()
