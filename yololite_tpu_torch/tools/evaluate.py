"""Test-set evaluation CLI (port of `tools/evaluate.py`).

    python -m yololite_tpu_torch.tools.evaluate --weights best.ckpt \
        --test_folder data/test/images [--quantize int8] [--device cuda]

Loads a checkpoint and evaluates it on --test_folder (labels beside it:
images -> labels) or on the --split of a --data yaml, into runs/evaluate/<n>
(`eval/evaluate.evaluate_checkpoint`): COCO stats, the P/R/F1 sweep, the
confusion matrix, forward latency and the summary. A segmentation
checkpoint is evaluated with its masks (segm mAP beside bbox). --quantize
int8 evaluates the dynamic-int8 Predictor's model (the int8 kernels on the
card). The checkpoint is read once.
"""

from __future__ import annotations

import argparse
import os

from yololite_tpu_torch.config.config import load_configs, next_run_dir
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.eval.evaluate import evaluate_checkpoint
from yololite_tpu_torch.train.checkpoint import load_checkpoint


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--test_folder", default=None,
                    help="images dir (labels inferred: images->labels)")
    ap.add_argument("--data", default=None, help="data.yaml (uses test/val split)")
    ap.add_argument("--split", default="test", choices=["test", "val"])
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--img_size", type=int, default=None)
    ap.add_argument("--conf", type=float, default=0.001)
    ap.add_argument("--iou", type=float, default=0.65)
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="evaluate the dynamic-int8 inference path (ops/quant.py)")
    ap.add_argument("--device", default="cuda", help="cuda | cpu | cuda:<n>")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.test_folder:
        img_dir = args.test_folder
        parts = os.path.normpath(img_dir).split(os.sep)
        lbl_dir = (os.sep.join(parts[:-1] + ["labels"]) if parts[-1].lower() == "images"
                   else os.path.join(img_dir, "..", "labels"))
    elif args.data:
        cfg = load_configs(None, None, args.data, make_run_dir=False)
        key = args.split if cfg["dataset"].get(f"{args.split}_images") else "val"
        img_dir = cfg["dataset"][f"{key}_images"]
        lbl_dir = cfg["dataset"][f"{key}_labels"]
    else:
        ap.error("need --test_folder or --data")

    ckpt = load_checkpoint(args.weights)
    meta = ckpt[1]
    task = ("segment" if (meta.get("config") or {}).get("model", {}).get("with_masks")
            else "detect")
    model = (Predictor(ckpt, device=args.device, quantize=args.quantize).model
             if args.quantize else None)
    out_dir = next_run_dir("runs/evaluate")
    results = evaluate_checkpoint(
        ckpt, img_dir, lbl_dir, out_dir, int(meta.get("num_classes", 1)),
        meta.get("names"), batch_size=args.batch_size, conf=args.conf, iou=args.iou,
        img_size=args.img_size, task=task, model=model, device=args.device)
    print(f"Results -> {out_dir}")
    for k, v in results["coco"].items():
        print(f"  {k}: {v:.4f}")
    print(f"  best_f1: {results['best_f1']:.4f} @ conf {results['best_conf']:.3f}")
    print(f"  forward: {results['ms_per_img']:.2f} ms/img")
    return results


if __name__ == "__main__":
    main()
