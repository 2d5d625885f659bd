"""Benchmark harness (port of `tools/benchmark.py`).

Trains and evaluates models on one or more datasets, times single-image
latency and batched throughput on the device, and appends one CSV row per
(dataset, model), in the JAX tool's columns:

    python -m yololite_tpu_torch.tools.benchmark --data ds1/data.yaml ds2/data.yaml \
        --models edge_n edge_m --epochs 50 --out benchmark_results.csv [--device cuda]

Per pair: `YoloLite(model).train(...)`, `val(split="test")` (the val split
where the dataset has no test split), 50 `Predictor.infer_image_profiled`
calls after `warmup()` on a seeded frame (mean `total_ms`: host letterbox,
upload, graph and readback), and the batched graph the JAX tool jits:
uint8 frames -> normalize -> the eval model (the Predictor's model with
unfolded weights) -> `decode_anchorfree` -> `yolo_scores` ->
`batched_nms(iou 0.65, conf 0.25, max_det 100, pre_nms_topk 256)`, on
`bench_batch` zero frames, 3 warm calls then 10 timed ones ending in a
device sync (on the card, `batched_nms` launches the `nms_suppress`
kernel once a call). A pair that fails prints `FAILED: <error>` and
writes a row of zeros, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

HEADER = ["dataset", "model", "map50", "map", "best_f1", "latency_ms_single",
          "throughput_img_s_batched", "train_s", "timestamp"]
GRAPH_WARM, GRAPH_TIMED, LATENCY_CALLS = 3, 10, 50


def init_csv(path):
    if not os.path.exists(path):
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(HEADER)


def save_result(path, row):
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow(row)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batched_graph(pred, weights, img_size: int):
    """The JAX tool's jitted `infer(v, x)` as a function of a uint8 [B,S,S,3]
    batch on the device: its eval model is the Predictor's model built
    again with the checkpoint's unfolded weights (JAX's `eval_variables`),
    so the graph normalizes first."""
    from yololite_tpu_torch.deploy.predictor import Predictor
    from yololite_tpu_torch.ops.decode import decode_anchorfree
    from yololite_tpu_torch.ops.nms import batched_nms, yolo_scores
    from yololite_tpu_torch.train.steps import normalize_images
    model = Predictor(weights, device=pred.device, dtype=pred.dtype,
                      fold_normalize=False).model

    @torch.inference_mode()
    def infer(x):
        out = model(normalize_images(x, pred.dtype))
        outs = out[0] if model.with_masks else out
        d = decode_anchorfree([o.float() for o in outs], img_size,
                              num_classes=model.num_classes if model.with_masks else None)
        s, c = yolo_scores(d["obj"][..., 0], d["cls"])
        return batched_nms(d["box"], s, c, iou_th=0.65, conf_th=0.25, max_det=100,
                           pre_nms_topk=256)
    return infer


def bench_one(dataset: str, model_name: str, args) -> list:
    from yololite_tpu_torch.api import YoloLite
    model = YoloLite(model_name, device=args.device)
    t0 = time.time()
    model.train(data=dataset, epochs=args.epochs, batch_size=args.batch_size,
                img_size=args.img_size)
    train_s = time.time() - t0

    stats = model.val(data=dataset, split="test")
    map50, map_all = stats["map_50"], stats["map"]

    # single-image latency (deploy path, incl. pre/post on host)
    pred = model.predictor
    pred.warmup()
    rng = np.random.RandomState(0)
    frame = (rng.rand(args.img_size, args.img_size, 3) * 255).astype(np.uint8)
    times = [pred.infer_image_profiled(frame)["speed"]["total_ms"]
             for _ in range(LATENCY_CALLS)]
    lat = float(np.mean(times))

    # batched throughput (the serving configuration)
    infer = batched_graph(pred, model._src["ckpt"], args.img_size)
    x = torch.zeros((args.bench_batch, args.img_size, args.img_size, 3), dtype=torch.uint8,
                    device=pred.device)
    for _ in range(GRAPH_WARM):
        infer(x)
    _sync(pred.device)
    t0 = time.perf_counter()
    for _ in range(GRAPH_TIMED):
        infer(x)
    _sync(pred.device)
    thr = args.bench_batch / ((time.perf_counter() - t0) / GRAPH_TIMED)

    print(f"mAP50 {map50:.3f} | mAP {map_all:.3f} | "
          f"{lat:.2f} ms single | {thr:.0f} img/s batched")
    return [dataset, model_name, f"{map50:.4f}", f"{map_all:.4f}",
            f"{stats.get('best_f1', 0):.4f}", f"{lat:.2f}", f"{thr:.0f}",
            f"{train_s:.0f}", time.strftime("%Y-%m-%dT%H:%M:%S")]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", nargs="+", required=True, help="data.yaml paths")
    ap.add_argument("--models", nargs="+", default=["edge_n"],
                    help="model names from configs/models")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--img_size", type=int, default=640)
    ap.add_argument("--bench_batch", type=int, default=128)
    ap.add_argument("--out", default="benchmark_results.csv")
    ap.add_argument("--device", default="cuda", help="cuda | cpu | cuda:<n>")
    return ap


def main(argv=None):
    """Returns the rows written, in order."""
    args = build_parser().parse_args(argv)
    init_csv(args.out)
    rows = []
    for dataset in args.data:
        for model_name in args.models:
            print(f"\n=== {dataset} / {model_name} ===")
            try:
                row = bench_one(dataset, model_name, args)
            except Exception as e:      # the JAX tool's zero row; the error is printed
                print(f"FAILED: {e}")
                row = [dataset, model_name, 0, 0, 0, 0, 0, 0,
                       time.strftime("%Y-%m-%dT%H:%M:%S")]
            save_result(args.out, row)
            rows.append(row)
    print(f"\nResults -> {os.path.abspath(args.out)}")
    return rows


if __name__ == "__main__":
    main()
