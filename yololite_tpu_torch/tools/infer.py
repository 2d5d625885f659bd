"""Inference CLI (port of `tools/infer.py`).

    python -m yololite_tpu_torch.tools.infer --weights best.ckpt --img image_or_dir \
        [--save_txt] [--save_json] [--out_dir DIR] [--device cuda]

Reads each image with the port's codecs (`data/codecs.imread_bgr`, JPEG, PNG,
BMP, TIFF and WebP as `cv2.imread` reads them), runs `Predictor.infer_image_profiled`
and writes the drawn detections (`{stem}_pred.jpg`), YOLO-txt labels and
JSON per image into runs/infer/<n> (or --out_dir) in the JAX CLI's
formats. A file cv2 could not read is skipped with JAX's "[skip] cannot
read" line; a format the codecs do not decode (GIF, JPEG 2000, ...)
raises `UnsupportedImage`.
"""

from __future__ import annotations

import argparse
import json
import os

from yololite_tpu_torch.config.config import next_run_dir
from yololite_tpu_torch.data.codecs import imread_bgr
from yololite_tpu_torch.data.imwrite import imwrite_bgr
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.utils.viz import draw_detections


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--img", required=True, help="image file or directory")
    ap.add_argument("--img_size", type=int, default=None)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--max_det", type=int, default=300)
    ap.add_argument("--use_resize", action="store_true",
                    help="plain resize instead of letterbox")
    ap.add_argument("--save_txt", action="store_true", help="save YOLO-txt labels")
    ap.add_argument("--save_json", action="store_true")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda | cpu | cuda:<n>")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out_dir = args.out_dir or next_run_dir("runs/infer")
    os.makedirs(out_dir, exist_ok=True)
    pred = Predictor(args.weights, device=args.device, use_letterbox=not args.use_resize)

    if os.path.isdir(args.img):
        files = sorted(os.path.join(args.img, f) for f in os.listdir(args.img)
                       if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    else:
        files = [args.img]

    results = {}
    for path in files:
        try:
            img_bgr = imread_bgr(path)
        except ValueError:              # where cv2.imread gives None
            print(f"[skip] cannot read {path}")
            continue
        r = pred.infer_image_profiled(img_bgr, args.img_size, args.conf, args.iou,
                                      args.max_det)
        results[path] = r
        stem = os.path.splitext(os.path.basename(path))[0]
        vis = draw_detections(img_bgr[..., ::-1], r["boxes"], r["scores"], r["classes"],
                              pred.names)
        imwrite_bgr(os.path.join(out_dir, f"{stem}_pred.jpg"), vis[..., ::-1])
        h, w = img_bgr.shape[:2]
        if args.save_txt:
            with open(os.path.join(out_dir, f"{stem}.txt"), "w") as f:
                for box, cl in zip(r["boxes"], r["classes"]):
                    x1, y1, x2, y2 = box
                    cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
                    bw, bh = (x2 - x1) / w, (y2 - y1) / h
                    f.write(f"{int(cl)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}\n")
        if args.save_json:
            with open(os.path.join(out_dir, f"{stem}.json"), "w") as f:
                json.dump({"source": path,
                           "boxes": r["boxes"].tolist(),
                           "scores": r["scores"].tolist(),
                           "classes": r["classes"].tolist(),
                           "speed": r["speed"]}, f, indent=2)
        print(f"{path}: {len(r['boxes'])} dets | {r['speed']['total_ms']:.1f} ms "
              f"(infer {r['speed']['inference_ms']:.1f})")
    print(f"Saved to {out_dir}")
    return results


if __name__ == "__main__":
    main()
