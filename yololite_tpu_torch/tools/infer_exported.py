"""Inference from an exported artifact (port of `tools/infer_exported.py`).

    python -m yololite_tpu_torch.tools.infer_exported --artifact model_nms.pt2 --img x.jpg
    python -m yololite_tpu_torch.tools.infer_exported --artifact model_decoded.onnx --img x.jpg
    python -m yololite_tpu_torch.tools.infer_exported --artifact model_nms.tflite --img x.jpg

Loads a `.pt2` program (it runs on the device it was exported on), an
`.onnx` or a `.tflite` file (the port's numpy runners, on the host) with its
`.json` sidecar, reads the image with the port's codecs and runs
`deploy/infer_exported.infer_frame`: letterbox, the artifact, then the
"decoded" format's host sigmoid, score and per-class NMS, or the "nms"
format's in-graph detections filtered by --conf on the host (its iou and
max_det were fixed at export). Prints the per-stage times and one line a
detection; `--out` writes the drawn detections (encoded by the extension).
"""

from __future__ import annotations

import argparse

from yololite_tpu_torch.data.codecs import imread_bgr
from yololite_tpu_torch.data.imwrite import imwrite_bgr
from yololite_tpu_torch.deploy.export import load_exported
from yololite_tpu_torch.deploy.infer_exported import infer_frame


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", required=True, help="*.pt2, *.onnx or *.tflite path")
    ap.add_argument("--img", required=True)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--max_det", type=int, default=300)
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    call, meta = load_exported(args.artifact)
    try:
        img_bgr = imread_bgr(args.img)
    except ValueError:                  # where cv2.imread gives None
        raise SystemExit(f"cannot read {args.img}")
    r = infer_frame(call, meta, img_bgr, args.conf, args.iou, args.max_det)
    if meta.get("format", "decoded") == "nms" and args.iou != ap.get_default("iou"):
        print(f"[warn] --iou is fixed at export time for 'nms' artifacts "
              f"(artifact iou={meta.get('iou')})")
    sp = r["speed"]
    nmask = f" | {len(r['masks'])} masks" if r["masks"] is not None else ""
    print(f"{len(r['boxes'])} detections{nmask} | pre {sp['preprocess_ms']:.1f} ms | "
          f"infer {sp['inference_ms']:.1f} ms | post {sp['postprocess_ms']:.1f} ms")
    for box, sc, cl in zip(r["boxes"], r["scores"], r["classes"]):
        print(f"  cls {int(cl)} {sc:.3f} {box.round(1).tolist()}")
    if args.out:
        from yololite_tpu_torch.utils.viz import draw_detections
        vis = draw_detections(img_bgr[..., ::-1], r["boxes"], r["scores"], r["classes"],
                              meta.get("names"))
        imwrite_bgr(args.out, vis[..., ::-1])
        print(f"saved {args.out}")
    return r


if __name__ == "__main__":
    main()
