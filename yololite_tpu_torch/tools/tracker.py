"""Multi-object tracking over an image sequence (port of `tools/tracker.py`).

    python -m yololite_tpu_torch.tools.tracker --weights best.ckpt \
        --video frames/%04d.png [--max_frames N] [--device cuda]

`Predictor.infer_stream` (two graph calls in flight) feeds a
`KalmanSortTracker`; prints "Processed N frames @ F FPS". The port has no
video decoder: `--video` takes what `cv2.VideoCapture` reads as an image
sequence, a printf pattern of JPEG, PNG or BMP files (`frames/%04d.png`),
decoded by the port's codecs from the first index in 0-4 that exists up to
the first index missing, as OpenCV 5.0 does (a frame OpenCV cannot decode
ends the sequence there too; frames must share one size). A container file
or a camera index, `--out` (`cv2.VideoWriter` and drawing) and `--show` raise
`NotImplementedError` (ROADMAP, "When a user needs them": video files for
the tracker; drawing, Queue 1 item 8d).
"""

from __future__ import annotations

import argparse
import os
import re
import time

from yololite_tpu_torch.data.codecs import imread_bgr
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.track import KalmanSortTracker

_PRINTF_INT = re.compile(r"%0?\d*d")
# cv2.VideoCapture's image-sequence reader (ffmpeg's image2 demuxer) looks
# for the first frame among these indices
FIRST_INDICES = range(5)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--video", required=True,
                    help="printf pattern of image files, e.g. frames/%%04d.png")
    ap.add_argument("--out", default=None, help="output video path (not ported)")
    ap.add_argument("--conf", type=float, default=0.35)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--track_iou", type=float, default=0.3)
    ap.add_argument("--max_age", type=int, default=15)
    ap.add_argument("--min_hits", type=int, default=2)
    ap.add_argument("--max_frames", type=int, default=0, help="0 = all")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda | cpu | cuda:<n>")
    return ap


def sequence_paths(pattern: str):
    """The files `cv2.VideoCapture(pattern)` reads, in order. A pattern with
    no printf integer field (a container file) or a camera index raises."""
    if pattern.isdigit() or len(_PRINTF_INT.findall(pattern)) != 1:
        raise NotImplementedError(
            f"--video {pattern!r}: the port reads image sequences given as one printf "
            f"pattern (frames/%04d.png); camera indices and video files need a video "
            f"decoder: ROADMAP, 'When a user needs them' (video files for the tracker)")
    first = next((i for i in FIRST_INDICES if os.path.exists(pattern % i)), None)
    if first is None:
        raise SystemExit(f"Cannot open video source {pattern}")
    i = first
    while os.path.exists(pattern % i):
        yield pattern % i
        i += 1


def read_frames(pattern: str, max_frames: int = 0):
    """BGR frames of the sequence (at most `max_frames`, 0 = all)."""
    size = None
    for k, path in enumerate(sequence_paths(pattern)):
        if max_frames and k >= max_frames:
            return
        try:
            frame = imread_bgr(path)
        except ValueError:              # cv2's read fails here and the stream ends
            print(f"[stop] cannot read {path}")
            return
        if size is not None and frame.shape != size:
            raise ValueError(f"{path}: frame shape {frame.shape} differs from the first "
                             f"frame's {size}")
        size = frame.shape
        yield frame


def run(args):
    """Track over the sequence; returns (the tracker's output for each frame,
    the last FPS reading)."""
    if args.out or args.show:
        raise NotImplementedError("--out and --show draw the tracks (cv2.VideoWriter, "
                                  "utils/viz.py): ROADMAP Queue 1 item 8d")
    frames = read_frames(args.video, args.max_frames)
    first = next(frames, None)          # opens the source before the model loads
    pred = Predictor(args.weights, device=args.device)
    pred.warmup(conf=args.conf, iou=args.iou)
    tracker = KalmanSortTracker(iou_threshold=args.track_iou, max_age=args.max_age,
                                min_hits=args.min_hits)

    def stream():
        if first is not None:
            yield first
            yield from frames

    per_frame, n, fps = [], 0, 0.0
    t0 = time.perf_counter()
    for res in pred.infer_stream(stream(), conf=args.conf, iou=args.iou):
        per_frame.append(tracker.update(res["boxes"], res["scores"], res["classes"]))
        n += 1
        if n % 10 == 0:
            fps = n / (time.perf_counter() - t0)
    return per_frame, fps


def main(argv=None):
    tracks, fps = run(build_parser().parse_args(argv))
    print(f"Processed {len(tracks)} frames @ {fps:.1f} FPS")
    return tracks


if __name__ == "__main__":
    main()
