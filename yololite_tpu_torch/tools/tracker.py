"""Multi-object tracking over a video (port of `tools/tracker.py`).

    python -m yololite_tpu_torch.tools.tracker --weights best.ckpt \
        --video input.mp4 [--out out.mp4 | --out out/%04d.jpg] \
        [--max_frames N] [--device cuda]

`Predictor.infer_stream` (two graph calls in flight) feeds a
`KalmanSortTracker`; prints "Processed N frames @ F FPS".

`--video` takes what `cv2.VideoCapture` opens, decoded as it decodes:

  - a video file (`data/video.py`): MP4/MOV (fragmented too), AVI (OpenDML
    too), Matroska/WebM (`data/mkv.py`: OBS recordings, laced and
    header-stripped blocks, a file whose recording stopped before its
    sizes were written), MPEG-TS and M2TS (`data/mpegts.py`: dashcam and
    camcorder files) or a raw H.264/HEVC Annex B stream, holding MPEG-4
    Part 2 (what the JAX tool's writer produces: mp4v, XVID, FMP4, DIVX),
    Motion-JPEG, H.264 (progressive 8-bit 4:2:0, Baseline/Main/High) or
    HEVC (Main, Main 10: 8- and 10-bit 4:2:0), read by the port's host
    decoders frame for frame as OpenCV 5.0's FFmpeg gives them. A sample
    cut short by the end of the file is the last (an MPEG-4 picture
    concealed where its data stops; H.264/HEVC pictures still held for
    reordering are dropped, as cv2 drops them), and a packet that does not
    decode ends the stream; either prints a `[stop]` line. VP8/VP9/AV1,
    MPEG-1/2 video, encrypted files, the MPEG-4 tools past Simple Profile,
    interlaced, 4:2:2/4:4:4 or lossless H.264 and the HEVC tools x265
    never writes raise `UnsupportedVideo` naming them;
  - a printf pattern of JPEG, PNG or BMP files (`frames/%04d.png`), decoded
    by the port's codecs from the first index in 0-4 that exists up to the
    first index missing, as OpenCV 5.0 does (a frame OpenCV cannot decode
    ends the sequence there too; frames must share one size), or one image
    file, a sequence of one frame.

A missing file or one that is no video gives `SystemExit("Cannot open video
source ...")`, as the JAX tool's `cap.isOpened()` check does; a camera index
raises `NotImplementedError` (the card's machine has no camera).

`--out` draws each frame as the JAX tool does (track boxes and labels in
the class colour, the FPS line) and writes it: `.mp4`, `.m4v`, `.mov`,
`.avi` or `.mkv` as MPEG-4 Part 2 (the JAX tool's `cv2.VideoWriter(...,
"mp4v")`; the
port's writer codes I-VOPs at a fixed quantizer, `data/video.VideoWriter`)
at the source's rate, `cap.get(CAP_PROP_FPS) or 30`, which OpenCV 5.0
reports as 25 for an image sequence; a printf pattern as a sequence of image
files numbered from 1 (as OpenCV's image-sequence writer numbers them),
encoded by their extension. Any other container (`.ts`, `.m2ts`, `.mpg`,
`.3gp`, which cv2 also writes; `.webm`, which it cannot) raises
`NotImplementedError`; `--show` (a window) raises as well.
"""

from __future__ import annotations

import argparse
import itertools
import os
import re
import time
from collections import deque

from yololite_tpu_torch.data import codecs, imgops
from yololite_tpu_torch.data.codecs import imread_bgr
from yololite_tpu_torch.data.imwrite import imwrite_bgr
from yololite_tpu_torch.data.video import VideoReader, VideoWriter
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.track import KalmanSortTracker
from yololite_tpu_torch.utils.viz import class_color

_PRINTF_INT = re.compile(r"%0?\d*d")
# cv2.VideoCapture's image-sequence reader (ffmpeg's image2 demuxer) looks
# for the first frame among these indices
FIRST_INDICES = range(5)
# the frame rate cv2.VideoCapture reports for an image sequence (OpenCV 5.0),
# which the JAX tool's writer takes
SEQUENCE_FPS = 25.0
# the JAX tool's writer rate when its source reports none
DEFAULT_FPS = 30.0
VIDEO_OUT = (".mp4", ".m4v", ".mov", ".avi", ".mkv")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--video", required=True,
                    help="video file (.mp4/.mov/.avi/.mkv/.webm/.ts/.m2ts/.h264/.hevc) or "
                         "printf pattern of image files, "
                         "e.g. frames/%%04d.png")
    ap.add_argument("--out", default=None,
                    help="output: out.mp4 (or .m4v/.mov/.avi/.mkv; mp4v) or a pattern "
                         "out/%%04d.jpg")
    ap.add_argument("--conf", type=float, default=0.35)
    ap.add_argument("--iou", type=float, default=0.45)
    ap.add_argument("--track_iou", type=float, default=0.3)
    ap.add_argument("--max_age", type=int, default=15)
    ap.add_argument("--min_hits", type=int, default=2)
    ap.add_argument("--max_frames", type=int, default=0, help="0 = all")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda | cpu | cuda:<n>")
    return ap


def _is_pattern(path: str) -> bool:
    return len(_PRINTF_INT.findall(path)) == 1


def sequence_paths(pattern: str):
    """The files `cv2.VideoCapture(pattern)` reads, in order."""
    first = next((i for i in FIRST_INDICES if os.path.exists(pattern % i)), None)
    if first is None:
        raise SystemExit(f"Cannot open video source {pattern}")
    i = first
    while os.path.exists(pattern % i):
        yield pattern % i
        i += 1


class Source:
    """What `--video` names, opened as `cv2.VideoCapture` opens it: `fps`
    (as CAP_PROP_FPS reports it), `frames(max_frames)` and, after the
    frames, `stop` (why they ended early, or None)."""

    def __init__(self, source: str):
        self.source, self.stop, self.reader, self.paths = source, None, None, None
        if source.isdigit():
            raise NotImplementedError(
                f"--video {source}: camera {source}: the port reads video files and image "
                f"sequences; there is no camera on the card's machine")
        if _is_pattern(source):
            self.paths = sequence_paths(source)
            self.fps = SEQUENCE_FPS
            return
        if not os.path.isfile(source):
            raise SystemExit(f"Cannot open video source {source}")
        with open(source, "rb") as f:
            head = f.read(codecs.SNIFF_BYTES)
        if codecs.sniff(head):                  # one image: a sequence of one frame
            self.paths, self.fps = iter([source]), SEQUENCE_FPS
            return
        try:
            self.reader = VideoReader(source)
        except ValueError as e:
            raise SystemExit(f"Cannot open video source {source} ({e})") from e
        self.fps = self.reader.fps

    def frames(self, max_frames: int = 0):
        """BGR frames (at most `max_frames`, 0 = all); prints a `[stop]` line
        where the source ends before its last frame."""
        it = self._video() if self.reader is not None else self._sequence()
        for k, frame in enumerate(it):
            if max_frames and k >= max_frames:
                return
            yield frame
        if self.stop:
            print(f"[stop] {self.stop}")

    def _video(self):
        yield from self.reader
        self.stop = self.reader.stop_reason

    def _sequence(self):
        size = None
        for path in self.paths:
            try:
                frame = imread_bgr(path)
            except ValueError:              # cv2's read fails here and the stream ends
                self.stop = f"cannot read {path}"
                return
            if size is not None and frame.shape != size:
                raise ValueError(f"{path}: frame shape {frame.shape} differs from the first "
                                 f"frame's {size}")
            size = frame.shape
            yield frame


def read_frames(source: str, max_frames: int = 0):
    """BGR frames of `--video` (at most `max_frames`, 0 = all)."""
    yield from Source(source).frames(max_frames)


class SequenceWriter:
    """Frames written as the files of a printf pattern, numbered from 1."""

    def __init__(self, pattern: str):
        self.pattern, self.n = pattern, 0

    def write(self, frame) -> None:
        self.n += 1
        path = self.pattern % self.n
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        imwrite_bgr(path, frame)

    def close(self) -> None:
        pass


def check_out(out: str) -> None:
    """`--out` must be a printf pattern of image files or a video file the
    writer writes (VIDEO_OUT)."""
    if not (_is_pattern(out) or out.lower().endswith(VIDEO_OUT)):
        raise NotImplementedError(
            f"--out {out!r}: the port writes an image sequence (out/%04d.jpg) or MPEG-4 "
            f"Part 2 in {', '.join(VIDEO_OUT)}; other containers are not written")


def open_writer(out: str, size, fps: float):
    """The writer for `--out` (`check_out`) for frames of `size` (w, h) at
    `fps` (the source's)."""
    check_out(out)
    if _is_pattern(out):
        return SequenceWriter(out)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    return VideoWriter(out, fps, size)


def draw_tracks(frame, tracks, fps: float) -> None:
    """The JAX tool's overlay, drawn on the BGR frame in place: each track's
    box and "#id c<cls> score" in its class colour, then the FPS line."""
    for t in tracks:
        x1, y1, x2, y2 = [int(v) for v in t["bbox"]]
        color = class_color(t["cls"])
        imgops.rectangle(frame, (x1, y1), (x2, y2), color, 2)
        imgops.put_text(frame, f"#{t['track_id']} c{t['cls']} {t['score']:.2f}",
                        (x1, max(12, y1 - 6)), 0.5, color, 1)
    imgops.put_text(frame, f"FPS {fps:.1f}", (8, 24), 0.8, (0, 255, 0), 2)


def run(args):
    """Track over the sequence, drawing and writing each frame with --out;
    returns (the tracker's output for each frame, the last FPS reading)."""
    if args.show:
        raise NotImplementedError("--show opens a window (cv2.imshow), which the port "
                                  "does not have: ROADMAP Queue 3 (the tracker's output)")
    if args.out:
        check_out(args.out)             # before the model loads
    source = Source(args.video)         # opens the source before the model loads
    frames = source.frames(args.max_frames)
    first = next(frames, None)
    pred = Predictor(args.weights, device=args.device)
    pred.warmup(conf=args.conf, iou=args.iou)
    tracker = KalmanSortTracker(iou_threshold=args.track_iou, max_age=args.max_age,
                                min_hits=args.min_hits)

    # the stream yields results in order without their frames: pair them
    pending = deque()

    def stream():
        if first is not None:
            for f in itertools.chain([first], frames):
                pending.append(f)
                yield f

    per_frame, n, fps, writer = [], 0, 0.0, None
    t0 = time.perf_counter()
    try:
        for res in pred.infer_stream(stream(), conf=args.conf, iou=args.iou):
            frame = pending.popleft()
            tracks = tracker.update(res["boxes"], res["scores"], res["classes"])
            per_frame.append(tracks)
            n += 1
            if n % 10 == 0:
                fps = n / (time.perf_counter() - t0)
            if args.out:
                frame = frame.copy()
                draw_tracks(frame, tracks, fps)
                if writer is None:
                    writer = open_writer(args.out, (frame.shape[1], frame.shape[0]),
                                         source.fps or DEFAULT_FPS)
                writer.write(frame)
    finally:
        if writer is not None:
            writer.close()
    return per_frame, fps


def main(argv=None):
    args = build_parser().parse_args(argv)
    tracks, fps = run(args)
    print(f"Processed {len(tracks)} frames @ {fps:.1f} FPS"
          + (f" -> {args.out}" if args.out else ""))
    return tracks


if __name__ == "__main__":
    main()
