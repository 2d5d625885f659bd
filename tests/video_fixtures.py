"""Writes the committed video fixtures under tests/data/video/ and their
manifest: for each file cv2.VideoCapture's fps, frame count and size, the
SHA-256 of each raw packet (`CAP_PROP_FORMAT = -1`) and of each decoded BGR
frame.

    python tests/video_fixtures.py

The clips are written by this machine's cv2 (OpenCV 5.0, FFmpeg's encoders:
avcodec 62.28.101): 24 frames of a panning scene as mp4v in .mp4 at 30 and
at 29.97 fps (two GOPs of I and P-VOPs each), at 328x244 (not a multiple of
16 either way), 6 frames at 640x480 (which `chip_smoke.py` also times), the
same stream as XVID in .avi, 12 frames of Motion-JPEG
in .avi, and Motion-JPEG in .mov (`jpeg`) and in .mp4 (an `mp4v` entry whose
object type is JPEG); a truncated .mp4 (the 30 fps clip with `moov` moved
before `mdat`, cut inside the second GOP) and a VP8 .webm, which only has
to raise. `chip_smoke.py` decodes each with the port on the card's machine,
which has no cv2, and holds the frames to the manifest;
`tests/test_torch_port_video.py` regenerates the manifest from the committed
files so it cannot drift.
"""

import glob
import hashlib
import json
import os
import struct

import cv2
import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video")
TRUNCATE_AT = 0.75          # of the file: inside the second GOP's P-VOPs


def scene(t: int, h: int, w: int) -> np.ndarray:
    """Frame t of a panning scene (BGR): a smooth pattern moving 3 px right
    and 1 px down a frame (so that motion vectors point past the edges), a
    black band (samples at 0 under half-pel averaging), a fine checker patch
    (large coefficients), and two shapes moving on their own."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    xs, ys = x - 3 * t, y - t
    img = np.stack([128 + 100 * np.sin(xs / 23.0) * np.cos(ys / 31.0),
                    128 + 90 * np.sin((xs + ys) / 41.0),
                    128 + 80 * np.cos(xs / 17.0 - ys / 29.0)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    img[h // 2 - 10:h // 2 + 6, :] = 0
    cy, cx = 20 + t % 8, w - 60
    check = ((np.indices((24, 24)).sum(0) // 2) % 2 * 200 + 30).astype(np.uint8)
    img[cy:cy + 24, cx:cx + 24] = check[..., None]
    cv2.rectangle(img, (10 + 6 * t, 30 + 2 * t), (60 + 6 * t, 90 + 2 * t), (20, 200, 60), -1)
    cv2.circle(img, (w - 50 - 4 * t, h - 60), 22, (210, 40, 120), -1)
    return img


def write(name: str, fourcc: str, fps: float, size, n: int) -> str:
    path = os.path.join(DIR, name)
    w, h = size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened(), name
    for t in range(n):
        vw.write(scene(t, h, w))
    vw.release()
    return path


def boxes(data: bytes, off: int, end: int):
    while off + 8 <= end:
        size, kind = struct.unpack(">I4s", data[off:off + 8])
        yield kind, off, size
        off += size


def faststart(data: bytes) -> bytes:
    """The MP4 with `moov` moved before `mdat` (chunk offsets shifted)."""
    top = list(boxes(data, 0, len(data)))
    moov = next(data[o:o + s] for k, o, s in top if k == b"moov")
    shift = len(moov)
    moov = bytearray(moov)
    i = moov.find(b"stco")
    n = struct.unpack(">I", moov[i + 8:i + 12])[0]
    for k in range(n):
        p = i + 12 + 4 * k
        moov[p:p + 4] = struct.pack(">I", struct.unpack(">I", moov[p:p + 4])[0] + shift)
    out = b""
    for k, o, s in top:
        if k == b"mdat":
            out += bytes(moov)
        if k != b"moov":
            out += data[o:o + s]
    return out


def cv2_read(path: str):
    """(fps, frame count, (w, h), [packets], [frames]) as cv2 reads the file."""
    cap = cv2.VideoCapture(path)
    meta = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    packets = []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        packets.append(p.tobytes())
    return meta[0], meta[1], meta[2], packets, frames


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def manifest() -> dict:
    """cv2's reading of each committed clip (the webm only by name)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(DIR, "*"))):
        name = os.path.basename(path)
        if name.endswith((".json", ".webm")) or not os.path.isfile(path):   # h264/: its own
            continue
        fps, count, size, packets, frames = cv2_read(path)
        out[name] = {"fps": fps, "frame_count": count, "size": list(size),
                     "packets": [sha(p) for p in packets],
                     "frames": [sha(np.ascontiguousarray(f)) for f in frames]}
    return out


def main():
    os.makedirs(DIR, exist_ok=True)
    for old in glob.glob(os.path.join(DIR, "*")):
        if os.path.isfile(old):
            os.remove(old)
    full = write("mp4v_320x240_30.mp4", "mp4v", 30, (320, 240), 24)
    write("mp4v_320x240_2997.mp4", "mp4v", 29.97, (320, 240), 24)
    write("mp4v_328x244.mp4", "mp4v", 30, (328, 244), 24)
    write("mp4v_640x480.mp4", "mp4v", 30, (640, 480), 6)
    write("xvid_320x240.avi", "XVID", 30, (320, 240), 24)
    write("mjpg_160x120.avi", "MJPG", 30, (160, 120), 12)
    write("mjpg_160x120.mov", "MJPG", 25, (160, 120), 3)
    write("mjpg_160x120.mp4", "MJPG", 25, (160, 120), 3)
    write("vp80_64x48.webm", "VP80", 30, (64, 48), 2)
    with open(full, "rb") as f:
        data = faststart(f.read())
    with open(os.path.join(DIR, "mp4v_truncated.mp4"), "wb") as f:
        f.write(data[:int(len(data) * TRUNCATE_AT)])
    with open(os.path.join(DIR, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
