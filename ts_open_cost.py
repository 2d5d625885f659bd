"""Open time, read time and peak memory of the port's MPEG-TS (or
Matroska) demuxer on a recording of a dashcam's size and bitrate.

    python3 ts_open_cost.py [--container ts|mkv] [--mb 300] [--frame_kb 60] [--dir DIR]

Writes DIR/recording.ts (default: a temporary folder, removed after): the
committed 16-frame x264 clip (`tests/data/video/containers/a_h264.h264`)
repeated, each access unit padded with a filler NAL unit to `frame_kb` KB
(60 KB at 30 fps is 14.7 Mbit/s, a 1080p dashcam's rate), one PES a frame
with its PTS and DTS, and a 384-byte audio PES a frame on a second PID,
PAT and PMT every 30 frames. With `--container mkv`, DIR/recording.mkv:
cv2's mp4v clip (`c_mp4v_cv2.mkv`) repeated through the port's own
Matroska muxer, each frame zero-padded to `frame_kb` KB (its packets are
read, not decoded). Then, in a fresh process for each, it times
`video.probe` (the demuxer's walk of the file at open) and reading every
packet (`VideoReader.packets`), and prints one JSON line: file MB, frames,
open s, read s, MB/s of each and the peak resident MB of each process
(`ru_maxrss`, which includes the interpreter and the port's imports: its
value after the imports, before the work, is given beside as
`baseline_mb`; the read's peak includes its open).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CLIPS = os.path.join(ROOT, "tests", "data", "video", "containers")
FPS = 30
VIDEO_PID, AUDIO_PID, PMT_PID = 0x100, 0x101, 0x1000


def _pts(marker: int, t: int) -> bytes:
    return bytes([marker << 4 | ((t >> 30) & 7) << 1 | 1, (t >> 22) & 0xFF,
                  ((t >> 15) & 0x7F) << 1 | 1, (t >> 7) & 0xFF, (t & 0x7F) << 1 | 1])


class _Muxer:
    """Transport packets of PES and PSI, continuity counted per PID."""

    def __init__(self):
        self.cc = {}

    def packets(self, pid: int, payload: bytes, start: bool) -> bytes:
        out, i = [], 0
        while i < len(payload):
            cc = self.cc.get(pid, 0)
            self.cc[pid] = (cc + 1) & 15
            chunk = payload[i:i + 184]
            head = bytes([0x47, (0x40 if start and i == 0 else 0) | pid >> 8, pid & 0xFF])
            if len(chunk) == 184:
                out.append(head + bytes([0x10 | cc]) + chunk)
            else:                                  # stuffing in an adaptation field
                pad = 183 - len(chunk)
                af = bytes([pad]) + (b"\x00" + b"\xff" * (pad - 1) if pad else b"")
                out.append(head + bytes([0x30 | cc]) + af + chunk)
            i += 184
        return b"".join(out)

    def section(self, pid: int, table_id: int, ext: int, body: bytes) -> bytes:
        from yololite_tpu_torch.data.mpegts import crc32
        sec = bytes([table_id, 0xB0 | (len(body) + 9) >> 8, (len(body) + 9) & 0xFF,
                     ext >> 8, ext & 0xFF, 0xC1, 0, 0]) + body
        sec += crc32(sec).to_bytes(4, "big")
        return self.packets(pid, b"\x00" + sec + b"\xff" * (183 - len(sec)), True)


def write_ts(path: str, mb: float, frame_kb: float) -> int:
    """Writes the transport stream; returns its frame count."""
    from yololite_tpu_torch.data import esparse
    clip = open(os.path.join(CLIPS, "a_h264.h264"), "rb").read()
    edges = [0] + esparse.Splitter("h264").feed(clip, final=True) + [len(clip)]
    units = [clip[a:b] for a, b in zip(edges, edges[1:])]
    mux, total, k = _Muxer(), 0, 0
    pat = mux.section(0, 0x00, 1, bytes([0, 1, 0xE0 | PMT_PID >> 8, PMT_PID & 0xFF]))
    with open(path, "wb") as f:
        while total < mb * 1e6:
            if k % 30 == 0:
                pmt = mux.section(PMT_PID, 0x02, 1, bytes([0xE1, 0x00, 0xF0, 0x00,
                                                           0x1B, 0xE1, 0x00, 0xF0, 0x00,
                                                           0x0F, 0xE1, 0x01, 0xF0, 0x00]))
                f.write(pat + pmt)
                total += len(pat) + len(pmt)
            au = units[k % len(units)]
            pad = max(int(frame_kb * 1000) - len(au) - 6, 0)
            au += b"\x00\x00\x00\x01\x0c" + b"\xff" * pad + b"\x80"      # filler NAL unit
            t = 90000 * k // FPS + 9000
            pes = b"\x00\x00\x01\xe0\x00\x00\x80\xc0\x0a" + _pts(3, t) + _pts(1, t - 3000) + au
            audio = b"\x00\x00\x01\xc0" + (384 + 8).to_bytes(2, "big") + b"\x80\x80\x05" \
                + _pts(2, t) + bytes(384)
            data = mux.packets(VIDEO_PID, pes, True) + mux.packets(AUDIO_PID, audio, True)
            f.write(data)
            total += len(data)
            k += 1
    return k


def write_mkv(path: str, mb: float, frame_kb: float) -> int:
    """Writes the Matroska file; returns its frame count."""
    from yololite_tpu_torch.data import mkv, video
    src = os.path.join(CLIPS, "c_mp4v_cv2.mkv")
    track = video.probe(src)
    with open(src, "rb") as f:
        frames = []
        for sample in track.samples:
            f.seek(sample.offset)
            frames.append(f.read(sample.size))
    mux, k = mkv.MkvMuxer(path, (track.width, track.height), FPS, track.extradata), 0
    while mux.f.tell() < mb * 1e6:
        frame = frames[k % len(frames)]
        mux.write(frame + bytes(max(int(frame_kb * 1000) - len(frame), 0)))
        k += 1
    mux.close()
    return k


_CHILD = r"""
import json, resource, sys, time
sys.path.insert(0, sys.argv[1])
from yololite_tpu_torch.data import video
path, what = sys.argv[2], sys.argv[3]
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
t0 = time.perf_counter()
n = 0
if what == "open":
    n = len(video.probe(path).samples)
elif what == "read":
    reader = video.VideoReader(path)
    t0 = time.perf_counter()
    for p in reader.packets():
        n += 1
print(json.dumps({"s": time.perf_counter() - t0, "n": n, "baseline_mb": base,
                  "peak_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024}))
"""


def _child(path: str, what: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, ROOT, path, what], check=True,
                          capture_output=True, text=True)
    return json.loads(proc.stdout.splitlines()[-1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--container", choices=("ts", "mkv"), default="ts")
    ap.add_argument("--mb", type=float, default=300.0)
    ap.add_argument("--frame_kb", type=float, default=60.0)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    work = args.dir or tempfile.mkdtemp()
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "recording." + args.container)
    try:
        t0 = time.perf_counter()
        frames = (write_ts if args.container == "ts" else write_mkv)(path, args.mb, args.frame_kb)
        write_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        opened, read = _child(path, "open"), _child(path, "read")
        if opened["n"] != frames or read["n"] != frames:
            raise AssertionError(f"{frames} frames written, {opened['n']} found at open, "
                                 f"{read['n']} read")
        out = {"container": args.container, "file_mb": mb, "frames": frames, "write_s": write_s,
               "open_s": opened["s"], "open_mb_per_s": mb / opened["s"],
               "open_peak_mb": opened["peak_mb"], "open_baseline_mb": opened["baseline_mb"],
               "read_s": read["s"], "read_mb_per_s": mb / read["s"],
               "read_peak_mb": read["peak_mb"], "read_baseline_mb": read["baseline_mb"]}
        print(json.dumps(out))
        return out
    finally:
        if args.dir is None:
            shutil.rmtree(work, ignore_errors=True)
        else:
            os.remove(path)


if __name__ == "__main__":
    main()
