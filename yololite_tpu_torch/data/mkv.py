"""Matroska and WebM: the first video track as FFmpeg's matroska demuxer
gives it to cv2.VideoCapture, and an mp4v writer as FFmpeg's matroska
muxer writes cv2.VideoWriter's `.mkv`.

Reading: the EBML header (DocType `matroska` or `webm`), then the Segment's
Info (`TimestampScale`, `Duration`), its Tracks (the first video
`TrackEntry`: `CodecID`, `CodecPrivate`, `DefaultDuration`, `Video`'s
pixel size, `ContentEncodings`) and its Clusters (`SimpleBlock` and
`BlockGroup`/`Block`, with Xiph, EBML and fixed lacing: each laced frame is
a packet). A Segment or Cluster of unknown size (a recording stopped
before its muxer wrote the sizes) runs until the next element that cannot
be inside it; a file cut short ends with its last whole block, as FFmpeg
drops a block it cannot read in full. Content compression is read as
FFmpeg reads it: header stripping (`ContentCompAlgo` 3: the stripped
bytes are put back in front of each frame) and zlib (0, inflated as far
as FFmpeg's growing buffer allows); bzlib, LZO and encryption raise
`UnsupportedVideo`.

Codec IDs read: `V_MPEG4/ISO/AVC` (avcC; packets in Annex B as
`h264_mp4toannexb` gives them to cv2), `V_MPEGH/ISO/HEVC` (hvcC;
`hevc_mp4toannexb`), `V_MPEG4/ISO/SP`/`ASP`/`AP` (MPEG-4 Part 2, the VOL in
`CodecPrivate`), `V_MJPEG` and `V_MS/VFW/FOURCC` (a BITMAPINFOHEADER whose
FourCC names the codec, as in an AVI). VP8, VP9, AV1, MPEG-1/2 and the
rest raise `UnsupportedVideo` by name.

fps is FFmpeg's `avg_frame_rate`: from `DefaultDuration` (1e9 over it,
reduced to terms of 30000 at most), else estimated from the first blocks
(`esparse.avg_rate`: `BlockDuration`, else a frame of the codec's own rate,
in the track's time base); frame_count is cv2's ⌊Duration x fps + 0.5⌋.
A file without `Duration` has no duration in FFmpeg and cv2 reports a
meaningless negative count; the port reports the packets it finds.
"""

from __future__ import annotations

import math
import struct
import zlib
from fractions import Fraction
from typing import List, Optional, Tuple

from yololite_tpu_torch.data import esparse

EBML, SEGMENT, CLUSTER = 0x1A45DFA3, 0x18538067, 0x1F43B675
INFO, TRACKS, TRACK_ENTRY, CUES, SEEK_HEAD = 0x1549A966, 0x1654AE6B, 0xAE, 0x1C53BB6B, 0x114D9B74
TOP_LEVEL = {SEEK_HEAD, INFO, TRACKS, CLUSTER, CUES, 0x1043A770, 0x1254C367, 0x1941A469, SEGMENT,
             EBML}                                  # + Chapters, Tags, Attachments
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, BLOCK_DURATION, TIMESTAMP = 0xA3, 0xA0, 0xA1, 0x9B, 0xE7
VIDEO_CODECS = {"V_MPEG4/ISO/AVC": "h264", "V_MPEGH/ISO/HEVC": "hevc", "V_MPEG4/ISO/SP": "mp4v",
                "V_MPEG4/ISO/ASP": "mp4v", "V_MPEG4/ISO/AP": "mp4v", "V_MJPEG": "mjpeg"}
NAMED_CODECS = {"V_VP8": "VP8", "V_VP9": "VP9", "V_AV1": "AV1", "V_MPEG1": "MPEG-1 video",
                "V_MPEG2": "MPEG-2 video", "V_THEORA": "Theora", "V_PRORES": "ProRes",
                "V_DIRAC": "Dirac", "V_FFV1": "FFV1", "V_UNCOMPRESSED": "uncompressed video",
                "V_MPEGI/ISO/VVC": "H.266/VVC", "V_QUICKTIME": "QuickTime video",
                "V_MPEG4/MS/V3": "MS-MPEG4 v3"}
UNKNOWN = -1
READ = 1 << 20
INFLATE_LIMIT = 10000000        # FFmpeg's matroska_decode_buffer grows its buffer to this


def inflate(data: bytes) -> bytes:
    """A zlib-compressed frame, inflated as FFmpeg's matroska demuxer
    inflates it: into a buffer that grows threefold from the frame's size
    until it holds INFLATE_LIMIT bytes or more, and no further. A frame that
    is empty or does not end within that buffer raises `ValueError`."""
    if not data:
        raise ValueError("empty zlib-compressed Matroska frame")
    cap = 3 * len(data)
    while cap < INFLATE_LIMIT:
        cap *= 3
    z = zlib.decompressobj()
    try:
        out = z.decompress(data, cap)
    except zlib.error as e:
        raise ValueError(f"zlib-compressed Matroska frame does not inflate: {e}") from e
    if not z.eof:
        raise ValueError(f"zlib-compressed Matroska frame does not end within {cap} bytes")
    return out


def _vint(b: bytes, i: int, marker: bool):
    """(value, length) of the variable-length integer at b[i] (an element
    ID keeps its length marker); value UNKNOWN for a size of all ones."""
    if i >= len(b):
        raise EOFError
    x = b[i]
    n = 1
    while n <= 8 and not x & (0x80 >> (n - 1)):
        n += 1
    if n > 8 or i + n > len(b) or (marker and n > 4):
        raise ValueError("invalid EBML variable-length integer")
    v = x if marker else x & ((0x80 >> (n - 1)) - 1)
    ones = v == (0x80 >> (n - 1)) - 1
    for k in range(1, n):
        v = (v << 8) | b[i + k]
        ones &= b[i + k] == 0xFF
    return (UNKNOWN if ones and not marker else v), n


def _uint(b: bytes) -> int:
    return int.from_bytes(b, "big") if b else 0


def _float(b: bytes) -> float:
    if len(b) == 4:
        return struct.unpack(">f", b)[0]
    if len(b) == 8:
        return struct.unpack(">d", b)[0]
    return 0.0


class _File:
    """Buffered reads of a file, with its size."""

    def __init__(self, f, size: int):
        self.f, self.size = f, size
        self.base, self.buf = 0, b""

    def at(self, off: int, n: int) -> bytes:
        if not 0 <= off < self.size:
            return b""
        if off < self.base or off + n > self.base + len(self.buf):
            self.f.seek(off)
            self.buf, self.base = self.f.read(max(n, READ)), off
        i = off - self.base
        return self.buf[i:i + n]

    def header(self, off: int):
        """(id, size or UNKNOWN, body offset) of the element at off."""
        head = self.at(off, 12)
        eid, n1 = _vint(head, 0, True)
        size, n2 = _vint(head, n1, False)
        return eid, size, off + n1 + n2


def _children(b: bytes, i: int, end: int):
    """(id, body) of each element in b[i:end] (an element held in memory)."""
    while i < end:
        eid, n1 = _vint(b, i, True)
        size, n2 = _vint(b, i + n1, False)
        s = i + n1 + n2
        if size == UNKNOWN or s + size > end:
            return
        yield eid, b[s:s + size]
        i = s + size


class _Encoding:
    """A track's ContentEncoding: what it applies to and how."""

    def __init__(self, body: bytes):
        self.scope, self.kind, self.algo, self.settings = 1, 0, 0, b""
        self.encrypted = False
        for eid, b in _children(body, 0, len(body)):
            if eid == 0x5032:
                self.scope = _uint(b)
            elif eid == 0x5033:
                self.kind = _uint(b)
            elif eid == 0x5034:
                for cid, cb in _children(b, 0, len(b)):
                    if cid == 0x4254:
                        self.algo = _uint(cb)
                    elif cid == 0x4255:
                        self.settings = bytes(cb)
            elif eid == 0x5035:
                self.encrypted = True

    def check(self) -> None:
        from yololite_tpu_torch.data.video import unsupported
        if self.kind == 1 or self.encrypted:
            raise unsupported("encrypted Matroska content")
        if self.kind == 0 and self.algo not in (0, 3):
            name = {1: "bzlib", 2: "LZO"}.get(self.algo, f"algorithm {self.algo}")
            raise unsupported(f"Matroska content compressed with {name}")

    def apply(self, data: bytes) -> bytes:
        return self.settings + data if self.algo == 3 else inflate(data)


class _Track:
    """A TrackEntry's fields."""

    def __init__(self, body: bytes):
        self.number, self.kind, self.codec_id, self.private = 0, 0, "", b""
        self.default_duration, self.width, self.height = 0, 0, 0
        self.encodings: List[_Encoding] = []
        for eid, b in _children(body, 0, len(body)):
            if eid == 0xD7:
                self.number = _uint(b)
            elif eid == 0x83:
                self.kind = _uint(b)
            elif eid == 0x86:
                self.codec_id = bytes(b).split(b"\x00")[0].decode("latin1")
            elif eid == 0x63A2:
                self.private = bytes(b)
            elif eid == 0x23E383:
                self.default_duration = _uint(b)
            elif eid == 0xE0:
                for vid, vb in _children(b, 0, len(b)):
                    if vid == 0xB0:
                        self.width = _uint(vb)
                    elif vid == 0xBA:
                        self.height = _uint(vb)
            elif eid == 0x6D80:
                self.encodings = [_Encoding(eb) for cid, eb in _children(b, 0, len(b))
                                  if cid == 0x6240]


class Demuxed:
    """What `demux` finds: the codec, its size, the extradata, each
    packet as a `video.Sample` of the file, fps and frame_count as cv2
    reports them."""

    def __init__(self):
        self.codec, self.tag, self.width, self.height = "", b"", 0, 0   # tag: a VFW FourCC
        self.extradata = b""
        self.samples: list = []
        self.fps, self.frame_count = 0.0, 0


def _walk(rd: _File, start: int, end: int, blocks: list, meta: dict) -> None:
    """The Segment's elements in [start, end): Info and Tracks into
    `meta`, each block's (track, timestamp, body offset, body size,
    BlockDuration or None) into `blocks`. A Cluster of unknown size ends
    at the next top-level element; the walk stops at the first element
    cut short by the end of the file."""
    pos = start
    while pos < end:
        try:
            eid, size, body = rd.header(pos)
        except (EOFError, ValueError):
            return
        if eid == CLUSTER:
            pos = _cluster(rd, body, size, end, blocks)
            if pos is None:
                return
            continue
        if size == UNKNOWN:
            if eid == SEGMENT:          # a second Segment: FFmpeg reads the first
                return
            pos = body
            continue
        if body + size > rd.size:
            return
        if eid in (INFO, TRACKS):
            data = rd.at(body, size)
            if eid == INFO:
                for cid, b in _children(data, 0, len(data)):
                    if cid == 0x2AD7B1:
                        meta["scale"] = _uint(b) or 1000000
                    elif cid == 0x4489:
                        meta["duration"] = _float(b)
            elif "tracks" not in meta:
                meta["tracks"] = [_Track(b) for cid, b in _children(data, 0, len(data))
                                  if cid == TRACK_ENTRY]
        pos = body + size


def _cluster(rd: _File, body: int, size: int, end: int, blocks: list) -> Optional[int]:
    """Reads one Cluster's blocks; the offset after it, None where the file
    ends inside it."""
    stop = end if size == UNKNOWN else min(body + size, end)
    base, pos = 0, body
    while pos < stop:
        try:
            eid, esize, ebody = rd.header(pos)
        except (EOFError, ValueError):
            return None
        if size == UNKNOWN and eid in TOP_LEVEL:
            return pos
        if esize == UNKNOWN or ebody + esize > rd.size:
            return None
        if eid == TIMESTAMP:
            base = _uint(rd.at(ebody, esize))
        elif eid == SIMPLE_BLOCK:
            _block(rd, ebody, esize, base, None, blocks)
        elif eid == BLOCK_GROUP:
            group = rd.at(ebody, esize)
            inner, duration, i = None, None, 0
            while i < len(group):
                try:
                    gid, n1 = _vint(group, i, True)
                    gsize, n2 = _vint(group, i + n1, False)
                except (EOFError, ValueError):
                    break
                if gsize == UNKNOWN or i + n1 + n2 + gsize > len(group):
                    break
                if gid == BLOCK:
                    inner = (ebody + i + n1 + n2, gsize)
                elif gid == BLOCK_DURATION:
                    duration = _uint(group[i + n1 + n2:i + n1 + n2 + gsize])
                i += n1 + n2 + gsize
            if inner:
                _block(rd, inner[0], inner[1], base, duration, blocks)
        pos = ebody + esize
    return stop if size != UNKNOWN else pos


def _block(rd: _File, body: int, size: int, base: int, duration, blocks: list) -> None:
    head = rd.at(body, min(size, 12))
    try:
        track, n = _vint(head, 0, False)
    except (EOFError, ValueError):
        return
    if n + 3 > size:
        return
    rel = struct.unpack(">h", head[n:n + 2])[0]
    blocks.append((track, base + rel, body + n + 2, size - n - 2, duration))


def _laces(rd: _File, off: int, size: int) -> List[Tuple[int, int]]:
    """(offset, size) of each frame of a block's data (flags byte first),
    as FFmpeg's matroska_parse_laces cuts them; [] where the lacing does
    not parse (FFmpeg drops the block)."""
    flags = rd.at(off, 1)[0]
    kind = (flags >> 1) & 3
    off, size = off + 1, size - 1
    if not kind:
        return [(off, size)]
    if size <= 0:
        return []
    head = rd.at(off, min(size, 8 * 256 + 1))
    count, i = head[0] + 1, 1
    sizes: List[int] = []
    if kind == 1:
        total = 0
        for _ in range(count - 1):
            n = 0
            while True:
                if i >= len(head) or size - i <= total:
                    return []
                t = head[i]
                i += 1
                n += t
                total += t
                if t != 0xFF:
                    break
            sizes.append(n)
        if size - i < total:
            return []
        sizes.append(size - i - total)
    elif kind == 2:
        if (size - 1) % count:
            return []
        sizes = [(size - 1) // count] * count
    else:
        try:
            first, n = _vint(head, i, False)
        except (EOFError, ValueError):
            return []
        i += n
        sizes = [first]
        for _ in range(count - 2):
            try:
                raw, n = _vint(head, i, False)
            except (EOFError, ValueError):
                return []
            i += n
            sizes.append(sizes[-1] + raw - ((1 << (7 * n - 1)) - 1))
        if first == UNKNOWN or any(s < 0 for s in sizes) or size - i < sum(sizes):
            return []
        sizes.append(size - i - sum(sizes))
    out, p = [], off + i
    for n in sizes:
        out.append((p, n))
        p += n
    return out


def demux(f, file_size: int) -> Demuxed:
    """The first video track of a Matroska/WebM file (`Demuxed`). A codec or
    content encoding this package does not read raises `UnsupportedVideo`."""
    from yololite_tpu_torch.data.video import Sample, unsupported
    rd = _File(f, file_size)
    eid, size, body = rd.header(0)
    if eid != EBML or size == UNKNOWN:
        raise ValueError("no EBML header")
    pos = body + size
    while True:
        try:
            eid, size, body = rd.header(pos)
        except (EOFError, ValueError) as e:
            raise ValueError("Matroska without a Segment") from e
        if eid == SEGMENT:
            break
        if size == UNKNOWN:
            raise ValueError("Matroska without a Segment")
        pos = body + size
    end = file_size if size == UNKNOWN else min(body + size, file_size)
    blocks: list = []
    meta: dict = {}
    _walk(rd, body, end, blocks, meta)
    track = next((t for t in meta.get("tracks", []) if t.kind == 1), None)
    if track is None:
        raise ValueError("Matroska without a video track")
    cid = track.codec_id
    out = Demuxed()
    out.width, out.height = track.width, track.height
    if cid == "V_MS/VFW/FOURCC":
        if len(track.private) < 40:
            raise ValueError("V_MS/VFW/FOURCC without a BITMAPINFOHEADER")
        out.tag = track.private[16:20]
        from yololite_tpu_torch.data.video import _codec_of
        out.codec = _codec_of(out.tag)
        private = track.private[40:]
    elif cid in VIDEO_CODECS:
        out.codec, private = VIDEO_CODECS[cid], track.private
    elif cid in NAMED_CODECS or cid.startswith("V_REAL/"):
        raise unsupported(f"{NAMED_CODECS.get(cid, 'RealVideo')} ({cid!r}) in Matroska")
    else:
        raise unsupported(f"the Matroska codec {cid!r}")
    if len(track.encodings) > 1:
        raise unsupported("Matroska content with several combined encodings")
    enc = track.encodings[0] if track.encodings else None
    if enc is not None:
        enc.check()
        if enc.scope & 2 and private:
            private = enc.apply(private)
        if not enc.scope & 1:
            enc = None
    out.extradata = private
    mine = [b for b in blocks if b[0] == track.number]
    durations, ticks = [], []
    scale = meta.get("scale", 1000000)
    tb = Fraction(scale, 10 ** 9)
    for k, (_, ts, off, size, duration) in enumerate(mine):
        frames = _laces(rd, off, size)
        prefix = enc.settings if enc is not None and enc.algo == 3 else b""
        packed = enc is not None and enc.algo == 0
        out.samples += [Sample(fo, fs, prefix, packed) for fo, fs in frames]
        if k < esparse.ANALYZED:
            d = duration // len(frames) if duration and frames else 0
            durations += [d] * len(frames)
            ticks.append(ts)
    if track.default_duration:
        fps = esparse.reduce(10 ** 9, track.default_duration, 30000)
    else:
        dur = esparse.frame_duration(_codec_rate(out, private), tb)
        durations = [d or dur for d in durations]
        fps = esparse.avg_rate(durations, sorted(ticks), tb)
    out.fps = float(fps)
    if "duration" in meta and fps:
        us = int(meta["duration"] * scale * 1000 / 10 ** 6)
        out.frame_count = esparse.frame_count(us / 1e6, out.fps)
    else:
        out.frame_count = len(out.samples)
    return out


def _codec_rate(out: Demuxed, private: bytes) -> Optional[Fraction]:
    """The codec's own frame rate, as FFmpeg's parser sets it: from the VOL
    (MPEG-4 Part 2) or the SPS/VPS of the configuration record (H.264,
    HEVC); None otherwise."""
    from yololite_tpu_torch.data.video import _avcc, _hvcc
    if out.codec == "mp4v":
        return esparse.codec_rate("mp4v", private)
    if out.codec not in ("h264", "hevc") or out.tag:
        return None
    try:
        ps = _avcc(private)[1] if out.codec == "h264" else _hvcc(private)[1]
    except (ValueError, IndexError):
        return None
    return esparse.codec_rate(out.codec, b"".join(ps))


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #

def _id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _size(n: int, width: int = 0) -> bytes:
    width = width or next(k for k in range(1, 9) if n < (1 << (7 * k)) - 1)
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def element(eid: int, body: bytes) -> bytes:
    return _id(eid) + _size(len(body)) + body


def uint_element(eid: int, v: int) -> bytes:
    return element(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def cv2_rate(fps: float) -> Fraction:
    """The frame rate as cv2.VideoWriter gives it to FFmpeg: a whole number
    over a power of ten within 0.001 of `fps`."""
    base = 1
    num = int(fps + 0.5)
    while abs(num / base - fps) > 0.001:
        base *= 10
        num = int(fps * base + 0.5)
    return Fraction(num, base)


CLUSTER_MS = 5000         # FFmpeg's matroska muxer starts a cluster every 5 s


class MkvMuxer:
    """MPEG-4 Part 2 frames in a Matroska file as FFmpeg's matroska muxer
    writes cv2.VideoWriter's `.mkv`: codec ID `V_MPEG4/ISO/ASP` with the
    VOL as `CodecPrivate`, `DefaultDuration` of cv2's rate, millisecond
    timestamps, every frame a key frame in a `SimpleBlock`, a Cluster every
    5 s; the Segment's size and Info's `Duration` are written by `close`
    (no Cues: nothing here seeks)."""

    def __init__(self, path: str, size, fps: float, extradata: bytes):
        self.rate = cv2_rate(fps)
        self.f = open(path, "wb")
        w, h = size
        header = element(EBML, uint_element(0x4286, 1) + uint_element(0x42F7, 1)
                         + uint_element(0x42F2, 4) + uint_element(0x42F3, 8)
                         + element(0x4282, b"matroska") + uint_element(0x4287, 4)
                         + uint_element(0x4285, 2))
        self.f.write(header + _id(SEGMENT) + _size(0, 8))
        self.segment = self.f.tell()
        app = b"yololite_tpu_torch"
        info = (uint_element(0x2AD7B1, 1000000) + element(0x4D80, app) + element(0x5741, app)
                + element(0x4489, struct.pack(">d", 0.0)))
        self.f.write(element(INFO, info))
        self.duration_at = self.f.tell() - 8
        entry = (uint_element(0xD7, 1) + uint_element(0x73C5, 1) + uint_element(0x9C, 0)
                 + element(0x22B59C, b"und") + element(0x86, b"V_MPEG4/ISO/ASP")
                 + uint_element(0x83, 1)
                 + uint_element(0x23E383, int(10 ** 9 / float(self.rate)))
                 + element(0xE0, uint_element(0xB0, w) + uint_element(0xBA, h))
                 + element(0x63A2, extradata))
        self.f.write(element(TRACKS, element(TRACK_ENTRY, entry)))
        self.n, self.cluster = 0, None
        self.end_ms = 0

    def _ms(self, k: int) -> int:
        """Frame k's time in ms, rounded as av_rescale_q rounds."""
        t = Fraction(k) / self.rate * 1000
        return math.floor(t + Fraction(1, 2))

    def write(self, frame: bytes) -> None:
        t = self._ms(self.n)
        if self.cluster is None or t - self.cluster[1] >= CLUSTER_MS:
            self._close_cluster()
            self.cluster = (self.f.tell(), t)
            self.f.write(_id(CLUSTER) + _size(0, 8) + uint_element(TIMESTAMP, t))
        block = b"\x81" + struct.pack(">hB", t - self.cluster[1], 0x80) + frame
        self.f.write(element(SIMPLE_BLOCK, block))
        self.n += 1
        self.end_ms = self._ms(self.n)

    def _close_cluster(self) -> None:
        if self.cluster is None:
            return
        start = self.cluster[0]
        end = self.f.tell()
        self.f.seek(start + 4)
        self.f.write(_size(end - start - 12, 8))
        self.f.seek(end)
        self.cluster = None

    def close(self) -> None:
        if self.f is None:
            return
        self._close_cluster()
        end = self.f.tell()
        self.f.seek(self.segment - 8)
        self.f.write(_size(end - self.segment, 8))
        self.f.seek(self.duration_at)
        self.f.write(struct.pack(">d", float(self.end_ms)))
        self.f.close()
        self.f = None
