"""H.264 clips for the port's decoder: an x264 encoder driven through ctypes
(the system's FFmpeg 5.1 `libavcodec.so.59` with `libx264`), MP4/MOV and AVI
muxers, and the committed fixtures under tests/data/video/h264/ with their
manifest (cv2.VideoCapture's fps, frame count and size, the SHA-256 of each
raw packet with `CAP_PROP_FORMAT = -1` and of each decoded BGR frame).

    python tests/h264_fixtures.py

x264 runs with `threads=1`, yet its bytes are not the same on every run:
a clip encoded after other clips, or in another process, can differ (this
libx264 reads memory whose contents depend on what the process did
before). So a remade set differs in bytes; `main` rewrites the manifest
from the files it wrote, and the tests hold the decoder to cv2 on whatever
x264 wrote. No header of FFmpeg is needed: the codec context takes its
options by name (`av_opt_set`, x264's own through `x264-params`), and the
few fields set
directly sit at FFmpeg 5.1's offsets (`AVFrame`: data 0, linesize 64, width
104, height 108, format 116, pts 136; `AVPacket`: pts 8, dts 16, data 24,
size 32, flags 40; `AVCodecContext`: flags 76, extradata 88/96, time_base
100, width 116, height 120, pix_fmt 136).

The MP4 writer lays boxes out as FFmpeg 5.1's mov muxer does for H.264:
`avc1` (or `avc3`) with `avcC`, 4-byte NAL lengths, `stts`, `ctts` where
pictures are reordered, `stss`, and `edts/elst` starting at the first
picture's composition time; `mov_mux` writes one file through the system's
`libavformat.so.59` itself. The AVI writer stores Annex B access units
under FourCC `H264`.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import struct
import sys
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from video_fixtures import cv2_read, faststart, scene as _scene, sha  # noqa: E402

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video", "h264")

PIX_FMTS = {"yuv420p": 0, "yuv422p": 4, "yuv444p": 5, "yuv420p10le": 62}
_SEARCH_CHILDREN = 1
_GLOBAL_HEADER = 1 << 22
_EAGAIN, _EOF = -11, -541478725

_AV = None


def available() -> bool:
    """Whether the system's libavcodec 59 with libx264 can be loaded."""
    try:
        _libs()
    except OSError:
        return False
    return True


def _libs():
    global _AV
    if _AV is None:
        util = ctypes.CDLL("libavutil.so.57")
        codec = ctypes.CDLL("libavcodec.so.59")
        p = ctypes.c_void_p
        codec.avcodec_find_encoder_by_name.restype = p
        codec.avcodec_alloc_context3.restype = p
        codec.avcodec_alloc_context3.argtypes = [p]
        codec.avcodec_open2.argtypes = [p, p, p]
        codec.avcodec_send_frame.argtypes = [p, p]
        codec.avcodec_receive_packet.argtypes = [p, p]
        codec.av_packet_alloc.restype = p
        codec.av_packet_unref.argtypes = [p]
        codec.avcodec_free_context.argtypes = [ctypes.POINTER(p)]
        codec.av_packet_free.argtypes = [ctypes.POINTER(p)]
        util.av_opt_set.argtypes = [p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        util.av_frame_alloc.restype = p
        util.av_frame_get_buffer.argtypes = [p, ctypes.c_int]
        util.av_frame_make_writable.argtypes = [p]
        util.av_frame_free.argtypes = [ctypes.POINTER(p)]
        util.av_log_set_level.argtypes = [ctypes.c_int]
        util.av_log_set_level(16)            # errors only
        _AV = (util, codec)
    return _AV


def _i32(addr: int, off: int):
    return ctypes.c_int32.from_address(addr + off)


def _i64(addr: int, off: int):
    return ctypes.c_int64.from_address(addr + off)


def _ptr(addr: int, off: int):
    return ctypes.c_void_p.from_address(addr + off)


def yuv420(frame_bgr: np.ndarray) -> List[np.ndarray]:
    """cv2's BGR -> I420 planes (even sizes)."""
    import cv2
    h, w = frame_bgr.shape[:2]
    i420 = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2YUV_I420).ravel()
    y = i420[:w * h].reshape(h, w)
    u = i420[w * h:w * h * 5 // 4].reshape(h // 2, w // 2)
    v = i420[w * h * 5 // 4:].reshape(h // 2, w // 2)
    return [y, u, v]


def planes_for(frame_bgr: np.ndarray, pix_fmt: str) -> List[np.ndarray]:
    """The planes of a BGR frame in pix_fmt (4:2:2 and 4:4:4 from the I420
    chroma repeated, 10-bit as the 8-bit samples times 4)."""
    y, u, v = yuv420(frame_bgr)
    if pix_fmt == "yuv420p":
        return [y, u, v]
    if pix_fmt == "yuv422p":
        return [y, np.repeat(u, 2, 0), np.repeat(v, 2, 0)]
    if pix_fmt == "yuv444p":
        return [y] + [np.repeat(np.repeat(c, 2, 0), 2, 1) for c in (u, v)]
    if pix_fmt == "yuv420p10le":
        return [p.astype(np.uint16) * 4 for p in (y, u, v)]
    raise ValueError(pix_fmt)


class Packet:
    __slots__ = ("data", "pts", "dts", "key")

    def __init__(self, data: bytes, pts: int, dts: int, key: bool):
        self.data, self.pts, self.dts, self.key = data, pts, dts, key


class Stream:
    """An encoded stream: Annex B packets in decoding order, the parameter
    sets (`extradata`, Annex B) and the frame rate as a time base."""

    def __init__(self, packets: List[Packet], extradata: bytes, rate: Fraction, size):
        self.packets, self.extradata, self.rate, self.size = packets, extradata, rate, size


def encode(frames: Sequence[np.ndarray], params: str = "", profile: Optional[str] = None,
           fps: Fraction = Fraction(25), pix_fmt: str = "yuv420p",
           options: Optional[dict] = None) -> Stream:
    """Encode BGR frames with libx264 (`threads=1`). `params` is x264's
    `-x264-params` string; `options` further AVOptions of the encoder
    (`crf`, `qp`, `tune`, ...). The SPS/PPS go to the extradata (the global
    header a muxer for MP4 asks for), and into the packets too with x264's
    `repeat-headers=1`."""
    util, codec = _libs()
    enc = codec.avcodec_find_encoder_by_name(b"libx264")
    if not enc:
        raise OSError("libavcodec has no libx264 encoder")
    ctx = codec.avcodec_alloc_context3(enc)
    h, w = frames[0].shape[:2]
    fps = Fraction(fps)
    _i32(ctx, 116).value, _i32(ctx, 120).value = w, h
    _i32(ctx, 136).value = PIX_FMTS[pix_fmt]
    _i32(ctx, 100).value, _i32(ctx, 104).value = fps.denominator, fps.numerator   # time_base
    _i32(ctx, 712).value, _i32(ctx, 716).value = fps.numerator, fps.denominator   # framerate
    _i32(ctx, 76).value |= _GLOBAL_HEADER
    opts = {"threads": "1", "preset": "medium"}
    if profile:
        opts["profile"] = profile
    opts.update(options or {})
    x264 = "threads=1" + (":" + params if params else "")
    opts["x264-params"] = x264
    for k, v in opts.items():
        if util.av_opt_set(ctx, k.encode(), str(v).encode(), _SEARCH_CHILDREN) < 0:
            raise ValueError(f"libx264 option {k}={v} refused")
    if codec.avcodec_open2(ctx, enc, None) < 0:
        raise ValueError(f"libx264 did not open with {opts}")
    ext = _ptr(ctx, 88).value
    extradata = ctypes.string_at(ext, _i32(ctx, 96).value) if ext else b""
    frame = util.av_frame_alloc()
    pkt = codec.av_packet_alloc()
    _i32(frame, 104).value, _i32(frame, 108).value = w, h
    _i32(frame, 116).value = PIX_FMTS[pix_fmt]
    if util.av_frame_get_buffer(frame, 0) < 0:
        raise MemoryError("av_frame_get_buffer")
    out: List[Packet] = []

    def drain():
        while True:
            r = codec.avcodec_receive_packet(ctx, pkt)
            if r in (_EAGAIN, _EOF):
                return
            if r < 0:
                raise ValueError(f"avcodec_receive_packet: {r}")
            data = ctypes.string_at(_ptr(pkt, 24).value, _i32(pkt, 32).value)
            out.append(Packet(data, _i64(pkt, 8).value, _i64(pkt, 16).value,
                              bool(_i32(pkt, 40).value & 1)))
            codec.av_packet_unref(pkt)

    for t, img in enumerate(frames):
        util.av_frame_make_writable(frame)
        for i, plane in enumerate(planes_for(img, pix_fmt)):
            ls = _i32(frame, 64 + 4 * i).value
            base = _ptr(frame, 8 * i).value
            raw = np.ascontiguousarray(plane).view(np.uint8).reshape(plane.shape[0], -1)
            for r in range(raw.shape[0]):
                ctypes.memmove(base + r * ls, raw[r].ctypes.data, raw.shape[1])
        _i64(frame, 136).value = t
        if codec.avcodec_send_frame(ctx, frame) < 0:
            raise ValueError("avcodec_send_frame")
        drain()
    codec.avcodec_send_frame(ctx, None)
    drain()
    f = ctypes.c_void_p(frame)
    util.av_frame_free(ctypes.byref(f))
    p = ctypes.c_void_p(pkt)
    codec.av_packet_free(ctypes.byref(p))
    c = ctypes.c_void_p(ctx)
    codec.avcodec_free_context(ctypes.byref(c))
    return Stream(out, extradata, fps, (w, h))


# --------------------------------------------------------------------------- #
# NAL units
# --------------------------------------------------------------------------- #

def nal_units(annexb: bytes) -> List[bytes]:
    """The NAL units of an Annex B byte stream (start codes and the zero
    bytes before them stripped)."""
    out, i, n = [], 0, len(annexb)
    starts = []
    while True:
        j = annexb.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        while e > s and annexb[e - 1] == 0:
            e -= 1
        out.append(annexb[s:e])
    return out


def avcc(sps: List[bytes], pps: List[bytes]) -> bytes:
    """The AVCDecoderConfigurationRecord of the parameter sets (4-byte NAL
    lengths), as FFmpeg's `ff_isom_write_avcc` writes it."""
    s0 = sps[0]
    out = bytes([1, s0[1], s0[2], s0[3], 0xFF, 0xE0 | len(sps)])
    for s in sps:
        out += struct.pack(">H", len(s)) + s
    out += bytes([len(pps)])
    for p in pps:
        out += struct.pack(">H", len(p)) + p
    if s0[1] in (100, 110, 122, 144):
        out += bytes([0xFC | 1, 0xF8, 0xF8, 0])      # chroma 4:2:0, 8-bit, no SPS ext
    return out


def length_prefixed(annexb: bytes, size: int = 4) -> bytes:
    return b"".join(len(n).to_bytes(size, "big") + n for n in nal_units(annexb))


# --------------------------------------------------------------------------- #
# muxers
# --------------------------------------------------------------------------- #

def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def write_mp4(path: str, stream: Stream, sample_entry: bytes = b"avc1", trim: int = 0) -> None:
    """The stream as one H.264 track in an MP4/MOV (FFmpeg 5.1's mov muxer's
    layout; parameter sets that the packets carry stay in them, as `avc3`
    wants). `trim` frames are cut from the start by the edit list (its media
    time starts `trim` frames after the first picture's composition time),
    as phone editors trim without re-encoding."""
    nals = nal_units(stream.extradata)
    sps = [n for n in nals if n[0] & 0x1F == 7]
    pps = [n for n in nals if n[0] & 0x1F == 8]
    rate = stream.rate
    ts = rate.numerator * (1 if rate.denominator > 1 else 512)    # FFmpeg's track timescale
    per = ts * rate.denominator // rate.numerator
    w, h = stream.size
    pk = stream.packets
    first_dts = pk[0].dts
    samples = [length_prefixed(p.data) for p in pk]
    dts = [(p.dts - first_dts) * per for p in pk]
    cts = [(p.pts - p.dts) * per for p in pk]
    n = len(pk)
    # composition time of the first picture in presentation order
    start_ct = min(d + c for d, c in zip(dts, cts))
    dur = n * per
    mov = path.lower().endswith(".mov")
    brand = (b"qt  ", 0x200, b"qt  ") if mov else (b"isom", 0x200, b"isomiso2avc1mp41")
    ftyp = _box(b"ftyp", brand[0], struct.pack(">I", brand[1]), brand[2])
    mdat_body = b"".join(samples)
    head = ftyp + _box(b"free")
    offsets, o = [], len(head) + 8
    for s in samples:
        offsets.append(o)
        o += len(s)
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    edit_dur_media = dur - trim * per
    edit_ms = -(-edit_dur_media * 1000 // ts)          # rounded up, as FFmpeg rounds it
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, edit_ms),
                 struct.pack(">IH10x", 0x10000, 0x100), matrix, b"\x00" * 24,
                 struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, edit_ms),
                 b"\x00" * 8, struct.pack(">hhHH", 0, 0, 0, 0), matrix,
                 struct.pack(">II", w << 16, h << 16))
    elst = _full(b"elst", 0, 0, struct.pack(">IIiI", 1, edit_ms,
                                             start_ct + trim * per, 0x10000))
    edts = _box(b"edts", elst)
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, ts, dur, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"VideoHandler\x00")
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
    entry = _box(sample_entry, b"\x00" * 6, struct.pack(">H", 1), b"\x00" * 16,
                 struct.pack(">HHIII", w, h, 0x480000, 0x480000, 0), struct.pack(">H", 1),
                 b"\x00" * 32, struct.pack(">Hh", 24, -1), _box(b"avcC", avcc(sps, pps)))
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, per))
    keys = [i + 1 for i, p in enumerate(pk) if p.key]
    stss = _full(b"stss", 0, 0, struct.pack(">I", len(keys)), struct.pack(f">{len(keys)}I", *keys))
    parts = [stsd, stts]
    if len(keys) < n:
        parts.append(stss)
    if any(cts):
        runs = []
        for c in cts:
            if runs and runs[-1][1] == c:
                runs[-1][0] += 1
            else:
                runs.append([1, c])
        parts.append(_full(b"ctts", 0, 0, struct.pack(">I", len(runs)),
                           b"".join(struct.pack(">II", a, b) for a, b in runs)))
    parts.append(_full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)))
    parts.append(_full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                       struct.pack(f">{n}I", *[len(s) for s in samples])))
    parts.append(_full(b"stco", 0, 0, struct.pack(">II", 1, offsets[0])))
    stbl = _box(b"stbl", *parts)
    minf = _box(b"minf", _full(b"vmhd", 0, 1, b"\x00" * 8), dinf, stbl)
    trak = _box(b"trak", tkhd, edts, _box(b"mdia", mdhd, hdlr, minf))
    with open(path, "wb") as f:
        f.write(head + _box(b"mdat", mdat_body) + _box(b"moov", mvhd, trak))


def mov_mux(path: str, stream: Stream) -> None:
    """The stream muxed by the system's libavformat 59 (FFmpeg 5.1's mov
    muxer itself; `.mov` or `.mp4` by the name), the packets' pts and dts
    as the encoder gave them, in the frame rate's time base.
    `AVCodecParameters`: codec_type 0, codec_id 4, extradata 16/24, width
    56, height 60; `AVStream.time_base` 16; `AVFormatContext.pb` 32."""
    util, codec = _libs()
    fmt = ctypes.CDLL("libavformat.so.59")
    p = ctypes.c_void_p
    fmt.avformat_alloc_output_context2.argtypes = [ctypes.POINTER(p), p, p, ctypes.c_char_p]
    fmt.avformat_new_stream.argtypes = [p, p]
    fmt.avformat_new_stream.restype = p
    fmt.avio_open.argtypes = [p, ctypes.c_char_p, ctypes.c_int]
    fmt.avformat_write_header.argtypes = [p, p]
    fmt.av_interleaved_write_frame.argtypes = [p, p]
    fmt.av_write_trailer.argtypes = [p]
    fmt.avio_closep.argtypes = [p]
    fmt.avformat_free_context.argtypes = [p]
    util.av_malloc.argtypes = [ctypes.c_size_t]
    util.av_malloc.restype = p
    codec.av_new_packet.argtypes = [p, ctypes.c_int]
    ctx = p()
    if fmt.avformat_alloc_output_context2(ctypes.byref(ctx), None, None, path.encode()) < 0:
        raise OSError(f"libavformat has no muxer for {path}")
    ctx = ctx.value
    st = fmt.avformat_new_stream(ctx, None)
    par = _ptr(st, 208).value
    w, h = stream.size
    _i32(par, 0).value, _i32(par, 4).value = 0, 27            # video, H.264
    _i32(par, 56).value, _i32(par, 60).value = w, h
    ext = util.av_malloc(len(stream.extradata) + 64)
    ctypes.memset(ext, 0, len(stream.extradata) + 64)
    ctypes.memmove(ext, stream.extradata, len(stream.extradata))
    _ptr(par, 16).value = ext
    _i32(par, 24).value = len(stream.extradata)
    _i32(st, 16).value, _i32(st, 20).value = stream.rate.denominator, stream.rate.numerator
    if fmt.avio_open(ctx + 32, path.encode(), 2) < 0:
        raise OSError(f"cannot write {path}")
    if fmt.avformat_write_header(ctx, None) < 0:
        raise ValueError("avformat_write_header")
    # the muxer picks its own time base; ticks of it per frame
    per = Fraction(_i32(st, 20).value, _i32(st, 16).value) / stream.rate
    if per.denominator != 1:
        raise ValueError(f"frame rate {stream.rate} is not a whole number of muxer ticks")
    per = per.numerator
    pkt = codec.av_packet_alloc()
    for q in stream.packets:
        codec.av_new_packet(pkt, len(q.data))
        ctypes.memmove(_ptr(pkt, 24).value, q.data, len(q.data))
        _i64(pkt, 8).value, _i64(pkt, 16).value = q.pts * per, q.dts * per
        _i32(pkt, 40).value = 1 if q.key else 0
        _i64(pkt, 64).value = per
        _i32(pkt, 36).value = 0
        if fmt.av_interleaved_write_frame(ctx, pkt) < 0:
            raise ValueError("av_interleaved_write_frame")
    fmt.av_write_trailer(ctx)
    fmt.avio_closep(ctx + 32)
    fmt.avformat_free_context(ctx)
    q = ctypes.c_void_p(pkt)
    codec.av_packet_free(ctypes.byref(q))


def write_avi(path: str, stream: Stream, fourcc: bytes = b"H264") -> None:
    """The stream in an AVI: Annex B access units as `00dc` chunks (the
    parameter sets before the first), an `idx1` index."""
    w, h = stream.size
    rate = stream.rate
    chunks = [p.data for p in stream.packets]
    chunks[0] = stream.extradata + chunks[0]
    movi, idx, off = b"", b"", 4
    for p, c in zip(stream.packets, chunks):
        idx += struct.pack("<4sIII", b"00dc", 0x10 if p.key else 0, off, len(c))
        body = struct.pack("<4sI", b"00dc", len(c)) + c + (b"\x00" if len(c) & 1 else b"")
        movi += body
        off += len(body)
    n = len(chunks)
    avih = struct.pack("<14I", round(1e6 * rate.denominator / rate.numerator), 0, 0, 0x10, n, 0,
                       1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, rate.denominator,
                       rate.numerator, 0, n, 0, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)

    def chunk(cid, body):
        return struct.pack("<4sI", cid, len(body)) + body + (b"\x00" if len(body) & 1 else b"")

    def lst(kind, *parts):
        body = kind + b"".join(parts)
        return struct.pack("<4sI", b"LIST", len(body)) + body

    strl = lst(b"strl", chunk(b"strh", strh), chunk(b"strf", strf))
    hdrl = lst(b"hdrl", chunk(b"avih", avih), strl)
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", idx)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI", b"RIFF", len(body)) + body)


# --------------------------------------------------------------------------- #
# fixtures
# --------------------------------------------------------------------------- #

def scene(n: int, h: int, w: int) -> List[np.ndarray]:
    """Frames of `video_fixtures.scene` (drawn at 160x120 or more, cropped)."""
    return [np.ascontiguousarray(_scene(t, max(h, 120), max(w, 160))[:h, :w]) for t in range(n)]


def noisy(n: int, h: int, w: int, seed: int = 0) -> List[np.ndarray]:
    """The scene with uniform noise of +-60 levels (large levels at a low QP)."""
    rng = np.random.RandomState(seed)
    return [np.clip(f.astype(np.int16) + rng.randint(-60, 61, f.shape), 0, 255).astype(np.uint8)
            for f in scene(n, h, w)]


# name -> (frames, encode(...) keyword arguments, container, note)
FIXTURES = {
    "a_baseline_cavlc_320x240.mp4": (
        lambda: scene(24, 240, 320), dict(profile="baseline", params="keyint=12"), "mp4",
        "Constrained Baseline, CAVLC, keyint 12"),
    "b_main_cabac_bframes_320x240.mp4": (
        lambda: scene(24, 240, 320),
        dict(profile="main", params="keyint=12:bframes=3:b-pyramid=normal:direct=spatial:"
                                    "weightp=2:ref=4"), "libavformat",
        "Main, CABAC, B-pyramid, spatial direct, weighted P, 4 refs; two GOPs (ctts, elst); "
        "muxed by libavformat 59's mov muxer"),
    "c_high_8x8_cqm_slices_328x244.mov": (
        lambda: scene(24, 244, 328),
        dict(profile="high", params="keyint=12:8x8dct=1:cqm=jvt:slices=4:deblock=-2,1:"
                                    "direct=temporal:weightb=1:constrained-intra=1:bframes=3"),
        "mp4", "High in .mov: 8x8 transform, JVT matrices, 4 slices, deblock -2,1, temporal "
               "direct, implicit weights, constrained intra; 328x244 coded 336x256 (cropped)"),
    "d_high_640x480.mp4": (
        lambda: scene(48, 480, 640), dict(profile="high", params="keyint=24"), "mp4",
        "High at x264's defaults, 48 frames (timed and tracked by chip_smoke.py)"),
    "e_high_1920x1080.mp4": (
        lambda: scene(6, 1080, 1920), dict(profile="high", params="bframes=2"), "mp4",
        "High 1920x1080 (coded 1088, cropped), 6 frames"),
    "f_high_fullrange_bt709.mp4": (
        lambda: scene(12, 120, 160),
        dict(profile="high", params="fullrange=on:colorprim=bt709:transfer=bt709:"
                                    "colormatrix=bt709"), "mp4",
        "High, full range, BT.709 VUI (swscale's BT.709 full-range conversion)"),
    "g_high_320x240.avi": (
        lambda: scene(24, 240, 320), dict(profile="high", params="keyint=12"), "avi",
        "High in AVI, FourCC H264, Annex B"),
    "h_avc3_opengop_320x240.mp4": (
        lambda: scene(24, 240, 320),
        dict(profile="high", params="keyint=8:open-gop=1:repeat-headers=1:bframes=3"), "avc3",
        "avc3 with the parameter sets in band, open GOPs (recovery point SEI)"),
    "i_noise_qp8_cavlc.mp4": (
        lambda: noisy(4, 96, 128, 1), dict(profile="high", params="cabac=0:keyint=2",
                                           options={"qp": "8"}), "mp4",
        "noise at QP 8, CAVLC (level_prefix escapes)"),
    "i_noise_qp8_cabac.mp4": (
        lambda: noisy(4, 96, 128, 2), dict(profile="high", params="keyint=2:8x8dct=1",
                                           options={"qp": "8"}), "mp4",
        "noise at QP 8, CABAC (coeff_abs_level escapes)"),
    "j_trimmed_320x240.mp4": (
        lambda: scene(24, 240, 320),
        dict(profile="high", params="keyint=12:bframes=3:b-pyramid=normal"), "trim",
        "edit list starting 5 frames in, as an editor trims without re-encoding"),
    "k_truncated_320x240.mp4": (
        lambda: scene(24, 240, 320),
        dict(profile="high", params="keyint=12:bframes=3"), "truncate",
        "moov first, cut at 75% of the file, inside the second GOP"),
    "l_mbaff.mp4": (lambda: scene(2, 48, 64), dict(profile="high", params="interlaced=1"), "mp4",
                    "refused: interlaced coding (MBAFF)"),
    "l_paff.mp4": (lambda: scene(2, 48, 64), dict(profile="high", params="fake-interlaced=1"),
                   "mp4", "refused: interlaced coding (field pictures allowed)"),
    "l_10bit.mp4": (lambda: scene(2, 48, 64), dict(profile="high10", pix_fmt="yuv420p10le"),
                    "mp4", "refused: 10 bits a sample"),
    "l_422.mp4": (lambda: scene(2, 48, 64), dict(profile="high422", pix_fmt="yuv422p"), "mp4",
                  "refused: 4:2:2 chroma"),
    "l_444.mp4": (lambda: scene(2, 48, 64), dict(profile="high444", pix_fmt="yuv444p"), "mp4",
                  "refused: 4:4:4 chroma"),
    "l_lossless.mp4": (lambda: scene(2, 48, 64), dict(options={"qp": "0"}), "mp4",
                       "refused: High 4:4:4 Predictive lossless (transform bypass)"),
}
REFUSED = {"l_mbaff.mp4": "interlaced", "l_paff.mp4": "interlaced", "l_10bit.mp4": "10 bits",
           "l_422.mp4": "4:2:2", "l_444.mp4": "4:4:4", "l_lossless.mp4": "lossless"}
TRIM = 5
TRUNCATE_AT = 0.75


def write_fixture(name: str, path: str) -> None:
    frames, kw, how, _ = FIXTURES[name]
    stream = encode(frames(), **kw)
    if how == "libavformat":
        mov_mux(path, stream)
    elif how == "avi":
        write_avi(path, stream)
    elif how == "avc3":
        write_mp4(path, stream, sample_entry=b"avc3")
    elif how == "trim":
        write_mp4(path, stream, trim=TRIM)
    elif how == "truncate":
        write_mp4(path, stream)
        data = faststart(open(path, "rb").read())
        with open(path, "wb") as f:
            f.write(data[:int(len(data) * TRUNCATE_AT)])
    else:
        write_mp4(path, stream)


def manifest() -> dict:
    """cv2's reading of each committed clip; the refused ones by the tool
    the port names."""
    out = {}
    for path in sorted(glob.glob(os.path.join(DIR, "*"))):
        name = os.path.basename(path)
        if name.endswith(".json"):
            continue
        if name in REFUSED:
            out[name] = {"refused": REFUSED[name]}
            continue
        fps, count, size, packets, frames = cv2_read(path)
        out[name] = {"fps": fps, "frame_count": count, "size": list(size),
                     "muxer": "libavformat 59 mov" if FIXTURES[name][2] == "libavformat"
                     else "avi" if FIXTURES[name][2] == "avi" else "tests/h264_fixtures.py",
                     "packets": [sha(p) for p in packets],
                     "frames": [sha(np.ascontiguousarray(f)) for f in frames]}
    return out


def main():
    os.makedirs(DIR, exist_ok=True)
    for old in glob.glob(os.path.join(DIR, "*")):
        os.remove(old)
    for name in FIXTURES:
        write_fixture(name, os.path.join(DIR, name))
    with open(os.path.join(DIR, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
