"""Container fixtures for the port's demuxers: one x264 and one x265 stream
muxed by the system's FFmpeg 5.1 `libavformat.so.59` (through ctypes) as
Matroska, MPEG-TS, M2TS and fragmented MP4, written as raw Annex B, and
rewritten by this module's own EBML and TS writers for the layouts a muxer
does not write by default; cv2's own mp4v `.mkv` and `.ts`; and an OpenDML
AVI of small RIFFs. The manifest holds cv2.VideoCapture's fps, frame count
and size, the SHA-256 of each raw packet (`CAP_PROP_FORMAT = -1`) and of
each decoded BGR frame.

    python tests/container_fixtures.py

x264 and x265 do not write the same bytes on every run (see
`h264_fixtures.py`), so a remade set gets a new manifest, which `main`
writes from the files it wrote. `AVFormatContext.pb` sits at offset 32,
`AVStream.time_base` at 16 and `codecpar` at 208 (FFmpeg 5.1); muxer
options go to `avformat_write_header` as an `AVDictionary`.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import struct
import sys
import zlib
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import h264_fixtures as hf  # noqa: E402
from video_fixtures import cv2_read, scene as _scene, sha  # noqa: E402

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video", "containers")
CODEC_IDS = {"h264": 27, "hevc": 173, "mp4v": 12}
H264_RATE, HEVC_RATE = Fraction(25), Fraction(30000, 1001)
SIZE = (128, 96)
FRAMES = 16


def frames(n: int = FRAMES, size=SIZE) -> List[np.ndarray]:
    w, h = size
    return [np.ascontiguousarray(_scene(t, max(h, 120), max(w, 160))[:h, :w]) for t in range(n)]


def h264_stream(n: int = FRAMES) -> hf.Stream:
    return hf.encode(frames(n), profile="high", params="keyint=12:bframes=2", fps=H264_RATE)


def hevc_stream(n: int = FRAMES) -> hf.Stream:
    import hevc_fixtures as hv
    return hv.encode(frames(n), params="keyint=12:bframes=2", fps=HEVC_RATE, hash_sei=False)


# --------------------------------------------------------------------------- #
# libavformat 59
# --------------------------------------------------------------------------- #

def mux(path: str, stream: hf.Stream, codec: str, options: Optional[dict] = None,
        fmt_name: Optional[str] = None) -> None:
    """The stream muxed by libavformat 59 (the muxer by the file's name, or
    `fmt_name`), timestamps rescaled to the muxer's time base with
    rounding, as `ffmpeg -c copy` rescales them; `options` are the muxer's
    (`movflags`, ...)."""
    util, codec_lib = hf._libs()
    fmt = ctypes.CDLL("libavformat.so.59")
    p = ctypes.c_void_p
    fmt.avformat_alloc_output_context2.argtypes = [ctypes.POINTER(p), p, ctypes.c_char_p,
                                                   ctypes.c_char_p]
    fmt.avformat_new_stream.argtypes = [p, p]
    fmt.avformat_new_stream.restype = p
    fmt.avio_open.argtypes = [p, ctypes.c_char_p, ctypes.c_int]
    fmt.avformat_write_header.argtypes = [p, ctypes.POINTER(p)]
    fmt.av_interleaved_write_frame.argtypes = [p, p]
    fmt.av_write_trailer.argtypes = [p]
    fmt.avio_closep.argtypes = [p]
    fmt.avformat_free_context.argtypes = [p]
    util.av_malloc.argtypes = [ctypes.c_size_t]
    util.av_malloc.restype = p
    util.av_dict_set.argtypes = [ctypes.POINTER(p), ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    util.av_dict_free.argtypes = [ctypes.POINTER(p)]
    codec_lib.av_new_packet.argtypes = [p, ctypes.c_int]
    ctx = p()
    name = fmt_name.encode() if fmt_name else None
    if fmt.avformat_alloc_output_context2(ctypes.byref(ctx), None, name, path.encode()) < 0:
        raise OSError(f"libavformat has no muxer for {path}")
    ctx = ctx.value
    st = fmt.avformat_new_stream(ctx, None)
    par = hf._ptr(st, 208).value
    w, h = stream.size
    hf._i32(par, 0).value, hf._i32(par, 4).value = 0, CODEC_IDS[codec]
    hf._i32(par, 56).value, hf._i32(par, 60).value = w, h
    if stream.extradata:
        ext = util.av_malloc(len(stream.extradata) + 64)
        ctypes.memset(ext, 0, len(stream.extradata) + 64)
        ctypes.memmove(ext, stream.extradata, len(stream.extradata))
        hf._ptr(par, 16).value = ext
        hf._i32(par, 24).value = len(stream.extradata)
    rate = stream.rate
    hf._i32(st, 16).value, hf._i32(st, 20).value = rate.denominator, rate.numerator
    if fmt.avio_open(ctx + 32, path.encode(), 2) < 0:
        raise OSError(f"cannot write {path}")
    opts = p()
    for k, v in (options or {}).items():
        util.av_dict_set(ctypes.byref(opts), k.encode(), v.encode(), 0)
    if fmt.avformat_write_header(ctx, ctypes.byref(opts)) < 0:
        raise ValueError("avformat_write_header")
    util.av_dict_free(ctypes.byref(opts))
    tb = Fraction(hf._i32(st, 16).value, hf._i32(st, 20).value)

    def ticks(t):                  # frames -> the muxer's ticks, rounded (av_rescale_q)
        return int((Fraction(t) / rate / tb + Fraction(1, 2)) // 1)

    pkt = codec_lib.av_packet_alloc()
    for q in stream.packets:
        codec_lib.av_new_packet(pkt, len(q.data))
        ctypes.memmove(hf._ptr(pkt, 24).value, q.data, len(q.data))
        hf._i64(pkt, 8).value, hf._i64(pkt, 16).value = ticks(q.pts), ticks(q.dts)
        hf._i32(pkt, 40).value = 1 if q.key else 0
        hf._i64(pkt, 64).value = ticks(q.pts + 1) - ticks(q.pts)
        hf._i32(pkt, 36).value = 0
        if fmt.av_interleaved_write_frame(ctx, pkt) < 0:
            raise ValueError("av_interleaved_write_frame")
    fmt.av_write_trailer(ctx)
    fmt.avio_closep(ctx + 32)
    fmt.avformat_free_context(ctx)
    q = ctypes.c_void_p(pkt)
    codec_lib.av_packet_free(ctypes.byref(q))


def write_annexb(path: str, stream: hf.Stream) -> None:
    """A raw Annex B elementary stream, as `ffmpeg -c copy x.h264` writes
    it: the parameter sets, then the access units."""
    with open(path, "wb") as f:
        f.write(stream.extradata + b"".join(p.data for p in stream.packets))


def write_cv2(path: str, fps: float, n: int, size=(160, 120)) -> None:
    import cv2
    w, h = size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert vw.isOpened(), path
    for t in range(n):
        vw.write(_scene(t, max(h, 120), max(w, 160))[:h, :w].copy())
    vw.release()


# --------------------------------------------------------------------------- #
# a Matroska writer for the layouts libavformat does not write by default
# --------------------------------------------------------------------------- #

def _id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _vsize(n: int) -> bytes:
    k = next(k for k in range(1, 9) if n < (1 << (7 * k)) - 1)
    return ((1 << (7 * k)) | n).to_bytes(k, "big")


UNKNOWN_SIZE = b"\x01\xff\xff\xff\xff\xff\xff\xff"


def el(eid: int, body: bytes) -> bytes:
    return _id(eid) + _vsize(len(body)) + body


def el_uint(eid: int, v: int) -> bytes:
    return el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _xiph(sizes: Sequence[int]) -> bytes:
    out = b""
    for n in sizes[:-1]:
        out += b"\xff" * (n // 255) + bytes([n % 255])
    return out


def _ebml_lace(sizes: Sequence[int]) -> bytes:
    out = _vsize(sizes[0])
    for a, b in zip(sizes, sizes[1:-1]):
        d = b - a
        for k in range(1, 9):
            bias = (1 << (7 * k - 1)) - 1
            if -bias <= d <= bias:
                out += ((1 << (7 * k)) | (d + bias)).to_bytes(k, "big")
                break
    return out


def write_mkv(path: str, stream: hf.Stream, codec: str = "h264", lacing: Optional[str] = None,
              per_block: int = 3, strip: int = 0, zlib_frames: bool = False,
              unknown_sizes: bool = False, duration: bool = True,
              codec_id: Optional[str] = None, private: Optional[bytes] = None) -> None:
    """The stream in a Matroska file written here: millisecond timestamps,
    `DefaultDuration`, the avcC/hvcC record as `CodecPrivate` and
    length-prefixed frames (`codec` "raw": the packets as they are, with
    `codec_id` and `private`); `lacing` ("xiph", "ebml", "fixed") packs
    `per_block` frames in a SimpleBlock (fixed lacing takes frames of one
    size), `strip` removes that many leading bytes of every frame into a
    header-stripping ContentEncoding, `zlib_frames` deflates each frame
    (ContentCompAlgo 0), `unknown_sizes` writes the Segment and each
    Cluster with unknown size (and no Cues), as a recording stopped before
    its muxer finished; without `duration` Info has no Duration."""
    import hevc_fixtures as hv
    w, h = stream.size
    if codec == "h264":
        nals = hf.nal_units(stream.extradata)
        record = hf.avcc([n for n in nals if n[0] & 0x1F == 7], [n for n in nals if n[0] & 0x1F == 8])
        frames_ = [hf.length_prefixed(p.data) for p in stream.packets]
        cid = "V_MPEG4/ISO/AVC"
    elif codec == "hevc":
        record = hv.hvcc(stream.extradata)
        frames_ = [hv.length_prefixed(p.data) for p in stream.packets]
        cid = "V_MPEGH/ISO/HEVC"
    else:
        record, frames_, cid = b"", [p.data for p in stream.packets], ""
    cid = codec_id or cid
    record = record if private is None else private
    rate = stream.rate
    ms = [int(Fraction(p.pts) / rate * 1000 + Fraction(1, 2)) for p in stream.packets]
    enc = b""
    if strip:
        head = frames_[0][:strip]
        assert all(f[:strip] == head for f in frames_), "frames do not share their first bytes"
        frames_ = [f[strip:] for f in frames_]
        enc = el(0x6D80, el(0x6240, el_uint(0x5031, 0) + el_uint(0x5032, 1) + el_uint(0x5033, 0)
                            + el(0x5034, el_uint(0x4254, 3) + el(0x4255, head))))
    elif zlib_frames:
        frames_ = [zlib.compress(f) for f in frames_]
        enc = el(0x6D80, el(0x6240, el(0x5034, el_uint(0x4254, 0))))
    header = el(0x1A45DFA3, el_uint(0x4286, 1) + el_uint(0x42F7, 1) + el_uint(0x42F2, 4)
                + el_uint(0x42F3, 8) + el(0x4282, b"matroska") + el_uint(0x4287, 4)
                + el_uint(0x4285, 2))
    default = int(Fraction(10 ** 9) / rate)
    info = el_uint(0x2AD7B1, 1000000) + el(0x4D80, b"tests") + el(0x5741, b"tests")
    if duration:
        info += el(0x4489, struct.pack(">d", float(max(ms) + 1000 / rate)))
    entry = (el_uint(0xD7, 1) + el_uint(0x73C5, 1) + el_uint(0x83, 1) + el(0x86, cid.encode())
             + el_uint(0x23E383, default) + el(0xE0, el_uint(0xB0, w) + el_uint(0xBA, h))
             + enc + el(0x63A2, record))
    body = el(0x1549A966, info) + el(0x1654AE6B, el(0xAE, entry))
    groups = [list(range(i, min(i + (per_block if lacing else 1), len(frames_))))
              for i in range(0, len(frames_), per_block if lacing else 1)]
    cluster_at, cluster = 0, b""

    def flush(cluster, start):
        if not cluster:
            return b""
        inner = el_uint(0xE7, start) + cluster
        return _id(0x1F43B675) + (UNKNOWN_SIZE if unknown_sizes else _vsize(len(inner))) + inner

    for g in groups:
        t = ms[g[0]]
        if not cluster or t - cluster_at >= 1000 or t < cluster_at:
            body += flush(cluster, cluster_at)
            cluster, cluster_at = b"", t
        data = [frames_[k] for k in g]
        flags = 0x80 if stream.packets[g[0]].key else 0
        if lacing and len(g) > 1:
            kind = {"xiph": 1, "fixed": 2, "ebml": 3}[lacing]
            sizes = [len(d) for d in data]
            lace = bytes([len(g) - 1]) + (_xiph(sizes) if kind == 1 else
                                          _ebml_lace(sizes) if kind == 3 else b"")
            if kind == 2:
                assert len(set(sizes)) == 1, "fixed lacing needs frames of one size"
            block = b"\x81" + struct.pack(">hB", t - cluster_at, flags | kind << 1) + lace + b"".join(data)
        else:
            block = b"\x81" + struct.pack(">hB", t - cluster_at, flags) + data[0]
        cluster += el(0xA3, block)
    body += flush(cluster, cluster_at)
    seg = _id(0x18538067) + (UNKNOWN_SIZE if unknown_sizes else _vsize(len(body))) + body
    with open(path, "wb") as f:
        f.write(header + seg)


# --------------------------------------------------------------------------- #
# an MPEG-TS writer that lays PES out as a muxer need not
# --------------------------------------------------------------------------- #

def _crc32_mpeg(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF
    return crc


def _pts(marker: int, t: int) -> bytes:
    return bytes([(marker << 4) | ((t >> 29) & 0x0E) | 1, (t >> 22) & 0xFF, ((t >> 14) & 0xFE) | 1,
                  (t >> 7) & 0xFF, ((t << 1) & 0xFE) | 1])


def write_ts(path: str, stream: hf.Stream, stream_type: int = 0x1B,
             layout: Sequence[Sequence[Tuple[int, Optional[slice]]]] = (), m2ts: bool = False,
             extradata_first: bool = True) -> None:
    """The stream in a transport stream written here: PAT, PMT (one stream
    of `stream_type` on PID 0x100), then one PES per entry of `layout`,
    each a list of (packet index, slice of its bytes or None for all);
    the PES takes the PTS/DTS of its first piece when that piece starts a
    packet, else none. Without `layout` each packet is one PES."""
    rate = stream.rate
    data = [p.data for p in stream.packets]
    if extradata_first:
        data[0] = stream.extradata + data[0]
    if not layout:
        layout = [[(k, None)] for k in range(len(data))]
    delay = 2

    def ticks(t):
        return int(Fraction(t) / rate * 90000) + 90000

    out = bytearray()
    cc = {0: 0, 0x1000: 0, 0x100: 0}

    def packets(pid, payload: bytes, start: bool):
        first = True
        while payload or first:
            room = 184
            head = bytes([0x47, (0x40 if start and first else 0) | (pid >> 8), pid & 0xFF])
            if len(payload) < room:
                pad = room - len(payload)
                if pad == 1:
                    af = b"\x00"
                else:
                    af = bytes([pad - 1, 0x00]) + b"\xff" * (pad - 2)
                pkt = head + bytes([0x30 | cc[pid]]) + af + payload
                payload = b""
            else:
                pkt = head + bytes([0x10 | cc[pid]]) + payload[:room]
                payload = payload[room:]
            cc[pid] = (cc[pid] + 1) & 15
            if m2ts:
                out.extend(b"\x00\x00\x00\x00")
            out.extend(pkt)
            first = False

    def section(table_id: int, body: bytes, ext: int) -> bytes:
        sec = bytes([table_id]) + struct.pack(">H", 0xB000 | (len(body) + 9)) + struct.pack(
            ">HBBB", ext, 0xC1, 0, 0) + body
        return b"\x00" + sec + struct.pack(">I", _crc32_mpeg(sec))

    packets(0, section(0x00, struct.pack(">HH", 1, 0xE000 | 0x1000), 1), True)
    pmt = struct.pack(">HH", 0xE000 | 0x100, 0xF000) + struct.pack(">BHH", stream_type, 0xE000 | 0x100, 0xF000)
    packets(0x1000, section(0x02, pmt, 1), True)
    for pes in layout:
        body = b"".join(data[k][sl] if sl is not None else data[k] for k, sl in pes)
        k, sl = pes[0]
        p = stream.packets[k]
        if sl is None or (sl.start or 0) == 0:
            pts, dts = ticks(p.pts + delay), ticks(p.dts + delay)
            opt = (b"\x80\xc0\x0a" + _pts(3, pts) + _pts(1, dts) if pts != dts
                   else b"\x80\x80\x05" + _pts(2, pts))
        else:
            opt = b"\x80\x00\x00"
        n = len(opt) + len(body)
        packets(0x100, b"\x00\x00\x01\xe0" + struct.pack(">H", n if n < 65536 else 0) + opt + body,
                True)
    with open(path, "wb") as f:
        f.write(bytes(out))


# --------------------------------------------------------------------------- #
# an OpenDML AVI of small RIFFs, as FFmpeg's avi muxer lays one out
# --------------------------------------------------------------------------- #

def write_odml_avi(path: str, stream: hf.Stream, per_riff: int = 8, fourcc: bytes = b"H264",
                   super_index: bool = True) -> None:
    """Annex B access units in an OpenDML AVI: RIFF 'AVI ' (avih's total
    frames: the first RIFF's; strh's length: all; `indx` super index;
    odml/dmlh: all; movi with an ix00 standard index; idx1), then RIFF
    'AVIX's of `per_riff` frames each with their own movi and ix00."""
    w, h = stream.size
    rate = stream.rate
    chunks = [p.data for p in stream.packets]
    chunks[0] = stream.extradata + chunks[0]
    keys = [p.key for p in stream.packets]
    n = len(chunks)
    groups = [list(range(i, min(i + per_riff, n))) for i in range(0, n, per_riff)]

    def chunk(cid, body):
        return struct.pack("<4sI", cid, len(body)) + body + (b"\x00" if len(body) & 1 else b"")

    def lst(kind, *parts):
        body = kind + b"".join(parts)
        return struct.pack("<4sI", b"LIST", len(body)) + body

    n_idx = len(groups)
    indx_body_len = 24 + 16 * n_idx

    def hdrl(indx_entries):
        avih = struct.pack("<14I", round(1e6 * rate.denominator / rate.numerator), 0, 0, 0x10,
                           len(groups[0]), 0, 1, 0, w, h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, rate.denominator,
                           rate.numerator, 0, n, 0, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)
        parts = [chunk(b"strh", strh), chunk(b"strf", strf)]
        if super_index:
            indx = struct.pack("<HBBI4s12x", 4, 0, 0, n_idx, b"00dc") + b"".join(
                struct.pack("<QII", o, s, d) for o, s, d in indx_entries)
            parts.append(chunk(b"indx", indx))
        return lst(b"hdrl", chunk(b"avih", avih), lst(b"strl", *parts),
                   lst(b"odml", chunk(b"dmlh", struct.pack("<I", n) + b"\x00" * 244)))

    # lay out once with placeholder offsets, then again with the real ones
    entries = [(0, 0, 0)] * n_idx
    for _ in range(2):
        out = b""
        found = []
        for r, g in enumerate(groups):
            head = b"AVI " + hdrl(entries) if r == 0 else b"AVIX"
            riff_start = len(out)
            movi_data_start = riff_start + 8 + len(head) + 12
            movi, rel = b"", []
            for k in g:
                rel.append((len(movi) + 8, len(chunks[k]), keys[k]))
                movi += chunk(b"00dc", chunks[k])
            ix = struct.pack("<HBBI4sQI", 2, 0, 1, len(g), b"00dc", movi_data_start, 0) + b"".join(
                struct.pack("<II", o, s | (0 if key else 0x80000000)) for o, s, key in rel)
            ix_at = movi_data_start + len(movi)
            movi += chunk(b"ix00", ix)
            found.append((ix_at, len(ix) + 8, len(g)))
            body = head + lst(b"movi", movi)
            if r == 0:
                idx1 = b"".join(struct.pack("<4sIII", b"00dc", 0x10 if key else 0, o - 4, s)
                                for o, s, key in rel)
                body += chunk(b"idx1", idx1)
            out += struct.pack("<4sI", b"RIFF", len(body)) + body
        entries = found
    with open(path, "wb") as f:
        f.write(out)


# --------------------------------------------------------------------------- #
# the committed fixtures
# --------------------------------------------------------------------------- #

TRUNCATE_AT = 0.75
# the fixtures whose frame count cv2 reports without meaning (no duration:
# the raw demuxer's, a Matroska file without `Duration`); the port reports
# its packets (ROADMAP, deliberate differences)
NO_DURATION = ("a_h264.h264", "b_hevc.hevc", "d_unknown_size.mkv")
SPLIT_AT = 5                # the access unit split across two PES
JOINED = (8, 9)             # two access units in one PES


def split_layout(n: int):
    """One PES an access unit, but `SPLIT_AT` in two halves (the second PES
    without a PTS) and the `JOINED` pair in one."""
    out = []
    for k in range(n):
        if k == SPLIT_AT:
            out += [[(k, slice(0, 40))], [(k, slice(40, None))]]
        elif k == JOINED[0]:
            out.append([(k, None), (JOINED[1], None)])
        elif k != JOINED[1]:
            out.append([(k, None)])
    return out


def write_all(dir_: str) -> None:
    s, v = h264_stream(), hevc_stream()
    for codec, st, tag in (("h264", s, "a_h264"), ("hevc", v, "b_hevc")):
        mux(os.path.join(dir_, tag + ".mkv"), st, codec)
        mux(os.path.join(dir_, tag + ".ts"), st, codec)
        mux(os.path.join(dir_, tag + ".m2ts"), st, codec)
        mux(os.path.join(dir_, tag + "_frag.mp4"), st, codec, {"movflags": "frag_keyframe+empty_moov"})
        mux(os.path.join(dir_, tag + "_fragmoof.mp4"), st, codec,
            {"movflags": "frag_keyframe+empty_moov+default_base_moof"})
        write_annexb(os.path.join(dir_, tag + (".h264" if codec == "h264" else ".hevc")), st)
    mux(os.path.join(dir_, "a_h264_hybrid.mp4"), s, "h264", {"movflags": "frag_keyframe"})
    write_cv2(os.path.join(dir_, "c_mp4v_cv2.mkv"), 29.97, CV2_FRAMES, SIZE)
    write_cv2(os.path.join(dir_, "c_mp4v_cv2.ts"), 29.97, CV2_FRAMES, SIZE)
    write_mkv(os.path.join(dir_, "d_laced_xiph.mkv"), s, lacing="xiph", per_block=3)
    write_mkv(os.path.join(dir_, "d_laced_ebml.mkv"), s, lacing="ebml", per_block=4)
    write_mkv(os.path.join(dir_, "d_stripped.mkv"), s, strip=2)
    write_mkv(os.path.join(dir_, "d_unknown_size.mkv"), s, unknown_sizes=True, duration=False)
    with open(os.path.join(dir_, "a_h264.mkv"), "rb") as f:
        data = f.read()
    with open(os.path.join(dir_, "d_cut_short.mkv"), "wb") as f:
        f.write(data[:int(len(data) * TRUNCATE_AT)])
    write_ts(os.path.join(dir_, "e_split_pes.ts"), s, layout=split_layout(len(s.packets)))
    write_odml_avi(os.path.join(dir_, "f_odml.avi"), s, per_riff=8)


CV2_FRAMES = 8
NOTES = {
    "a_h264.mkv": "x264 High, B-frames, 25 fps; libavformat 59's matroska muxer",
    "a_h264.ts": "the same stream, libavformat 59's mpegts muxer (AUD, one PES an access unit)",
    "a_h264.m2ts": "the same stream in M2TS (192-byte packets)",
    "a_h264_frag.mp4": "the same stream, fragmented: movflags frag_keyframe+empty_moov",
    "a_h264_fragmoof.mp4": "fragmented with default-base-is-moof",
    "a_h264_hybrid.mp4": "movflags frag_keyframe: the first GOP in moov, the rest in moofs",
    "a_h264.h264": "raw Annex B",
    "b_hevc.mkv": "x265 Main, B-frames, 30000/1001 fps; libavformat 59's matroska muxer",
    "b_hevc.ts": "the same stream, libavformat 59's mpegts muxer",
    "b_hevc.m2ts": "the same stream in M2TS",
    "b_hevc_frag.mp4": "fragmented: frag_keyframe+empty_moov",
    "b_hevc_fragmoof.mp4": "fragmented with default-base-is-moof",
    "b_hevc.hevc": "raw Annex B",
    "c_mp4v_cv2.mkv": "cv2.VideoWriter's mp4v .mkv at 29.97 fps",
    "c_mp4v_cv2.ts": "cv2.VideoWriter's mp4v .ts at 29.97 fps",
    "d_laced_xiph.mkv": "the x264 stream, three frames a SimpleBlock, Xiph lacing",
    "d_laced_ebml.mkv": "four frames a SimpleBlock, EBML lacing",
    "d_stripped.mkv": "header stripping (ContentCompAlgo 3) of each frame's first 2 bytes",
    "d_unknown_size.mkv": "Segment and Clusters of unknown size, no Duration (a stopped recording)",
    "d_cut_short.mkv": "a_h264.mkv cut at 75% of its bytes",
    "e_split_pes.ts": "access unit 5 split across two PES, 8 and 9 in one PES",
    "f_odml.avi": "OpenDML AVI: RIFF AVI + two AVIX of 8 frames, indx and ix00 indexes",
}


def manifest() -> dict:
    """cv2's reading of each committed file (`NOTES` says what it is)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(DIR, "*"))):
        name = os.path.basename(path)
        if name.endswith(".json"):
            continue
        fps, count, size, packets, frames = cv2_read(path)
        out[name] = {"fps": fps, "frame_count": count, "size": list(size), "note": NOTES[name],
                     "packets": [sha(p) for p in packets],
                     "frames": [sha(np.ascontiguousarray(f)) for f in frames]}
        if name in NO_DURATION:
            out[name]["port_frame_count"] = len(packets)
    return out


def main():
    os.makedirs(DIR, exist_ok=True)
    for old in glob.glob(os.path.join(DIR, "*")):
        os.remove(old)
    write_all(DIR)
    with open(os.path.join(DIR, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
