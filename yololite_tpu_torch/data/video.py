"""Video files: read MP4/MOV and AVI as `cv2.VideoCapture` reads them, and
write MPEG-4 Part 2 ("mp4v") as `cv2.VideoWriter(path, "mp4v", ...)` does.

Containers are parsed here, in the standard library:

  - ISO BMFF (`ftyp`: `.mp4`, `.m4v`, `.mov`): the first video track of
    `moov` (which may come after `mdat`), its sample description (`mp4v`
    with the `esds` DecoderSpecificInfo, the VOL; `jpeg`/`mjpa`, or `mp4v`
    whose object type is JPEG, for Motion-JPEG; `avc1`/`avc3` with `avcC`
    for H.264), its sample table (`stts`, `ctts`, `stss`, `stsc`, `stsz`,
    `stco`/`co64`) and its edit list (`edts/elst`), applied as FFmpeg's
    mov demuxer applies one edit: samples from the last key frame at or
    before the edit's start, pictures shown from its start to its end;
  - RIFF AVI: `hdrl/avih/strl/strh/strf`, then the video stream's
    `##dc`/`##db` chunks of `movi`, by `idx1` where present and else by
    walking `movi`; FMP4/XVID/DIVX/DX50/MP4V as MPEG-4 Part 2, MJPG as
    Motion-JPEG, H264/X264/avc1 as H.264 in Annex B.

The reader reports `fps` (`CAP_PROP_FPS`: the track's frame count over its
`stts` duration in an MP4, `rate / scale` of the stream in an AVI),
`frame_count` (`CAP_PROP_FRAME_COUNT`: the samples of the track, the
stream's length in an AVI), `size` (w, h, H.264's cropped) and `codec`. Its
packets are byte for byte what cv2 yields with `CAP_PROP_FORMAT = -1`: the
container's samples, and for H.264 in an MP4 those samples in Annex B as
FFmpeg's `h264_mp4toannexb` filter writes them (the `avcC` parameter sets
before each IDR picture that does not carry its own).

Frames decode on the host in C++ (`csrc/videocodec.cpp` for MPEG-4 Part 2,
`csrc/imgcodec.cpp` for the planes of a Motion-JPEG frame, `csrc/h264dec.cpp`
for progressive 8-bit 4:2:0 H.264 of the Baseline, Main and High profiles),
built at first use (`csrc/build.py`), to BGR uint8 as cv2.VideoCapture gives
them: FFmpeg's decoders (simple IDCT, its MPEG-4 prediction and motion
compensation; H.264's normative decoding and FFmpeg's output order) and
swscale's YUV -> BGR24 conversion (limited range for MPEG-4, full range for
Motion-JPEG, H.264's signalled range and matrix, chroma not interpolated). A
sample that is missing from the file or does not decode ends the stream,
where cv2's `read` returns False; an H.264 decoder hands out the pictures it
still holds first.

What is not read raises `UnsupportedVideo` naming it: HEVC (`hvc1`/`hev1`),
VP8/VP9/AV1 and WebM/Matroska, fragmented MP4 (`moof`), several edits in
one edit list, OpenDML AVI beyond the first RIFF, any other codec; within
MPEG-4 Part 2 B-VOPs, quarter-pel, GMC, interlace, data partitioning and
RVLC; within H.264 interlaced coding (fields, MBAFF), bit depths above 8,
chroma other than 4:2:0, lossless coding, SP/SI slices, data partitioning,
slice groups and colour matrices swscale does not convert (ROADMAP, "When a
user needs them": video codecs).

`VideoWriter` encodes each BGR frame as an MPEG-4 Part 2 I-VOP (Simple
Profile, H.263 quantization at a fixed quantizer, BT.601 limited range,
chroma from each 2x2 mean) and muxes it into an MP4 (`.mp4`, `.m4v`,
`.mov`: `ftyp`, `mdat`, then `moov` with `mp4v`/`esds`) or an AVI (`.avi`,
FourCC `FMP4`), as the JAX tracker's `cv2.VideoWriter(..., "mp4v")` writes
both; the bytes differ from FFmpeg's, which rate-controls P-VOPs.
"""

from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

ROADMAP_ENTRY = "ROADMAP, 'When a user needs them' (video codecs)"
SNIFF_BYTES = 16
WRITER_QUANT = 2                     # the writer's fixed quantizer (vop_quant)
_MSG_LEN = 256

MPEG4_TAGS = {b"FMP4", b"XVID", b"DIVX", b"DX50", b"MP4V", b"mp4v", b"xvid", b"divx",
              b"fmp4", b"M4S2", b"3IV2", b"DIV5"}
MJPEG_TAGS = {b"MJPG", b"mjpg", b"jpeg", b"mjpa", b"AVRn", b"dmb1"}
H264_TAGS = {b"H264", b"h264", b"X264", b"x264", b"avc1", b"AVC1"}
NAMED_CODECS = {
    b"hvc1": "HEVC", b"hev1": "HEVC", b"HEVC": "HEVC", b"H265": "HEVC",
    b"vp08": "VP8", b"VP80": "VP8", b"vp09": "VP9", b"VP90": "VP9", b"av01": "AV1",
    b"AV01": "AV1", b"DIV3": "MS-MPEG4 v3", b"MP43": "MS-MPEG4 v3", b"MP42": "MS-MPEG4 v2",
    b"WMV3": "WMV3",
}
# MPEG-4 systems objectTypeIndication of an `esds`
_OTI = {0x20: "mp4v", 0x6C: "mjpeg", 0x21: "H.264", 0x23: "HEVC", 0x6A: "MPEG-1 video",
        0x60: "MPEG-2 video", 0x61: "MPEG-2 video", 0x62: "MPEG-2 video",
        0x63: "MPEG-2 video", 0x64: "MPEG-2 video", 0x65: "MPEG-2 video"}

_LIB = None
_H264 = None


class UnsupportedVideo(NotImplementedError):
    """A container, codec or coding tool this package does not read."""


def unsupported(what: str) -> UnsupportedVideo:
    return UnsupportedVideo(f"{what} is not decoded by this package (it reads MPEG-4 Part 2 "
                            f"Simple Profile, Motion-JPEG and progressive 8-bit 4:2:0 H.264 in "
                            f"MP4/MOV and AVI): {ROADMAP_ENTRY}")


def library() -> ctypes.CDLL:
    """The built `videocodec` library with its C functions typed."""
    global _LIB
    if _LIB is None:
        from yololite_tpu_torch.csrc.build import load
        lib = load("videocodec")
        buf, ptr, i32, i64 = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.yl_m4v_open.argtypes = [buf, i64, ctypes.POINTER(ptr), buf, ctypes.c_int]
        lib.yl_m4v_open.restype = ctypes.c_int
        lib.yl_m4v_close.argtypes = [ptr]
        lib.yl_m4v_info.argtypes = [ptr, ptr]
        lib.yl_m4v_decode.argtypes = [ptr, buf, i64, buf, ctypes.c_int]
        lib.yl_m4v_frame.argtypes = [ptr, ptr, i64, i32]
        lib.yl_m4v_decode.restype = lib.yl_m4v_frame.restype = ctypes.c_int
        lib.yl_yuv_to_bgr.argtypes = [ptr, i32, i32, i32, i32, i32, ptr]
        lib.yl_m4v_headers.argtypes = [i32, i32, i32, ptr, i64]
        lib.yl_m4v_headers.restype = i64
        lib.yl_m4v_encode.argtypes = [ptr, i32, i32, i32, i32, i32, i32, i32, ptr, i64]
        lib.yl_m4v_encode.restype = i64
        _LIB = lib
    return _LIB


def libraries() -> None:
    """Builds the video and image codec libraries (in parallel where neither
    is built yet) and loads them, so a missing compiler raises here."""
    from yololite_tpu_torch.csrc.build import build
    from yololite_tpu_torch.data import codecs
    build(["videocodec", "imgcodec", "h264dec"])
    library()
    h264_library()
    codecs.library()


def h264_library() -> ctypes.CDLL:
    """The built `h264dec` library with its C functions typed."""
    global _H264
    if _H264 is None:
        from yololite_tpu_torch.csrc.build import load
        lib = load("h264dec")
        buf, ptr, i32, i64 = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.yl_h264_open.argtypes = [buf, i64, ctypes.POINTER(ptr), buf, i32]
        lib.yl_h264_open.restype = ctypes.c_int
        lib.yl_h264_close.argtypes = [ptr]
        lib.yl_h264_decode.argtypes = [ptr, buf, i64, i64, buf, i32]
        lib.yl_h264_decode.restype = ctypes.c_int
        lib.yl_h264_flush.argtypes = [ptr, buf, i32]
        lib.yl_h264_flush.restype = ctypes.c_int
        lib.yl_h264_pending.argtypes = [ptr, ptr]
        lib.yl_h264_pending.restype = i32
        lib.yl_h264_frame.argtypes = [ptr, ptr, i64]
        lib.yl_h264_frame.restype = i32
        lib.yl_h264_last_type.argtypes = [ptr]
        lib.yl_h264_last_type.restype = i32
        lib.yl_h264_size.argtypes = [ptr, ptr]
        lib.yl_h264_size.restype = i32
        _H264 = lib
    return _H264


def sniff(head: bytes) -> str:
    """The container by content: "mp4" (ISO BMFF), "avi", "ebml"
    (WebM/Matroska) or "" (anything else)."""
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"wide", b"free", b"skip"):
        return "mp4"
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "ebml"
    return ""


@dataclass
class Track:
    """The first video track of a file."""
    codec: str                       # "mp4v", "mjpeg" or "h264"
    width: int
    height: int
    fps: float
    frame_count: int
    extradata: bytes = b""
    samples: List[Tuple[int, int]] = field(default_factory=list)   # (offset, size)
    shown: Optional[List[bool]] = None   # per sample: its picture is shown (edit list)
    annexb_ps: Tuple[bytes, bytes] = (b"", b"")   # H.264 in MP4: avcC's SPSs, PPSs in Annex B


def _codec_of(tag: bytes) -> str:
    if tag in MPEG4_TAGS:
        return "mp4v"
    if tag in MJPEG_TAGS:
        return "mjpeg"
    if tag in H264_TAGS:
        return "h264"
    name = NAMED_CODECS.get(tag)
    raise unsupported(f"{name} ({tag.decode('latin1')!r})" if name
                      else f"the codec {tag.decode('latin1')!r}")


# --------------------------------------------------------------------------- #
# ISO BMFF
# --------------------------------------------------------------------------- #

def _boxes(data: bytes, off: int, end: int):
    """(type, body start, body end) of each box in data[off:end]."""
    while off + 8 <= end:
        size, kind = struct.unpack(">I4s", data[off:off + 8])
        hdr = 8
        if size == 1:
            if off + 16 > end:
                return
            size = struct.unpack(">Q", data[off + 8:off + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr:
            return
        yield kind, off + hdr, min(off + size, end)
        off += size


def _top_level(f, file_size: int):
    """(type, body offset, body size) of each top-level box, by seeking."""
    off = 0
    while off + 8 <= file_size:
        f.seek(off)
        head = f.read(16)
        size, kind = struct.unpack(">I4s", head[:8])
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", head[8:16])[0]
            hdr = 16
        elif size == 0:
            size = file_size - off
        if size < hdr:
            raise ValueError(f"box {kind!r} at {off} has size {size}")
        yield kind, off + hdr, size - hdr
        off += size


def _child(data: bytes, start: int, end: int, kind: bytes):
    for k, s, e in _boxes(data, start, end):
        if k == kind:
            return s, e
    return None


def _descriptor(data: bytes, pos: int):
    """(tag, body start, body end) of the MPEG-4 systems descriptor at pos."""
    tag = data[pos]
    pos += 1
    n = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + n


def _esds(data: bytes, s: int, e: int):
    """(objectTypeIndication, DecoderSpecificInfo) of an esds body."""
    tag, p, end = _descriptor(data, s + 4)
    if tag != 0x03:
        raise ValueError("esds without an ES_Descriptor")
    flags = data[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + data[p]
    if flags & 0x20:
        p += 2
    tag, p, end = _descriptor(data, p)
    if tag != 0x04:
        raise ValueError("esds without a DecoderConfigDescriptor")
    oti = data[p]
    dsi = b""
    q = p + 13
    if q < end:
        tag, ds, de = _descriptor(data, q)
        if tag == 0x05:
            dsi = bytes(data[ds:de])
    return oti, dsi


def demux_mp4(f, file_size: int) -> Track:
    moov = None
    for kind, off, size in _top_level(f, file_size):
        if kind == b"moof":
            raise unsupported("fragmented MP4 ('moof')")
        if kind == b"moov" and moov is None:
            f.seek(off)
            moov = f.read(size)
    if moov is None:
        raise ValueError("no 'moov' box")
    if _child(moov, 0, len(moov), b"mvex"):
        raise unsupported("fragmented MP4 ('mvex')")
    mvhd = _child(moov, 0, len(moov), b"mvhd")
    movie_scale = 0
    if mvhd:
        ver = moov[mvhd[0]]
        movie_scale = struct.unpack(">I", moov[mvhd[0] + (20 if ver == 1 else 12):][:4])[0]
    for kind, s, e in _boxes(moov, 0, len(moov)):
        if kind != b"trak":
            continue
        mdia = _child(moov, s, e, b"mdia")
        hdlr = mdia and _child(moov, *mdia, b"hdlr")
        if not hdlr or moov[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _mp4_track(moov, (s, e), mdia, movie_scale)
    raise ValueError("no video track")


def _avcc(record: bytes):
    """(NAL length size, (the SPSs, the PPSs) in Annex B with 4-byte start
    codes) of an AVCDecoderConfigurationRecord."""
    if len(record) < 7 or record[0] != 1:
        raise ValueError("'avcC' is not an AVCDecoderConfigurationRecord")
    ps, i = [b"", b""], 5
    for k, count_mask in enumerate((0x1F, 0xFF)):
        if i >= len(record):
            break
        n = record[i] & count_mask
        i += 1
        for _ in range(n):
            size = struct.unpack(">H", record[i:i + 2])[0]
            ps[k] += b"\x00\x00\x00\x01" + record[i + 2:i + 2 + size]
            i += 2 + size
    return (record[4] & 3) + 1, tuple(ps)


def _edit_list(m: bytes, trak, timescale: int, movie_scale: int):
    """(media time, duration in the media's time scale or None) of the one
    edit that plays media, None without an edit list."""
    edts = _child(m, *trak, b"edts")
    elst = edts and _child(m, *edts, b"elst")
    if not elst:
        return None
    s, _ = elst
    ver = m[s]
    n = struct.unpack(">I", m[s + 4:s + 8])[0]
    fmt, size = (">Qq", 16) if ver == 1 else (">Ii", 8)
    edits = [struct.unpack(fmt, m[s + 8 + (size + 4) * i:s + 8 + (size + 4) * i + size])
             for i in range(n)]
    played = [(dur, t) for dur, t in edits if t != -1]
    if len(played) > 1:
        raise unsupported("an MP4 edit list of several edits")
    if not played:
        return None
    dur, t = played[0]
    if not movie_scale or not dur:
        return t, None
    return t, (dur * timescale + movie_scale // 2) // movie_scale


def _apply_edit(dts, cts, keys, edit):
    """FFmpeg's mov_fix_index for one edit: the first sample kept (the last
    key frame whose dts and pts are at or before the edit's start) and, per
    sample kept, whether its picture falls inside the edit."""
    if edit is None:
        return 0, [True] * len(dts)
    start, dur = edit
    first = max((i for i in range(len(dts)) if keys[i] and dts[i] <= start), default=-1)
    while first >= 0 and not (keys[first] and cts[first] <= start):
        first -= 1
    first = max(first, 0)
    end = None if dur is None else start + dur
    return first, [start <= c and (end is None or c < end) for c in cts[first:]]


def _mp4_track(m: bytes, trak, mdia, movie_scale: int) -> Track:
    mdhd = _child(m, *mdia, b"mdhd")
    ver = m[mdhd[0]]
    timescale = struct.unpack(">I", m[mdhd[0] + (20 if ver == 1 else 12):][:4])[0]
    minf = _child(m, *mdia, b"minf")
    stbl = _child(m, *minf, b"stbl")
    box = {k: (s, e) for k, s, e in _boxes(m, *stbl)}
    s, e = box[b"stsd"]
    entries = list(_boxes(m, s + 8, e))
    if not entries:
        raise ValueError("empty sample description")
    tag, es, ee = entries[0]
    width, height = struct.unpack(">HH", m[es + 24:es + 28])
    extradata, annexb_ps = b"", (b"", b"")
    if tag in (b"mp4v", b"MP4V"):
        esds = _child(m, es + 78, ee, b"esds")
        if esds is None:
            raise ValueError("mp4v sample entry without esds")
        oti, extradata = _esds(m, *esds)
        codec = _OTI.get(oti)
        if codec not in ("mp4v", "mjpeg"):
            raise unsupported(f"{codec or 'object type 0x%02x' % oti} in an 'mp4v' sample entry")
    elif tag in (b"avc1", b"avc3"):
        avcc = _child(m, es + 78, ee, b"avcC")
        if avcc is None:
            raise unsupported(f"H.264 ({tag.decode('latin1')!r}) without an 'avcC' record")
        codec, extradata = "h264", bytes(m[avcc[0]:avcc[1]])
        _, annexb_ps = _avcc(extradata)
    elif tag in (b"encv", b"encm"):
        raise unsupported("encrypted video")
    else:
        codec = _codec_of(tag)
    # stts: decoding times
    s, _ = box[b"stts"]
    n = struct.unpack(">I", m[s + 4:s + 8])[0]
    total, count, dts = 0, 0, []
    for i in range(n):
        c, d = struct.unpack(">II", m[s + 8 + 8 * i:s + 16 + 8 * i])
        dts.extend(range(total, total + c * d, d) if d else [total] * c)
        total += c * d
        count += c
    # stsz
    s, _ = box[b"stsz"]
    const, nsamp = struct.unpack(">II", m[s + 4:s + 12])
    sizes = ([const] * nsamp if const else
             list(struct.unpack(f">{nsamp}I", m[s + 12:s + 12 + 4 * nsamp])))
    # chunk offsets
    if b"stco" in box:
        s, _ = box[b"stco"]
        nc = struct.unpack(">I", m[s + 4:s + 8])[0]
        chunks = struct.unpack(f">{nc}I", m[s + 8:s + 8 + 4 * nc])
    else:
        s, _ = box[b"co64"]
        nc = struct.unpack(">I", m[s + 4:s + 8])[0]
        chunks = struct.unpack(f">{nc}Q", m[s + 8:s + 8 + 8 * nc])
    # stsc: samples per chunk
    s, _ = box[b"stsc"]
    ns = struct.unpack(">I", m[s + 4:s + 8])[0]
    runs = [struct.unpack(">III", m[s + 8 + 12 * i:s + 20 + 12 * i]) for i in range(ns)]
    samples, k = [], 0
    for r, (first, per, _) in enumerate(runs):
        last = runs[r + 1][0] - 1 if r + 1 < len(runs) else len(chunks)
        for c in range(first - 1, last):
            off = chunks[c]
            for _ in range(per):
                if k >= nsamp:
                    break
                samples.append((off, sizes[k]))
                off += sizes[k]
                k += 1
    # ctts: composition offsets; stss: key frames (every sample without it)
    dts = (dts + [total] * len(samples))[:len(samples)]
    cts = list(dts)
    if b"ctts" in box:
        s, _ = box[b"ctts"]
        cver = m[s]
        n = struct.unpack(">I", m[s + 4:s + 8])[0]
        i = 0
        for j in range(n):
            c, o = struct.unpack(">Ii" if cver else ">II", m[s + 8 + 8 * j:s + 16 + 8 * j])
            for _ in range(c):
                if i < len(cts):
                    cts[i] += o
                i += 1
    keys = [True] * len(samples)
    if b"stss" in box:
        s, _ = box[b"stss"]
        n = struct.unpack(">I", m[s + 4:s + 8])[0]
        keys = [False] * len(samples)
        for j in struct.unpack(f">{n}I", m[s + 8:s + 8 + 4 * n]):
            if 0 < j <= len(keys):
                keys[j - 1] = True
    first, shown = _apply_edit(dts, cts, keys, _edit_list(m, trak, timescale, movie_scale))
    fps = float(Fraction(timescale * count, total)) if total and timescale else 0.0
    return Track(codec, width, height, fps, nsamp, extradata, samples[first:], shown, annexb_ps)


# --------------------------------------------------------------------------- #
# AVI
# --------------------------------------------------------------------------- #

def _chunks(f, off: int, end: int):
    """(id, list type or None, body offset, body size) of each RIFF chunk."""
    while off + 8 <= end:
        f.seek(off)
        head = f.read(12)
        if len(head) < 8:
            return
        cid, size = struct.unpack("<4sI", head[:8])
        if cid in (b"LIST", b"RIFF"):
            yield cid, head[8:12], off + 12, size - 4
        else:
            yield cid, None, off + 8, size
        off += 8 + size + (size & 1)


def demux_avi(f, file_size: int) -> Track:
    riff_end = 8 + struct.unpack("<I", f.read(8)[4:8])[0]
    hdrl = movi = None
    idx1 = None
    for cid, kind, off, size in _chunks(f, 12, min(riff_end, file_size)):
        if kind == b"hdrl" and hdrl is None:
            f.seek(off)
            hdrl = f.read(size)
        elif kind == b"movi" and movi is None:
            movi = (off - 4, off, off + size)
        elif cid == b"idx1":
            f.seek(off)
            idx1 = f.read(size)
    if riff_end + 12 <= file_size:
        f.seek(riff_end + (riff_end & 1))
        more = f.read(12)
        if more[:4] == b"RIFF" and more[8:12] == b"AVIX":
            raise unsupported("OpenDML AVI beyond the first RIFF ('AVIX')")
    if hdrl is None or movi is None:
        raise ValueError("AVI without 'hdrl' or 'movi'")
    stream, track = 0, None
    pos = 0
    while pos + 8 <= len(hdrl):
        cid, size = struct.unpack("<4sI", hdrl[pos:pos + 8])
        if cid == b"LIST" and hdrl[pos + 8:pos + 12] == b"strl":
            body = hdrl[pos + 12:pos + 8 + size]
            strh = strf = None
            q = 0
            while q + 8 <= len(body):
                c2, s2 = struct.unpack("<4sI", body[q:q + 8])
                if c2 == b"strh":
                    strh = body[q + 8:q + 8 + s2]
                elif c2 == b"strf":
                    strf = body[q + 8:q + 8 + s2]
                q += 8 + s2 + (s2 & 1)
            if strh is not None and strh[:4] == b"vids":
                handler = strh[4:8]
                scale, rate, _, length = struct.unpack("<IIII", strh[20:36])
                w, h = struct.unpack("<ii", strf[4:12])
                comp = strf[16:20]
                extradata = bytes(strf[40:])
                tag = comp if comp.strip(b"\x00") else handler
                codec = _codec_of(tag)
                fps = float(Fraction(rate, scale)) if scale and rate else 0.0
                track = Track(codec, w, abs(h), fps, length, extradata)
                break
            stream += 1
        pos += 8 + size + (size & 1)
    if track is None:
        raise ValueError("AVI without a video stream")
    ids = (b"%02ddc" % stream, b"%02ddb" % stream)
    movi_fourcc, movi_start, movi_end = movi
    samples = []
    if idx1:
        entries = [struct.unpack("<4sIII", idx1[i:i + 16]) for i in range(0, len(idx1) - 15, 16)]
        mine = [e for e in entries if e[0] in ids]
        if mine:
            # offsets from the 'movi' fourcc, or absolute (FFmpeg's check)
            base = movi_fourcc if mine[0][2] < movi_fourcc else 0
            samples = [(base + off + 8, size) for _, _, off, size in mine]
    if not samples:
        def walk(start, end):
            for cid, kind, off, size in _chunks(f, start, end):
                if kind == b"rec ":
                    walk(off, off + size)
                elif cid in ids:
                    samples.append((off, size))
        walk(movi_start, min(movi_end, file_size))
    if not track.frame_count:
        track.frame_count = len(samples)
    track.samples = samples
    return track


# --------------------------------------------------------------------------- #
# reader
# --------------------------------------------------------------------------- #

def probe(path: str) -> Track:
    """The first video track of the file at `path`. A file that is not a
    container raises `ValueError`; a container or codec this package does
    not read raises `UnsupportedVideo`."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        kind = sniff(f.read(SNIFF_BYTES))
        f.seek(0)
        if kind == "ebml":
            raise unsupported("WebM/Matroska (VP8/VP9/AV1)")
        if kind == "mp4":
            return demux_mp4(f, size)
        if kind == "avi":
            return demux_avi(f, size)
    raise ValueError(f"{path}: not a video container this package reads (MP4/MOV, AVI)")


class Mpeg4Decoder:
    """One MPEG-4 Part 2 stream: packets in, BGR frames out."""

    def __init__(self, extradata: bytes = b""):
        self._lib = lib = library()
        msg, h = ctypes.create_string_buffer(_MSG_LEN), ctypes.c_void_p()
        self._h, self.damage = None, None
        code = lib.yl_m4v_open(extradata, len(extradata), ctypes.byref(h), msg, _MSG_LEN)
        if code:
            raise _error(code, msg)
        self._h = h.value

    def size(self):
        info = np.zeros(4, np.int32)
        self._lib.yl_m4v_info(self._h, info.ctypes.data)
        return int(info[0]), int(info[1])

    def decode(self, packet: bytes, planes: bool = False) -> Optional[np.ndarray]:
        """The frame of one packet (BGR [h, w, 3], or with `planes` the
        decoder's Y, Cb, Cr concatenated), None for a packet with no picture;
        a packet that does not decode raises."""
        lib, msg = self._lib, ctypes.create_string_buffer(_MSG_LEN)
        code = lib.yl_m4v_decode(self._h, bytes(packet), len(packet), msg, _MSG_LEN)
        if code == 1:
            return None
        self.damage = msg.value.decode(errors="replace") if code == 4 else None
        if code not in (0, 4):
            raise _error(code, msg)
        w, h = self.size()
        n = w * h + 2 * ((w + 1) // 2) * ((h + 1) // 2) if planes else w * h * 3
        out = np.empty(n, np.uint8)
        if lib.yl_m4v_frame(self._h, out.ctypes.data, n, int(planes)):
            raise ValueError("no decoded picture")
        return out if planes else out.reshape(h, w, 3)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.yl_m4v_close(self._h)
            self._h = None

    __del__ = close


def _error(code: int, msg) -> Exception:
    text = msg.value.decode(errors="replace")
    return UnsupportedVideo(f"{text}: {ROADMAP_ENTRY}") if code == 2 else ValueError(text)


def decode_mjpeg(packet: bytes) -> np.ndarray:
    """A Motion-JPEG frame as FFmpeg's mjpeg decoder and swscale give it:
    planar 4:2:0 or 4:2:2 through FFmpeg's IDCT, full-range BT.601 to BGR."""
    from yololite_tpu_torch.data import codecs
    y, u, v = codecs.jpeg_planes(packet)
    h, w = y.shape
    planes = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
    out = np.empty((h, w, 3), np.uint8)
    library().yl_yuv_to_bgr(planes.ctypes.data, w, h, u.shape[0], 1, 2, out.ctypes.data)
    return out


# matrix_coefficients (H.264 Table E-5) swscale does not convert to BGR
UNCONVERTED_MATRICES = {8: "YCgCo", 10: "BT.2020 constant luminance", 11: "SMPTE ST 2085",
                        12: "chromaticity-derived non-constant luminance",
                        13: "chromaticity-derived constant luminance", 14: "ICtCp"}


class H264Decoder:
    """One H.264 stream: packets (access units) in, BGR frames out in
    FFmpeg's output order, each with the tag of the packet that began its
    picture. `extradata` is an avcC record (packets then carry NAL units
    with its length size) or Annex B parameter sets (packets in Annex B)."""

    def __init__(self, extradata: bytes = b""):
        self._lib = lib = h264_library()
        msg, h = ctypes.create_string_buffer(_MSG_LEN), ctypes.c_void_p()
        self._h = None
        self.last_type = -1          # slice type of the last picture begun: 0 P, 1 B, 2 I
        code = lib.yl_h264_open(bytes(extradata), len(extradata), ctypes.byref(h), msg, _MSG_LEN)
        if code:
            raise _error(code, msg)
        self._h = h.value

    def decode(self, packet: bytes, tag: int = 0, planes: bool = False) -> List[Tuple[np.ndarray, int]]:
        """The frames a packet completes, as (BGR [h, w, 3], tag), or with
        `planes` the cropped Y, Cb, Cr concatenated. A packet that does not
        decode raises; the pictures before it stay for `flush`."""
        msg = ctypes.create_string_buffer(_MSG_LEN)
        code = self._lib.yl_h264_decode(self._h, bytes(packet), len(packet), tag, msg, _MSG_LEN)
        self.last_type = self._lib.yl_h264_last_type(self._h)
        if code:
            raise _error(code, msg)
        return self._ready(planes)

    def flush(self, planes: bool = False) -> List[Tuple[np.ndarray, int]]:
        """The pictures still waiting for output, at the end of the stream."""
        msg = ctypes.create_string_buffer(_MSG_LEN)
        code = self._lib.yl_h264_flush(self._h, msg, _MSG_LEN)
        out = self._ready(planes)
        if code:
            raise _error(code, msg)
        return out

    def _ready(self, planes: bool):
        lib, out = self._lib, []
        info = np.zeros(5, np.int64)
        while lib.yl_h264_pending(self._h, info.ctypes.data):
            w, h, full, matrix, tag = (int(v) for v in info)
            buf = np.empty(w * h + 2 * (w // 2) * (h // 2), np.uint8)
            if lib.yl_h264_frame(self._h, buf.ctypes.data, buf.size):
                raise ValueError("no decoded picture")
            if planes:
                out.append((buf, tag))
                continue
            if matrix in UNCONVERTED_MATRICES:
                raise unsupported(f"H.264 with matrix_coefficients {matrix} "
                                  f"({UNCONVERTED_MATRICES[matrix]})")
            bgr = np.empty((h, w, 3), np.uint8)
            library().yl_yuv_to_bgr(buf.ctypes.data, w, h, h // 2, full, matrix, bgr.ctypes.data)
            out.append((bgr, tag))
        return out

    def size(self) -> Optional[Tuple[int, int]]:
        """(w, h) cropped, of the first SPS the decoder holds; None before one."""
        wh = np.zeros(2, np.int32)
        return (int(wh[0]), int(wh[1])) if self._lib.yl_h264_size(self._h, wh.ctypes.data) == 0 else None

    def close(self):
        if getattr(self, "_h", None):
            self._lib.yl_h264_close(self._h)
            self._h = None

    __del__ = close


def mp4_to_annexb(sample: bytes, nal_size: int, ps: Tuple[bytes, bytes], state: dict) -> bytes:
    """A length-prefixed H.264 sample in Annex B as FFmpeg's
    `h264_mp4toannexb` filter writes it: a 4-byte start code for the first
    NAL unit and for SPS/PPS, 3 bytes for the others; and from the `avcC`
    parameter sets `ps` (SPSs, PPSs), both before an IDR slice that begins
    a new IDR picture and has none of its own or before a buffering-period
    SEI with none, the SPSs before a PPS without one, the PPSs before such
    an IDR slice that has an SPS only. `state` carries `new_idr` from
    sample to sample. A NAL unit that runs past the sample raises
    `ValueError`, where the filter fails."""
    sps, pps = ps
    out = bytearray()
    sps_seen = pps_seen = False
    i = 0
    while i + nal_size <= len(sample):
        n = int.from_bytes(sample[i:i + nal_size], "big")
        if n > len(sample) - i - nal_size:
            raise ValueError(f"NAL unit of {n} bytes runs past its sample")
        nal = sample[i + nal_size:i + nal_size + n]
        i += nal_size + n
        if not nal:
            continue
        t = nal[0] & 0x1F
        if t == 7:
            sps_seen = state["new_idr"] = True
        elif t == 8:
            pps_seen = state["new_idr"] = True
            if not sps_seen and sps:
                out += sps
                sps_seen = True
        if not state["new_idr"] and t == 5 and len(nal) > 1 and nal[1] & 0x80:
            state["new_idr"] = True
        if t == 6 and len(nal) > 1 and nal[1] == 0 and not sps_seen and not pps_seen:
            out += sps + pps
            sps_seen, pps_seen = bool(sps), bool(pps)
        if state["new_idr"] and t == 5 and not sps_seen and not pps_seen:
            out += sps + pps
            state["new_idr"] = False
        elif state["new_idr"] and t == 5 and sps_seen and not pps_seen:
            out += pps
        ps_nal = t in (7, 8)
        out += (b"\x00\x00\x00\x01" if not out or ps_nal else b"\x00\x00\x01") + nal
        if t == 1:
            state["new_idr"] = True
            sps_seen = pps_seen = False
    return bytes(out)


class VideoReader:
    """Frames of a video file as `cv2.VideoCapture(path).read()` gives them.

    `fps`, `frame_count`, `size` (w, h) and `codec` as cv2 reports them;
    iterate for BGR uint8 [h, w, 3] frames, `packets()` for the raw samples;
    after a read, `stop_reason` says why it ended early and `cut_short`
    whether the file ends inside a sample. A file that is missing raises `FileNotFoundError`, one that is no video
    container `ValueError`, an unsupported one `UnsupportedVideo`."""

    def __init__(self, path: str):
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        self.path = path
        self.track = probe(path)
        t = self.track
        self.fps, self.frame_count = t.fps, t.frame_count
        self.size, self.codec = (t.width, t.height), t.codec
        self.stop_reason, self.damaged, self.cut_short = None, [], False
        libraries()                     # a missing compiler raises here, not in a read
        if t.codec == "h264":
            self.size = self._h264_size()

    def _h264_size(self):
        """The cropped size of the SPS in the extradata, else the
        container's (an AVI's parameter sets come in band)."""
        dec = H264Decoder(self.track.extradata)
        try:
            return dec.size() or self.size
        finally:
            dec.close()

    def samples(self):
        """The samples of the track in order, as the container stores them.
        A sample that runs past the end of the file is the last, with the
        bytes the file holds (FFmpeg reads it so and stops after it)."""
        with open(self.path, "rb") as f:
            for k, (off, size) in enumerate(self.track.samples):
                f.seek(off)
                data = f.read(size)
                if len(data) < size:
                    self.cut_short = True
                    self.stop_reason = (f"sample {k} of {len(self.track.samples)} is cut short "
                                        f"by the end of the file")
                    if data:
                        yield data
                    return
                yield data

    def packets(self):
        """The packets cv2 yields with `CAP_PROP_FORMAT = -1`: the samples,
        H.264 in an MP4 converted to Annex B as FFmpeg's bitstream filter
        converts it."""
        if self.codec != "h264" or not any(self.track.annexb_ps):
            yield from self.samples()
            return
        nal_size = (self.track.extradata[4] & 3) + 1
        state = {"new_idr": True}
        for sample in self.samples():
            try:
                yield mp4_to_annexb(sample, nal_size, self.track.annexb_ps, state)
            except ValueError:          # a NAL unit cut short: the filter fails, cv2 stops
                return

    def __iter__(self):
        """BGR frames. A picture whose data stops decoding partway comes
        concealed (its index in `damaged`), as FFmpeg conceals and outputs
        it; a packet with no picture that decodes ends the stream. Pictures
        the edit list leaves out are decoded and not yielded."""
        self.stop_reason, self.damaged, self.cut_short = None, [], False
        shown = self.track.shown
        if self.codec == "h264":
            yield from (f for f, k in self._h264() if shown is None or shown[k])
            return
        dec = Mpeg4Decoder(self.track.extradata) if self.codec == "mp4v" else None
        try:
            for k, pkt in enumerate(self.samples()):
                try:
                    frame = dec.decode(pkt) if dec is not None else decode_mjpeg(pkt)
                except ValueError as e:
                    self.stop_reason = f"packet {k} does not decode: {e}"
                    return
                if dec is not None and dec.damage:
                    self.damaged.append(k)
                if frame is not None and (shown is None or shown[k]):
                    yield frame
        finally:
            if dec is not None:
                dec.close()

    def _h264(self):
        """(frame, sample index) in output order. At a sample that does not
        decode, the whole pictures before it, then the end; in a file cut
        short the pictures still held are not handed out, as cv2's reader
        stops at the demuxer's error without draining its decoder."""
        dec = H264Decoder(self.track.extradata)
        try:
            for k, sample in enumerate(self.samples()):
                try:
                    yield from dec.decode(sample, k)
                except ValueError as e:
                    self.stop_reason = self.stop_reason or f"packet {k} does not decode: {e}"
                    break
            if self.cut_short:
                return
            try:
                yield from dec.flush()
            except ValueError as e:
                self.stop_reason = self.stop_reason or f"the last picture does not decode: {e}"
        finally:
            dec.close()


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #

def _rate(fps: float) -> Fraction:
    """fps as ticks a second over ticks a frame, as the VOL's 16-bit
    vop_time_increment_resolution holds it."""
    r = Fraction(fps).limit_denominator(1001)
    if r <= 0 or r.numerator > 65535:
        raise ValueError(f"frame rate {fps} cannot be written as MPEG-4 Part 2")
    return r


class Mpeg4Encoder:
    """MPEG-4 Part 2 I-VOPs of BGR frames of one size at a fixed quantizer.
    An odd width or height is coded one smaller (the last column or row is
    dropped), as cv2.VideoWriter codes such frames at the even size below."""

    def __init__(self, size, fps: float):
        self.in_w, self.in_h = int(size[0]), int(size[1])
        self.w, self.h = self.in_w & ~1, self.in_h & ~1
        if not self.w or not self.h:
            raise ValueError(f"frame size {size} is too small to write")
        self.rate = _rate(fps)
        self.n = 0
        res = self.rate.numerator
        self.inc_bits = max(1, (res - 1).bit_length())
        out = np.empty(64, np.uint8)
        k = library().yl_m4v_headers(self.w, self.h, res, out.ctypes.data, out.size)
        self.headers = out[:k].tobytes()
        self._last_second = 0

    def crop(self, frame_bgr: np.ndarray) -> np.ndarray:
        """The frame as it is coded (checked against the size given)."""
        if frame_bgr.shape != (self.in_h, self.in_w, 3) or frame_bgr.dtype != np.uint8:
            raise ValueError(f"frame {frame_bgr.shape} {frame_bgr.dtype} differs from the "
                             f"video's ({self.in_h}, {self.in_w}, 3) uint8")
        return frame_bgr[:self.h, :self.w]

    def encode(self, frame_bgr: np.ndarray) -> bytes:
        """One I-VOP of a frame of the size given."""
        return self._encode(self.crop(frame_bgr))

    def _encode(self, frame_bgr: np.ndarray) -> bytes:
        res, per = self.rate.numerator, self.rate.denominator
        ticks = self.n * per
        second, inc = divmod(ticks, res)
        modulo, self._last_second = second - self._last_second, second
        src = np.ascontiguousarray(frame_bgr)
        cap = self.w * self.h * 8 + 4096
        out = np.empty(cap, np.uint8)
        k = library().yl_m4v_encode(src.ctypes.data, 0, self.w, self.h, WRITER_QUANT, modulo,
                                    inc, self.inc_bits, out.ctypes.data, cap)
        if k < 0:
            raise ValueError("encoded frame larger than its buffer")
        self.n += 1
        return out[:k].tobytes()


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


class Mp4Muxer:
    """One video track in an MP4: `ftyp`, `mdat` as the samples come, `moov`
    (with `mp4v`/`esds`) written by `close`."""

    def __init__(self, path: str, size, rate: Fraction, extradata: bytes):
        self.w, self.h = size
        self.rate, self.extradata = rate, extradata
        self.f = open(path, "wb")
        self.f.write(_box(b"ftyp", b"isom", struct.pack(">I", 512), b"isomiso2mp41"))
        self.mdat = self.f.tell()
        self.f.write(struct.pack(">I4sQ", 1, b"mdat", 0))     # 64-bit size, set by close
        self.samples: List[Tuple[int, int]] = []

    def write(self, data: bytes) -> None:
        self.samples.append((self.f.tell(), len(data)))
        self.f.write(data)

    def close(self) -> None:
        if self.f is None:
            return
        end = self.f.tell()
        self.f.seek(self.mdat + 8)
        self.f.write(struct.pack(">Q", end - self.mdat))
        self.f.seek(end)
        self.f.write(self._moov())
        self.f.close()
        self.f = None

    def _moov(self) -> bytes:
        n, w, h = len(self.samples), self.w, self.h
        ts, per = self.rate.numerator, self.rate.denominator
        dur = n * per
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, ts, dur),
                     struct.pack(">IH10x", 0x10000, 0x100), matrix, b"\x00" * 24,
                     struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, dur), b"\x00" * 8,
                     struct.pack(">hhHH", 0, 0, 0, 0), matrix, struct.pack(">II", w << 16, h << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, ts, dur, 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"VideoHandler\x00")
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
        dcd = _desc(0x04, bytes([0x20, 0x11]) + struct.pack(">I", 0)[1:] + struct.pack(">II", 0, 0)
                    + _desc(0x05, self.extradata))
        esds = _full(b"esds", 0, 0, _desc(0x03, struct.pack(">HB", 1, 0) + dcd + _desc(0x06, b"\x02")))
        entry = _box(b"mp4v", b"\x00" * 6, struct.pack(">H", 1), b"\x00" * 16,
                     struct.pack(">HHIII", w, h, 0x480000, 0x480000, 0), struct.pack(">H", 1),
                     b"\x00" * 32, struct.pack(">Hh", 24, -1), esds)
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, per))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                     struct.pack(f">{n}I", *[s for _, s in self.samples]))
        offs = [o for o, _ in self.samples]
        if offs and offs[-1] >= 1 << 32:
            stco = _full(b"co64", 0, 0, struct.pack(">I", n), struct.pack(f">{n}Q", *offs))
        else:
            stco = _full(b"stco", 0, 0, struct.pack(">I", n), struct.pack(f">{n}I", *offs))
        stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)
        minf = _box(b"minf", _full(b"vmhd", 0, 1, b"\x00" * 8), dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)


WRITE_EXTENSIONS = (".mp4", ".m4v", ".mov", ".avi")


class VideoWriter:
    """BGR frames of one size written as MPEG-4 Part 2 at `fps`, into an MP4
    (`.mp4`, `.m4v`, `.mov`) or an AVI (`.avi`, FourCC FMP4); any other
    extension raises `ValueError`."""

    def __init__(self, path: str, fps: float, size):
        ext = os.path.splitext(path)[1].lower()
        if ext not in WRITE_EXTENSIONS:
            raise ValueError(f"{path}: the video writer writes {', '.join(WRITE_EXTENSIONS)}")
        self.enc = Mpeg4Encoder(size, fps)
        coded = (self.enc.w, self.enc.h)
        if ext == ".avi":
            from yololite_tpu_torch.data.imwrite import AviWriter
            headers = self.enc.headers
            self.mux = AviWriter(path, fps, coded, fourcc=b"FMP4",
                                 encode=lambda frame: headers + self.enc._encode(frame))
            self._write = lambda frame: self.mux.write(self.enc.crop(frame))
        else:
            self.mux = Mp4Muxer(path, coded, self.enc.rate, self.enc.headers)
            self._write = lambda frame: self.mux.write(self.enc.encode(frame))

    def write(self, frame_bgr: np.ndarray) -> None:
        self._write(frame_bgr)

    def close(self) -> None:
        self.mux.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
