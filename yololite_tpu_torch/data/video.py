"""Video files: read MP4/MOV, AVI, Matroska/WebM, MPEG-TS/M2TS and raw
H.264/HEVC Annex B as `cv2.VideoCapture` reads them, and write MPEG-4 Part 2
("mp4v") as `cv2.VideoWriter(path, "mp4v", ...)` does.

Containers are parsed here and in `mkv.py`, `mpegts.py` and `esparse.py`,
in the standard library; `sniff` picks one by content, as FFmpeg probes:

  - ISO BMFF (`ftyp`: `.mp4`, `.m4v`, `.mov`): the first video track of
    `moov` (which may come after `mdat`), its sample description (`mp4v`
    with the `esds` DecoderSpecificInfo, the VOL; `jpeg`/`mjpa`, or `mp4v`
    whose object type is JPEG, for Motion-JPEG; `avc1`/`avc3` with `avcC`
    for H.264; `hvc1`/`hev1`, and Dolby Vision's `dvh1`/`dvhe`, with
    `hvcC` for HEVC), its sample table (`stts`, `ctts`, `stss`, `stsc`, `stsz`,
    `stco`/`co64`) and its edit list (`edts/elst`), applied as FFmpeg's
    mov demuxer applies one edit: samples from the last key frame at or
    before the edit's start, pictures shown from its start to its end.
    Movie fragments follow the samples of `moov` (none with `empty_moov`):
    `mvex/trex` defaults, `moof/traf` with `tfhd` (base data offset,
    default-base-is-moof, or the end of the previous run), `tfdt` and
    `trun`; `sidx` and `mfra` are not needed;
  - RIFF AVI: `hdrl/avih/strl/strh/strf`, then the video stream's
    `##dc`/`##db` chunks of `movi`, by `idx1` where present and else by
    walking `movi`; OpenDML files by the `indx` super index and its `ix##`
    standard indexes, else by walking the `movi` of every `AVIX` RIFF;
    FMP4/XVID/DIVX/DX50/MP4V as MPEG-4 Part 2, MJPG as Motion-JPEG,
    H264/X264/avc1 as H.264 and HEVC/H265/hvc1/hev1 (any case) as HEVC,
    both in Annex B;
  - Matroska and WebM (`mkv.py`): H.264 (avcC), HEVC (hvcC), MPEG-4 Part 2,
    Motion-JPEG and `V_MS/VFW/FOURCC`, laced, header-stripped or zlib
    frames, unknown sizes and files cut short;
  - MPEG-TS and M2TS (`mpegts.py`) and raw Annex B H.264/HEVC: the
    elementary stream cut into packets as FFmpeg's parsers cut it
    (`esparse.py`).

The reader reports `fps` (`CAP_PROP_FPS`, FFmpeg's `avg_frame_rate`: the
track's frame count over its `stts` duration in an MP4, `rate / scale` of
the stream in an AVI, FFmpeg's estimate elsewhere, 25 for raw Annex B),
`frame_count` (`CAP_PROP_FRAME_COUNT`: the samples of `moov`, the stream's
length in an AVI, else the duration x fps, rounded; the packets where cv2's
count has no meaning), `size` (w, h, H.264's and HEVC's cropped) and
`codec`. Its packets are byte for byte what cv2 yields with
`CAP_PROP_FORMAT = -1`: the container's samples (a TS's or raw stream's as
FFmpeg's parser cuts them), and for H.264 in an MP4 or Matroska file those
samples in Annex B as FFmpeg's `h264_mp4toannexb` filter writes them
(the `avcC` parameter sets before each IDR picture that does not carry its
own), for HEVC as `hevc_mp4toannexb` writes them (4-byte start codes, the
`hvcC` arrays before the first IRAP slice of a sample).

Frames decode on the host in C++ (`csrc/videocodec.cpp` for MPEG-4 Part 2,
`csrc/imgcodec.cpp` for the planes of a Motion-JPEG frame, `csrc/h264dec.cpp`
for progressive 8-bit 4:2:0 H.264 of the Baseline, Main and High profiles,
`csrc/hevcdec.cpp` for HEVC Main, Main 10 and Main Still Picture), built at
first use (`csrc/build.py`), to BGR uint8 as cv2.VideoCapture gives them:
FFmpeg's decoders (simple IDCT, its MPEG-4 prediction and motion
compensation; H.264's and HEVC's normative decoding and FFmpeg's output
order) and swscale's YUV -> BGR24 conversion (limited range for MPEG-4, full
range for Motion-JPEG, H.264's and HEVC's signalled range and matrix, chroma
not interpolated at 8 bits, 10 bits as `to_bgr` says). A
sample that is missing from the file or does not decode ends the stream,
where cv2's `read` returns False; an H.264 or HEVC decoder hands out the
pictures it still holds first.

What is not read raises `UnsupportedVideo` naming it: VP8/VP9/AV1 (in
WebM/Matroska, MP4 or AVI), MPEG-1/2 video and the other codecs of a
Matroska track or a TS stream type, encrypted content (`encv`, `senc`,
Matroska's ContentEncryption), Matroska's bzlib/LZO compression, several
edits in one edit list, any other codec; within MPEG-4 Part 2
B-VOPs, quarter-pel, GMC, interlace, data partitioning and RVLC; within
H.264 interlaced coding (fields, MBAFF), bit depths above 8, chroma other
than 4:2:0, lossless coding, SP/SI slices, data partitioning, slice groups
and colour matrices swscale does not convert; within HEVC bit depths other
than 8 and 10, chroma other than 4:2:0, the range and screen content
extensions, tiles, PCM, dependent slice segments, long-term reference
pictures and reference list modification; and in both the frames cv2 5.0
converts colour-managed (wide-gamut primaries, PQ, HLG; `to_bgr`) (ROADMAP,
"When a user needs them": video codecs).

`VideoWriter` encodes each BGR frame as an MPEG-4 Part 2 I-VOP (Simple
Profile, H.263 quantization at a fixed quantizer, BT.601 limited range,
chroma from each 2x2 mean) and muxes it into an MP4 (`.mp4`, `.m4v`,
`.mov`: `ftyp`, `mdat`, then `moov` with `mp4v`/`esds`), an AVI (`.avi`,
FourCC `FMP4`) or a Matroska file (`.mkv`, `mkv.MkvMuxer`), as the JAX
tracker's `cv2.VideoWriter(..., "mp4v")` writes them; the bytes differ
from FFmpeg's, which rate-controls P-VOPs. `.ts`, `.m2ts`, `.mpg` and
`.3gp`, which cv2 also writes, raise by name.
"""

from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

ROADMAP_ENTRY = "ROADMAP, 'When a user needs them' (video codecs)"
SNIFF_BYTES = 1 << 20               # FFmpeg's largest probe
WRITER_QUANT = 2                     # the writer's fixed quantizer (vop_quant)
_MSG_LEN = 256

MPEG4_TAGS = {b"FMP4", b"XVID", b"DIVX", b"DX50", b"MP4V", b"mp4v", b"xvid", b"divx",
              b"fmp4", b"M4S2", b"3IV2", b"DIV5"}
MJPEG_TAGS = {b"MJPG", b"mjpg", b"jpeg", b"mjpa", b"AVRn", b"dmb1"}
H264_TAGS = {b"H264", b"h264", b"X264", b"x264", b"avc1", b"AVC1"}
# HEVC: the MP4 sample entries FFmpeg's mov demuxer maps to it (Dolby
# Vision's dvh1/dvhe too) and the AVI FourCCs of FFmpeg's riff tags,
# which it matches without regard to case
HEVC_ENTRIES = {b"hvc1", b"hev1", b"dvh1", b"dvhe"}
HEVC_FOURCCS = {b"HEVC", b"H265", b"HVC1", b"HEV1"}
NAMED_CODECS = {
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
_HEVC = None


class UnsupportedVideo(NotImplementedError):
    """A container, codec or coding tool this package does not read."""


def unsupported(what: str) -> UnsupportedVideo:
    return UnsupportedVideo(f"{what} is not decoded by this package (it reads MPEG-4 Part 2 "
                            f"Simple Profile, Motion-JPEG, progressive 8-bit 4:2:0 H.264 and "
                            f"8- and 10-bit 4:2:0 HEVC in MP4/MOV (fragmented too), AVI "
                            f"(OpenDML too), Matroska/WebM, MPEG-TS/M2TS and raw Annex B): "
                            f"{ROADMAP_ENTRY}")


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
        lib.yl_yuv10_to_bgr.argtypes = [ptr, i32, i32, i32, i32, ptr]
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
    build(["videocodec", "imgcodec", "h264dec", "hevcdec"])
    library()
    h264_library()
    hevc_library()
    codecs.library()


def _decoder_library(name: str, prefix: str, frame_args: int) -> ctypes.CDLL:
    """The built library `name` with its `yl_<prefix>_*` decoder functions
    typed (`frame_args`: the arguments of `yl_<prefix>_frame`)."""
    from yololite_tpu_torch.csrc.build import load
    lib = load(name)
    buf, ptr, i32, i64 = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    types = {"open": ([buf, i64, ctypes.POINTER(ptr), buf, i32], ctypes.c_int),
             "close": ([ptr], None), "decode": ([ptr, buf, i64, i64, buf, i32], ctypes.c_int),
             "flush": ([ptr, buf, i32], ctypes.c_int), "pending": ([ptr, ptr], i32),
             "frame": ([ptr, ptr, i64, i32][:frame_args], i32), "last_type": ([ptr], i32),
             "size": ([ptr, ptr], i32)}
    for fn, (args, res) in types.items():
        f = getattr(lib, f"yl_{prefix}_{fn}")
        f.argtypes, f.restype = args, res
    return lib


def h264_library() -> ctypes.CDLL:
    """The built `h264dec` library with its C functions typed."""
    global _H264
    if _H264 is None:
        _H264 = _decoder_library("h264dec", "h264", 3)
    return _H264


def hevc_library() -> ctypes.CDLL:
    """The built `hevcdec` library with its C functions typed."""
    global _HEVC
    if _HEVC is None:
        _HEVC = _decoder_library("hevcdec", "hevc", 4)
    return _HEVC


def sniff(head: bytes, name: str = "") -> str:
    """The container by content, as FFmpeg probes it: "mp4" (ISO BMFF),
    "avi", "ebml" (WebM/Matroska), "ts" (MPEG-TS, M2TS), "h264" or "hevc"
    (a raw Annex B stream: FFmpeg's probe of it, or the extension of
    `name` where the probe finds nothing else), or "" (anything else).
    `head` is the file's first bytes (`SNIFF_BYTES`)."""
    from yololite_tpu_torch.data import esparse, mpegts
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"wide", b"free", b"skip", b"styp", b"moof",
                     b"sidx"):
        return "mp4"
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "ebml"
    if mpegts.packet_layout(head):
        return "ts"
    return esparse.sniff_raw(head, name)


class Sample(NamedTuple):
    """One sample of a track: `size` bytes at `offset` of the track's
    source (the file, or a TS's elementary stream), zlib-compressed when
    `inflate`, after the bytes `prefix` (Matroska's stripped header)."""
    offset: int
    size: int
    prefix: bytes = b""
    inflate: bool = False


@dataclass
class Track:
    """The first video track of a file."""
    codec: str                       # "mp4v", "mjpeg", "h264" or "hevc"
    width: int
    height: int
    fps: float
    frame_count: int
    extradata: bytes = b""
    samples: List[Sample] = field(default_factory=list)
    shown: Optional[List[bool]] = None   # per sample: its picture is shown (edit list)
    annexb_ps: Tuple[bytes, bytes] = (b"", b"")   # in MP4: avcC's SPSs, PPSs, or hvcC's NAL units, in Annex B
    source: Optional[Callable] = None   # the open file -> what the offsets count in, if not it


def _codec_of(tag: bytes) -> str:
    if tag in MPEG4_TAGS:
        return "mp4v"
    if tag in MJPEG_TAGS:
        return "mjpeg"
    if tag in H264_TAGS:
        return "h264"
    if tag.upper() in HEVC_FOURCCS:
        return "hevc"
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


def _need(data: bytes, start: int, end: int, kind: bytes):
    """The child box `kind`, which the file must have."""
    box = _child(data, start, end, kind)
    if box is None:
        raise ValueError(f"no '{kind.decode('latin1')}' box")
    return box


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
    moov, moofs = None, []
    for kind, off, size in _top_level(f, file_size):
        if kind == b"moof":
            f.seek(off)
            moofs.append((off - 8, f.read(min(size, file_size - off))))
        if kind == b"moov" and moov is None:
            f.seek(off)
            moov = f.read(min(size, file_size - off))
    if moov is None:
        raise ValueError("no 'moov' box")
    mvhd = _child(moov, 0, len(moov), b"mvhd")
    movie_scale = 0
    if mvhd:
        ver = moov[mvhd[0]]
        movie_scale = struct.unpack(">I", moov[mvhd[0] + (20 if ver == 1 else 12):][:4])[0]
    mvex = _child(moov, 0, len(moov), b"mvex")
    trex = {}
    for kind, s, e in _boxes(moov, *mvex) if mvex else ():
        if kind == b"trex" and e - s >= 24:
            tid, _, dur, size, flags = struct.unpack(">IIIII", moov[s + 4:s + 24])
            trex[tid] = (dur, size, flags)
    for kind, s, e in _boxes(moov, 0, len(moov)):
        if kind != b"trak":
            continue
        mdia = _child(moov, s, e, b"mdia")
        hdlr = mdia and _child(moov, *mdia, b"hdlr")
        if not hdlr or moov[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _mp4_track(moov, (s, e), mdia, movie_scale, moofs, trex, file_size)
    raise ValueError("no video track")


# trun flags, tfhd flags (ISO/IEC 14496-12 8.8.7, 8.8.8)
TRUN_DATA_OFFSET, TRUN_FIRST_FLAGS, TRUN_DURATION, TRUN_SIZE, TRUN_FLAGS, TRUN_CTS = (
    0x1, 0x4, 0x100, 0x200, 0x400, 0x800)
TFHD_BASE_OFFSET, TFHD_DESC, TFHD_DURATION, TFHD_SIZE, TFHD_FLAGS, TFHD_BASE_IS_MOOF = (
    0x1, 0x2, 0x8, 0x10, 0x20, 0x20000)
SAMPLE_NON_SYNC, SAMPLE_DEPENDS_YES = 0x10000, 0x1000000


def _fragments(moofs, track_id: int, trex, start_dts: int, file_size: int):
    """The samples of one track in the movie fragments, as FFmpeg's mov
    demuxer reads `moof/traf` (`tfhd` defaults over `trex`'s, `tfdt`,
    `trun`): each as (offset, size, dts, cts, key, duration). A run lists
    at most one sample a byte of the file after its data offset, and one
    without per-sample sizes no empty samples; its samples that start past
    the end of the file are not listed (cv2 stops at the first sample cut
    short)."""
    out = []
    dts = start_dts
    d_dur, d_size, d_flags = trex.get(track_id, (0, 0, 0))
    for moof_off, m in moofs:
        implicit = moof_off
        for kind, s, e in _boxes(m, 0, len(m)):
            if kind != b"traf":
                continue
            tfhd = _child(m, s, e, b"tfhd")
            if tfhd is None:
                continue
            p = tfhd[0]
            flags = int.from_bytes(m[p + 1:p + 4], "big")
            if struct.unpack(">I", m[p + 4:p + 8])[0] != track_id:
                continue
            if _child(m, s, e, b"senc"):
                raise unsupported("encrypted fragmented MP4 ('senc')")
            q = p + 8
            base = implicit
            if flags & TFHD_BASE_OFFSET:
                base = struct.unpack(">Q", m[q:q + 8])[0]
                q += 8
            elif flags & TFHD_BASE_IS_MOOF:
                base = moof_off
            if flags & TFHD_DESC:
                q += 4
            dur, size, sflags = d_dur, d_size, d_flags
            for bit, name in ((TFHD_DURATION, "dur"), (TFHD_SIZE, "size"), (TFHD_FLAGS, "flags")):
                if flags & bit:
                    v = struct.unpack(">I", m[q:q + 4])[0]
                    q += 4
                    if name == "dur":
                        dur = v
                    elif name == "size":
                        size = v
                    else:
                        sflags = v
            tfdt = _child(m, s, e, b"tfdt")
            if tfdt is not None:
                ver = m[tfdt[0]]
                dts = (struct.unpack(">Q", m[tfdt[0] + 4:tfdt[0] + 12])[0] if ver == 1
                       else struct.unpack(">I", m[tfdt[0] + 4:tfdt[0] + 8])[0])
            for tk, ts, te in _boxes(m, s, e):
                if tk != b"trun":
                    continue
                ver = m[ts]
                tflags = int.from_bytes(m[ts + 1:ts + 4], "big")
                n = struct.unpack(">I", m[ts + 4:ts + 8])[0]
                q = ts + 8
                offset = base
                if tflags & TRUN_DATA_OFFSET:
                    offset = base + struct.unpack(">i", m[q:q + 4])[0]
                    q += 4
                first = None
                if tflags & TRUN_FIRST_FLAGS:
                    first = struct.unpack(">I", m[q:q + 4])[0]
                    q += 4
                fields = [b for b in (TRUN_DURATION, TRUN_SIZE, TRUN_FLAGS, TRUN_CTS) if tflags & b]
                if q + 4 * len(fields) * n > te:
                    raise ValueError("'trun' runs past its box")
                if n > max(file_size - offset, 0) or (n and not size and not tflags & TRUN_SIZE):
                    raise ValueError(f"'trun' lists {n} samples at {offset} of a "
                                     f"{file_size}-byte file")
                for k in range(n):
                    if offset >= file_size:
                        break
                    sd, ss, sf, co = dur, size, sflags, 0
                    if k == 0 and first is not None:
                        sf = first
                    for b in fields:
                        v = m[q:q + 4]
                        q += 4
                        if b == TRUN_DURATION:
                            sd = struct.unpack(">I", v)[0]
                        elif b == TRUN_SIZE:
                            ss = struct.unpack(">I", v)[0]
                        elif b == TRUN_FLAGS:
                            sf = struct.unpack(">I", v)[0]
                        else:
                            co = struct.unpack(">i" if ver else ">I", v)[0]
                    key = not sf & (SAMPLE_NON_SYNC | SAMPLE_DEPENDS_YES)
                    out.append((offset, ss, dts, dts + co, key, sd))
                    offset += ss
                    dts += sd
                implicit = offset
    return out


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


def _hvcc(record: bytes):
    """(NAL length size, (its NAL units in Annex B with 4-byte start codes,
    b"")) of an HEVCDecoderConfigurationRecord, as FFmpeg's
    `hevc_mp4toannexb` filter lays out its extradata: the arrays in order."""
    if len(record) < 23 or record[0] != 1:
        raise ValueError("'hvcC' is not an HEVCDecoderConfigurationRecord")
    out, i = b"", 23
    for _ in range(record[22]):
        if i + 3 > len(record):
            raise ValueError("'hvcC' cut short")
        n = struct.unpack(">H", record[i + 1:i + 3])[0]
        i += 3
        for _ in range(n):
            size = struct.unpack(">H", record[i:i + 2])[0]
            if i + 2 + size > len(record):
                raise ValueError("'hvcC' cut short")
            out += b"\x00\x00\x00\x01" + record[i + 2:i + 2 + size]
            i += 2 + size
    return (record[21] & 3) + 1, (out, b"")


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


def _mp4_track(m: bytes, trak, mdia, movie_scale: int, moofs, trex, file_size: int) -> Track:
    mdhd = _need(m, *mdia, b"mdhd")
    ver = m[mdhd[0]]
    timescale = struct.unpack(">I", m[mdhd[0] + (20 if ver == 1 else 12):][:4])[0]
    minf = _need(m, *mdia, b"minf")
    stbl = _need(m, *minf, b"stbl")
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
    elif tag in HEVC_ENTRIES:
        hvcc = _child(m, es + 78, ee, b"hvcC")
        if hvcc is None:
            raise unsupported(f"HEVC ({tag.decode('latin1')!r}) without an 'hvcC' record")
        codec, extradata = "hevc", bytes(m[hvcc[0]:hvcc[1]])
        _, annexb_ps = _hvcc(extradata)
    elif tag in (b"encv", b"encm"):
        raise unsupported("encrypted video")
    else:
        codec = _codec_of(tag)
    # stsz; the samples listed are those the file can hold (nb_frames counts all)
    s, _ = box[b"stsz"]
    const, nsamp = struct.unpack(">II", m[s + 4:s + 12])
    limit = min(nsamp, file_size // const + 1) if const else nsamp
    sizes = ([const] * limit if const else
             list(struct.unpack(f">{nsamp}I", m[s + 12:s + 12 + 4 * nsamp])))
    # stts: decoding times
    s, _ = box[b"stts"]
    n = struct.unpack(">I", m[s + 4:s + 8])[0]
    total, count, dts = 0, 0, []
    for i in range(n):
        c, d = struct.unpack(">II", m[s + 8 + 8 * i:s + 16 + 8 * i])
        take = max(min(c, limit - len(dts)), 0)
        dts.extend(range(total, total + take * d, d) if d else [total] * take)
        total += c * d
        count += c
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
                if k >= limit:
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
            for t in range(i, min(i + c, len(cts))):
                cts[t] += o
            i += c
    keys = [True] * len(samples)
    if b"stss" in box:
        s, _ = box[b"stss"]
        n = struct.unpack(">I", m[s + 4:s + 8])[0]
        keys = [False] * len(samples)
        for j in struct.unpack(f">{n}I", m[s + 8:s + 8 + 4 * n]):
            if 0 < j <= len(keys):
                keys[j - 1] = True
    fps = float(Fraction(timescale * count, total)) if total and timescale else 0.0
    frame_count = nsamp
    if moofs:
        tkhd = _need(m, *trak, b"tkhd")
        tver = m[tkhd[0]]
        track_id = struct.unpack(">I", m[tkhd[0] + (20 if tver == 1 else 12):][:4])[0]
        frag = _fragments(moofs, track_id, trex or {}, total, file_size)
        samples += [(o, n) for o, n, _, _, _, _ in frag]
        dts += [d for _, _, d, _, _, _ in frag]
        cts += [c for _, _, _, c, _, _ in frag]
        keys += [k for _, _, _, _, k, _ in frag]
        if not nsamp and frag and timescale:
            # no nb_frames: cv2 counts the fragments' duration x FFmpeg's estimated rate
            from yololite_tpu_torch.data import esparse
            durations = [d for _, _, _, _, _, d in frag]
            tb = Fraction(1, timescale)
            fps = float(esparse.avg_rate(durations[:esparse.ANALYZED], dts[:esparse.ANALYZED], tb))
            us = round(Fraction(sum(durations) * 10 ** 6, timescale))
            frame_count = esparse.frame_count(us / 1e6, fps)
    first, shown = _apply_edit(dts, cts, keys, _edit_list(m, trak, timescale, movie_scale))
    return Track(codec, width, height, fps, frame_count, extradata,
                 [Sample(o, n) for o, n in samples[first:]], shown, annexb_ps)


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
            hdrl = f.read(max(min(size, file_size - off), 0))
        elif kind == b"movi" and movi is None:
            movi = (off - 4, off, off + size)
        elif cid == b"idx1":
            f.seek(off)
            idx1 = f.read(max(min(size, file_size - off), 0))
    extended = []                      # the 'movi' lists of the OpenDML 'AVIX' RIFFs
    pos = riff_end + (riff_end & 1)
    while pos + 12 <= file_size:
        f.seek(pos)
        more = f.read(12)
        if more[:4] != b"RIFF" or more[8:12] != b"AVIX":
            break
        end = pos + 8 + struct.unpack("<I", more[4:8])[0]
        for cid, kind, off, size in _chunks(f, pos + 12, min(end, file_size)):
            if kind == b"movi":
                extended.append((off, off + size))
        pos = end + (end & 1)
    if hdrl is None or movi is None:
        raise ValueError("AVI without 'hdrl' or 'movi'")
    stream, track = 0, None
    pos = 0
    while pos + 8 <= len(hdrl):
        cid, size = struct.unpack("<4sI", hdrl[pos:pos + 8])
        if cid == b"LIST" and hdrl[pos + 8:pos + 12] == b"strl":
            body = hdrl[pos + 12:pos + 8 + size]
            strh = strf = indx = None
            q = 0
            while q + 8 <= len(body):
                c2, s2 = struct.unpack("<4sI", body[q:q + 8])
                if c2 == b"strh":
                    strh = body[q + 8:q + 8 + s2]
                elif c2 == b"strf":
                    strf = body[q + 8:q + 8 + s2]
                elif c2 == b"indx":
                    indx = body[q + 8:q + 8 + s2]
                q += 8 + s2 + (s2 & 1)
            if strh is not None and strh[:4] == b"vids":
                if strf is None or len(strf) < 20:
                    raise ValueError("AVI video stream without a BITMAPINFOHEADER ('strf')")
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
    samples = _odml_index(f, file_size, indx) if indx else []
    if not samples and idx1:
        entries = [struct.unpack("<4sIII", idx1[i:i + 16]) for i in range(0, len(idx1) - 15, 16)]
        mine = [e for e in entries if e[0] in ids]
        if mine:
            # offsets from the 'movi' fourcc, or absolute (FFmpeg's check)
            base = movi_fourcc if mine[0][2] < movi_fourcc else 0
            samples = [(base + off + 8, size) for _, _, off, size in mine]
    def walk(start, end):
        for cid, kind, off, size in _chunks(f, start, end):
            if kind == b"rec ":
                walk(off, off + size)
            elif cid in ids:
                samples.append((off, size))

    if not samples:
        walk(movi_start, min(movi_end, file_size))
    if extended and not indx:
        for start, end in extended:
            walk(start, min(end, file_size))
    if not track.frame_count:
        track.frame_count = len(samples)
    track.samples = [Sample(o, n) for o, n in samples]
    return track


def _odml_index(f, file_size: int, indx: bytes) -> List[Tuple[int, int]]:
    """The samples an OpenDML super index ('indx') lists, through each
    standard index ('ix##') it points to, as FFmpeg's read_odml_index reads
    them; [] where it is not one."""
    if len(indx) < 24 or indx[3] != 0:             # AVI_INDEX_OF_INDEXES
        return []
    n = struct.unpack("<I", indx[4:8])[0]
    out = []
    for k in range(min(n, (len(indx) - 24) // 16)):
        off, size, _ = struct.unpack("<QII", indx[24 + 16 * k:40 + 16 * k])
        if off + 8 + 24 > file_size:
            break
        f.seek(off + 8)
        ix = f.read(min(size, file_size - off - 8) if size else 24)
        if len(ix) < 24 or ix[3] != 1:            # AVI_INDEX_OF_CHUNKS
            break
        per, entries, base = struct.unpack("<H", ix[0:2])[0], struct.unpack("<I", ix[4:8])[0], \
            struct.unpack("<Q", ix[12:20])[0]
        if per != 2:
            raise unsupported("an OpenDML field index")
        for j in range(min(entries, (len(ix) - 24) // 8)):
            rel, length = struct.unpack("<II", ix[24 + 8 * j:32 + 8 * j])
            out.append((base + rel, length & 0x7FFFFFFF))
    return out


# --------------------------------------------------------------------------- #
# reader
# --------------------------------------------------------------------------- #

def probe(path: str) -> Track:
    """The first video track of the file at `path`. A file that is not a
    container raises `ValueError`; a container or codec this package does
    not read raises `UnsupportedVideo`."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        kind = sniff(f.read(SNIFF_BYTES), os.path.basename(path))
        f.seek(0)
        demux = {"mp4": demux_mp4, "avi": demux_avi, "ebml": demux_mkv, "ts": demux_ts,
                 "h264": lambda f, n: demux_annexb(f, n, "h264"),
                 "hevc": lambda f, n: demux_annexb(f, n, "hevc")}.get(kind)
        if demux is not None:
            try:
                return demux(f, size)
            except (IndexError, KeyError, struct.error, EOFError, OverflowError) as e:
                raise ValueError(f"{path}: damaged {kind} container ({type(e).__name__}: "
                                 f"{e})") from e
    raise ValueError(f"{path}: not a video container this package reads (MP4/MOV, AVI, "
                     f"Matroska/WebM, MPEG-TS/M2TS, raw H.264/HEVC)")


def demux_mkv(f, file_size: int) -> Track:
    """Matroska/WebM (`data/mkv.py`)."""
    from yololite_tpu_torch.data import mkv
    d = mkv.demux(f, file_size)
    annexb_ps = (b"", b"")              # V_MS/VFW/FOURCC: Annex B, as in an AVI
    if d.codec == "h264" and not d.tag:
        annexb_ps = _avcc(d.extradata)[1]
    elif d.codec == "hevc" and not d.tag:
        annexb_ps = _hvcc(d.extradata)[1]
    return Track(d.codec, d.width, d.height, d.fps, d.frame_count, d.extradata,
                 d.samples, None, annexb_ps)


def stream_headers(codec: str, first: bytes) -> bytes:
    """What an Annex B stream's first packet holds before its first picture:
    the parameter sets (4-byte start codes) for H.264 and HEVC, the VOS and
    VOL for MPEG-4 Part 2; the decoder opens with them, as FFmpeg opens its
    decoder with the extradata it extracts from the stream."""
    from yololite_tpu_torch.data import esparse
    if codec == "mp4v":
        vop = first.find(b"\x00\x00\x01\xb6")
        return bytes(first[:vop if vop >= 0 else len(first)])
    kinds = (7, 8) if codec == "h264" else (32, 33, 34)
    nals = [n for n in esparse.nal_units(first) if n]
    keep = [n for n in nals if (n[0] & 0x1F if codec == "h264" else (n[0] >> 1) & 0x3F) in kinds]
    return b"".join(b"\x00\x00\x00\x01" + n for n in keep)


def demux_ts(f, file_size: int) -> Track:
    """MPEG-TS or M2TS (`data/mpegts.py`)."""
    from yololite_tpu_torch.data import mpegts
    f.seek(0)
    layout = mpegts.packet_layout(f.read(SNIFF_BYTES))
    d = mpegts.demux(f, file_size, layout)
    es = d.source(f)
    es.seek(d.samples[0].offset)
    first = es.read(d.samples[0].size)
    return Track(d.codec, 0, 0, d.fps, d.frame_count, stream_headers(d.codec, first), d.samples,
                 source=d.source)


RAW_FPS = 25.0              # FFmpeg's raw video demuxers' default -framerate


def demux_annexb(f, file_size: int, codec: str) -> Track:
    """A raw H.264 or HEVC elementary stream, cut into access units as
    FFmpeg's parser cuts it. cv2 reports 25 fps (the raw demuxer's
    default rate) and a meaningless frame count (its duration is unknown);
    the port reports the access units."""
    from yololite_tpu_torch.data import esparse
    f.seek(0)
    sp, cuts = esparse.Splitter(codec), []
    while True:
        chunk = f.read(1 << 20)
        cuts += sp.feed(chunk, final=not chunk)
        if not chunk:
            break
    edges = [0] + [c for c in cuts if 0 < c < file_size] + [file_size]
    packets = [Sample(a, b - a) for a, b in zip(edges, edges[1:]) if b > a]
    if not packets:
        raise ValueError("empty Annex B stream")
    f.seek(0)
    first = f.read(packets[0].size)
    return Track(codec, 0, 0, RAW_FPS, len(packets), stream_headers(codec, first), packets)


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
# colour_primaries and transfer_characteristics (H.264 Tables E-3, E-4; the
# same in HEVC) for which cv2 5.0's swscale (FFmpeg 8) maps the colours to
# BT.709 SDR before it converts to BGR (gamut and tone mapping through a 3D
# LUT, then a dither), which this package does not reproduce
MAPPED_PRIMARIES = {8: "generic film", 9: "BT.2020", 10: "SMPTE ST 428 (CIE XYZ)",
                    11: "SMPTE RP 431 (DCI-P3)", 12: "SMPTE EG 432 (Display P3)",
                    22: "EBU Tech 3213"}
MAPPED_TRANSFERS = {9: "logarithmic 100:1", 10: "logarithmic 316:1",
                    16: "SMPTE ST 2084 (PQ)", 18: "ARIB STD-B67 (HLG)"}
# below this width or height swscale shortens its 10-bit chroma filters
MIN_10BIT_SIDE = 14


@dataclass
class Picture:
    """What a decoder says of the next picture it hands out."""
    w: int                    # cropped to the conformance window
    h: int
    full: int                 # video_full_range_flag
    matrix: int               # matrix_coefficients
    tag: int                  # of the packet that began the picture
    depth: int = 8            # bits a sample
    coded: Tuple[int, int] = (0, 0)    # (w, h) before cropping
    primaries: int = 2        # colour_primaries
    transfer: int = 2         # transfer_characteristics
    chroma_loc: int = -1      # chroma_sample_loc_type_top_field, -1 when not sent


def to_bgr(planes: np.ndarray, pic: Picture, codec: str) -> np.ndarray:
    """Cropped 4:2:0 planes (Y, Cb, Cr concatenated; uint16 past 8 bits) to
    BGR as cv2 5.0 gets them from swscale: 8 bits through its unscaled
    converter (`yl_yuv_to_bgr`), 10 bits (yuv420p10le, chroma sited left)
    through its scaled bicubic path (`yl_yuv10_to_bgr`). What cv2 converts
    another way raises `UnsupportedVideo` naming it."""
    if pic.matrix in UNCONVERTED_MATRICES:
        raise unsupported(f"{codec} with matrix_coefficients {pic.matrix} "
                          f"({UNCONVERTED_MATRICES[pic.matrix]})")
    mapped = [f"{what} {value} ({names[value]})" for what, value, names in
              (("colour_primaries", pic.primaries, MAPPED_PRIMARIES),
               ("transfer_characteristics", pic.transfer, MAPPED_TRANSFERS)) if value in names]
    if mapped:
        raise unsupported(f"{codec} with {' and '.join(mapped)}, which cv2 converts to BGR "
                          f"colour-managed")
    w, h = pic.w, pic.h
    bgr = np.empty((h, w, 3), np.uint8)
    if pic.depth > 8:
        if min(w, h) < MIN_10BIT_SIDE:
            raise unsupported(f"{pic.depth}-bit {codec} of {w}x{h} (under {MIN_10BIT_SIDE} "
                              f"samples a side, swscale's filters change)")
        if pic.chroma_loc > 0:
            raise unsupported(f"{pic.depth}-bit {codec} with chroma_sample_loc_type "
                              f"{pic.chroma_loc} (chroma not sited left)")
        library().yl_yuv10_to_bgr(planes.ctypes.data, w, h, pic.full, pic.matrix,
                                  bgr.ctypes.data)
    else:
        library().yl_yuv_to_bgr(planes.ctypes.data, w, h, h // 2, pic.full, pic.matrix,
                                bgr.ctypes.data)
    return bgr


class _CodedDecoder:
    """One H.264 or HEVC stream: packets (access units) in, frames out in
    FFmpeg's output order, each with the tag of the packet that began its
    picture. `extradata` is an avcC/hvcC record (packets then carry NAL
    units with its length size) or Annex B parameter sets (packets in Annex
    B). A frame is BGR [h, w, 3] as `to_bgr` makes it, or with `planes` the
    planes Y [h, w], Cb, Cr [h/2, w/2] (uint8, uint16 past 8 bits) cropped
    to the picture."""

    codec = ""                # the name messages give
    _prefix = ""              # of the C functions: yl_<prefix>_open, ...

    def __init__(self, extradata: bytes = b""):
        self._lib = self._library()
        msg, h = ctypes.create_string_buffer(_MSG_LEN), ctypes.c_void_p()
        self._h = None
        self.last_type = -1          # slice type of the last picture begun: 0 P, 1 B, 2 I
        code = self._c("open")(bytes(extradata), len(extradata), ctypes.byref(h), msg, _MSG_LEN)
        if code:
            raise _error(code, msg)
        self._h = h.value

    def _c(self, name: str):
        return getattr(self._lib, f"yl_{self._prefix}_{name}")

    def decode(self, packet: bytes, tag: int = 0, planes: bool = False) -> list:
        """The frames a packet completes, as (frame, tag). A packet that
        does not decode raises; the pictures before it stay for `flush`."""
        msg = ctypes.create_string_buffer(_MSG_LEN)
        code = self._c("decode")(self._h, bytes(packet), len(packet), tag, msg, _MSG_LEN)
        self.last_type = self._c("last_type")(self._h)
        if code:
            raise _error(code, msg)
        return self._ready(planes)

    def flush(self, planes: bool = False) -> list:
        """The pictures still waiting for output, at the end of the stream."""
        msg = ctypes.create_string_buffer(_MSG_LEN)
        code = self._c("flush")(self._h, msg, _MSG_LEN)
        out = self._ready(planes)
        if code:
            raise _error(code, msg)
        return out

    def _ready(self, planes: bool) -> list:
        out = []
        info = np.zeros(11, np.int64)
        while self._c("pending")(self._h, info.ctypes.data):
            pic = self._picture([int(v) for v in info])
            w, h = self._window(pic)
            buf = np.empty(w * h + 2 * (w // 2) * (h // 2), np.uint16 if pic.depth > 8 else np.uint8)
            if self._fetch(buf):
                raise ValueError("no decoded picture")
            if planes:
                n, c = w * h, (w // 2) * (h // 2)
                out.append(([buf[:n].reshape(h, w), buf[n:n + c].reshape(h // 2, w // 2),
                             buf[n + c:].reshape(h // 2, w // 2)], pic.tag))
            else:
                out.append((to_bgr(buf, pic, self.codec), pic.tag))
        return out

    def _window(self, pic: Picture) -> Tuple[int, int]:
        return pic.w, pic.h

    def size(self) -> Optional[Tuple[int, int]]:
        """(w, h) cropped, of the first SPS the decoder holds; None before one."""
        wh = np.zeros(2, np.int32)
        return (int(wh[0]), int(wh[1])) if self._c("size")(self._h, wh.ctypes.data) == 0 else None

    def close(self):
        if getattr(self, "_h", None):
            self._c("close")(self._h)
            self._h = None

    __del__ = close


class H264Decoder(_CodedDecoder):
    """Progressive 8-bit 4:2:0 H.264 (`csrc/h264dec.cpp`)."""

    codec, _prefix = "H.264", "h264"
    _library = staticmethod(h264_library)

    def _picture(self, info: List[int]) -> Picture:
        return Picture(*info[:5], primaries=info[5], transfer=info[6])

    def _fetch(self, buf: np.ndarray) -> int:
        return self._c("frame")(self._h, buf.ctypes.data, buf.nbytes)


class HevcDecoder(_CodedDecoder):
    """HEVC Main, Main 10 and Main Still Picture (`csrc/hevcdec.cpp`).
    With `uncropped=True` the planes come as decoded, before the
    conformance window crops them (what the MD5 hash SEI covers)."""

    codec, _prefix = "HEVC", "hevc"
    _library = staticmethod(hevc_library)

    def __init__(self, extradata: bytes = b"", uncropped: bool = False):
        super().__init__(extradata)
        self.uncropped = uncropped

    def _picture(self, info: List[int]) -> Picture:
        return Picture(*info[:6], coded=(info[6], info[7]), primaries=info[8],
                       transfer=info[9], chroma_loc=info[10])

    def _window(self, pic: Picture) -> Tuple[int, int]:
        return pic.coded if self.uncropped else (pic.w, pic.h)

    def _fetch(self, buf: np.ndarray) -> int:
        return self._c("frame")(self._h, buf.ctypes.data, buf.nbytes, int(self.uncropped))


def hevc_mp4_to_annexb(sample: bytes, nal_size: int, ps: bytes) -> bytes:
    """A length-prefixed HEVC sample in Annex B as FFmpeg's
    `hevc_mp4toannexb` filter writes it: a 4-byte start code before every
    NAL unit, and the `hvcC` arrays `ps` before the first IRAP slice of the
    sample. A NAL unit shorter than its header or running past the sample
    raises `ValueError`, where the filter fails."""
    out = bytearray()
    got_irap = False
    i = 0
    while i < len(sample):
        if i + nal_size > len(sample):
            raise ValueError("NAL unit length cut short")
        n = int.from_bytes(sample[i:i + nal_size], "big")
        i += nal_size
        if n < 2 or n > len(sample) - i:
            raise ValueError(f"NAL unit of {n} bytes does not fit its sample")
        nal = sample[i:i + n]
        i += n
        irap = 16 <= (nal[0] >> 1) & 0x3F <= 23
        if irap and not got_irap:
            out += ps
        got_irap |= irap
        out += b"\x00\x00\x00\x01" + nal
    return bytes(out)


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
        if t.codec in ("h264", "hevc"):
            self.size = self._coded_size()
        elif t.codec == "mp4v" and not all(self.size):
            dec = Mpeg4Decoder(t.extradata)     # a stream that names its size only in its VOL
            try:
                self.size = dec.size()
            finally:
                dec.close()

    def _decoder(self):
        return (H264Decoder if self.codec == "h264" else HevcDecoder)(self.track.extradata)

    def _coded_size(self):
        """The cropped size of the SPS in the extradata, else the
        container's (an AVI's parameter sets come in band)."""
        dec = self._decoder()
        try:
            return dec.size() or self.size
        finally:
            dec.close()

    def samples(self):
        """The samples of the track in order, as the container stores them.
        A sample that runs past the end of the file is the last, with the
        bytes the file holds (FFmpeg reads it so and stops after it)."""
        with open(self.path, "rb") as f:
            src = self.track.source(f) if self.track.source else f
            end = os.fstat(f.fileno()).st_size
            for k, sample in enumerate(self.track.samples):
                n = sample.size             # of the file: no more than it holds there
                if src is f:
                    n = min(n, end - sample.offset) if 0 <= sample.offset < end else 0
                src.seek(sample.offset if n else 0)
                data = src.read(n)
                short = len(data) < sample.size
                if sample.inflate and not short:
                    from yololite_tpu_torch.data import mkv
                    try:
                        data = mkv.inflate(data)
                    except ValueError as e:
                        self.stop_reason = f"sample {k}: {e}"
                        return
                data = sample.prefix + data
                if short:
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
        if self.codec not in ("h264", "hevc") or not any(self.track.annexb_ps):
            yield from self.samples()
            return
        if self.codec == "hevc":
            nal_size = (self.track.extradata[21] & 3) + 1
            for sample in self.samples():
                try:
                    yield hevc_mp4_to_annexb(sample, nal_size, self.track.annexb_ps[0])
                except ValueError:      # the filter fails, cv2 stops
                    return
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
        if self.codec in ("h264", "hevc"):
            yield from (f for f, k in self._coded() if shown is None or shown[k])
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

    def _coded(self):
        """H.264 or HEVC (frame, sample index) in output order. At a sample
        that does not decode, the whole pictures before it, then the end;
        in a file cut short the pictures still held are not handed out, as
        cv2's reader stops at the demuxer's error without draining its
        decoder."""
        dec = self._decoder()
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


WRITE_EXTENSIONS = (".mp4", ".m4v", ".mov", ".avi", ".mkv")
# what cv2.VideoWriter(path, "mp4v", ...) also writes and this writer does
# not (ROADMAP, deliberate differences); `.webm` cv2 does not open either
UNWRITTEN = {".ts": "MPEG-TS", ".m2ts": "M2TS", ".mts": "M2TS", ".mpg": "MPEG-PS",
             ".mpeg": "MPEG-PS", ".3gp": "3GP", ".webm": "WebM (cv2 cannot write mp4v in it)"}


class VideoWriter:
    """BGR frames of one size written as MPEG-4 Part 2 at `fps`, into an MP4
    (`.mp4`, `.m4v`, `.mov`), an AVI (`.avi`, FourCC FMP4) or a Matroska
    file (`.mkv`, as FFmpeg's matroska muxer writes cv2's); any other
    extension raises `ValueError` (naming the container where cv2 writes
    it)."""

    def __init__(self, path: str, fps: float, size):
        ext = os.path.splitext(path)[1].lower()
        if ext not in WRITE_EXTENSIONS:
            named = f" ({UNWRITTEN[ext]} is not written)" if ext in UNWRITTEN else ""
            raise ValueError(f"{path}: the video writer writes {', '.join(WRITE_EXTENSIONS)}{named}")
        self.enc = Mpeg4Encoder(size, fps)
        coded = (self.enc.w, self.enc.h)
        if ext == ".avi":
            from yololite_tpu_torch.data.imwrite import AviWriter
            headers = self.enc.headers
            self.mux = AviWriter(path, fps, coded, fourcc=b"FMP4",
                                 encode=lambda frame: headers + self.enc._encode(frame))
            self._write = lambda frame: self.mux.write(self.enc.crop(frame))
        elif ext == ".mkv":
            from yololite_tpu_torch.data.mkv import MkvMuxer
            self.mux = MkvMuxer(path, coded, fps, self.enc.headers)
            self._write = lambda frame: self.mux.write(self.enc.encode(frame))
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
