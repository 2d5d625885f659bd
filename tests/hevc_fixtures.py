"""HEVC clips for the port's decoder: an x265 encoder driven through ctypes
(the system's FFmpeg 5.1 `libavcodec.so.59` with `libx265`), MP4/MOV and
AVI muxers (an `hvcC` record beside `tests/h264_fixtures.py`'s boxes), and
the committed fixtures under tests/data/video/hevc/ with their manifest
(cv2.VideoCapture's fps, frame count and size, the SHA-256 of each raw
packet with `CAP_PROP_FORMAT = -1` and of each decoded BGR frame).

    python tests/hevc_fixtures.py

Every stream is written with x265's `hash=1`: an MD5 decoded picture hash
SEI (H.265 D.3.19) after each picture, which `picture_hashes` reads so the
decoder's planes can be held to the encoder's own pictures. The encoder
runs single-threaded (`pools=none:frame-threads=1`), so WPP streams are
written in one thread with their entry points. The fields set directly sit
at FFmpeg 5.1's offsets (see `h264_fixtures`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import struct
import sys
from fractions import Fraction
from typing import List, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import h264_fixtures as hf  # noqa: E402
import h264_streams as hs  # noqa: E402
from h264_fixtures import Packet, Stream, nal_units, scene, noisy  # noqa: E402,F401
from video_fixtures import cv2_read, faststart, sha  # noqa: E402,F401

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "video", "hevc")

PIX_FMTS = {"yuv420p": 0, "yuv422p": 4, "yuv444p": 5, "yuv420p10le": 62, "yuv420p12le": 123,
            "yuv422p10le": 64, "gray": 8}
VPS, SPS, PPS, PREFIX_SEI, SUFFIX_SEI = 32, 33, 34, 39, 40


def available() -> bool:
    """Whether the system's libavcodec 59 with libx265 can be loaded."""
    try:
        _, codec = hf._libs()
    except OSError:
        return False
    return bool(codec.avcodec_find_encoder_by_name(b"libx265"))


def planes_for(frame_bgr: np.ndarray, pix_fmt: str) -> List[np.ndarray]:
    """The planes of a BGR frame in pix_fmt (10 and 12 bits as the 8-bit
    samples scaled, with a ramp in the low bits so they are not all zero)."""
    if pix_fmt == "gray":
        return hf.yuv420(frame_bgr)[:1]
    if pix_fmt in ("yuv420p10le", "yuv420p12le", "yuv422p10le"):
        shift = 4 if pix_fmt == "yuv420p12le" else 2
        out = []
        planes = hf.planes_for(frame_bgr, "yuv422p" if pix_fmt == "yuv422p10le" else "yuv420p")
        for p in planes:
            ramp = (np.arange(p.shape[1])[None, :] + np.arange(p.shape[0])[:, None]) % (1 << shift)
            out.append((p.astype(np.uint16) << shift) | ramp.astype(np.uint16))
        return out
    return hf.planes_for(frame_bgr, pix_fmt)


def encode(frames: Sequence[np.ndarray], params: str = "", profile: Optional[str] = None,
           fps: Fraction = Fraction(25), pix_fmt: str = "yuv420p",
           options: Optional[dict] = None, hash_sei: bool = True) -> Stream:
    """Encode BGR frames with libx265, single-threaded. `params` is x265's
    `-x265-params` string (with `hash=1` before it); `options` further
    AVOptions of the encoder (`crf`, `qp`, `preset`, ...). The VPS/SPS/PPS
    go to the extradata (Annex B), and into the packets too with x265's
    `repeat-headers=1`."""
    util, codec = hf._libs()
    enc = codec.avcodec_find_encoder_by_name(b"libx265")
    if not enc:
        raise OSError("libavcodec has no libx265 encoder")
    ctx = codec.avcodec_alloc_context3(enc)
    h, w = frames[0].shape[:2]
    fps = Fraction(fps)
    _i32, _i64, _ptr = hf._i32, hf._i64, hf._ptr
    _i32(ctx, 116).value, _i32(ctx, 120).value = w, h
    _i32(ctx, 136).value = PIX_FMTS[pix_fmt]
    _i32(ctx, 100).value, _i32(ctx, 104).value = fps.denominator, fps.numerator
    _i32(ctx, 712).value, _i32(ctx, 716).value = fps.numerator, fps.denominator
    _i32(ctx, 76).value |= hf._GLOBAL_HEADER
    opts = {"preset": "medium"}
    if profile:
        opts["profile"] = profile
    opts.update(options or {})
    x265 = "pools=1:frame-threads=1:log-level=error" + (":hash=1" if hash_sei else "")
    opts["x265-params"] = x265 + (":" + params if params else "")
    for k, v in opts.items():
        if util.av_opt_set(ctx, k.encode(), str(v).encode(), hf._SEARCH_CHILDREN) < 0:
            raise ValueError(f"libx265 option {k}={v} refused")
    if codec.avcodec_open2(ctx, enc, None) < 0:
        raise ValueError(f"libx265 did not open with {opts}")
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
            if r in (hf._EAGAIN, hf._EOF):
                return
            if r < 0:
                raise ValueError(f"avcodec_receive_packet: {r}")
            data = ctypes.string_at(_ptr(pkt, 24).value, _i32(pkt, 32).value)
            pts, dts = _i64(pkt, 8).value, _i64(pkt, 16).value
            if abs(dts) > 1 << 30:          # libx265 leaves it unset for a lone picture
                dts = out[-1].dts + 1 if out else pts
            out.append(Packet(data, pts, dts, bool(_i32(pkt, 40).value & 1)))
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
# NAL units, the hvcC record and the decoded picture hash SEI
# --------------------------------------------------------------------------- #

def nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


def rbsp(nal: bytes) -> bytes:
    """The NAL unit's payload without emulation prevention bytes."""
    return hs.unescape(nal[2:])


def hvcc(extradata: bytes, chroma: int = 1, bit_depth: int = 8) -> bytes:
    """The HEVCDecoderConfigurationRecord of Annex B parameter sets (4-byte
    NAL lengths; the VPS, SPS, PPS and SEI arrays in that order), as
    FFmpeg's `ff_isom_write_hvcc` lays it out."""
    nals = nal_units(extradata)
    sps = rbsp(next(n for n in nals if nal_type(n) == SPS))
    ptl = sps[1:13]                     # general profile, flags and level
    out = bytes([1]) + ptl[:12] + struct.pack(">HBBBBHB", 0xF000, 0xFC, 0xFC | chroma,
                                              0xF8 | (bit_depth - 8), 0xF8 | (bit_depth - 8),
                                              0, 0x0F)
    arrays = [t for t in (VPS, SPS, PPS, PREFIX_SEI, SUFFIX_SEI) if any(nal_type(n) == t for n in nals)]
    out += bytes([len(arrays)])
    for t in arrays:
        group = [n for n in nals if nal_type(n) == t]
        out += bytes([0x80 | t]) + struct.pack(">H", len(group))
        for n in group:
            out += struct.pack(">H", len(n)) + n
    return out


def picture_hashes(annexb: bytes) -> List[List[bytes]]:
    """The MD5 of each plane from the decoded picture hash SEI messages
    (payloadType 132, hash_type 0) in an access unit."""
    out = []
    for nal in nal_units(annexb):
        if nal_type(nal) != SUFFIX_SEI:
            continue
        p, i = rbsp(nal), 0
        while i < len(p) and p[i] != 0x80:
            kind = size = 0
            while p[i] == 0xFF:
                kind += 255
                i += 1
            kind += p[i]
            i += 1
            while p[i] == 0xFF:
                size += 255
                i += 1
            size += p[i]
            i += 1
            if kind == 132 and p[i] == 0:
                out.append([p[i + 1 + 16 * c:i + 17 + 16 * c] for c in range(3)])
            i += size
    return out


def planes_md5(planes: Sequence[np.ndarray]) -> List[bytes]:
    """MD5 of each decoded plane as the picture hash SEI computes it: one
    byte a sample at 8 bits, two (little-endian) above."""
    return [hashlib.md5(np.ascontiguousarray(p).astype(p.dtype.newbyteorder("<")).tobytes()).digest()
            for p in planes]


# --------------------------------------------------------------------------- #
# muxers
# --------------------------------------------------------------------------- #

def length_prefixed(annexb: bytes) -> bytes:
    return b"".join(len(n).to_bytes(4, "big") + n for n in nal_units(annexb))


def write_mp4(path: str, stream: Stream, sample_entry: bytes = b"hvc1", trim: int = 0,
              chroma: int = 1, bit_depth: int = 8, strip_ps: bool = True,
              extra_boxes: bytes = b"") -> None:
    """The stream as one HEVC track in an MP4/MOV, laid out as
    `h264_fixtures.write_mp4` lays out H.264 (FFmpeg 5.1's mov muxer) with
    an `hvcC` record. With `strip_ps` the parameter sets x265 repeats in
    band are left out of the samples (as an `hvc1` track wants);
    `extra_boxes` go into the sample entry after `hvcC` (a Dolby Vision
    `dvcC`, say). `trim` frames are cut from the start by the edit list."""
    rate = stream.rate
    ts = rate.numerator * (1 if rate.denominator > 1 else 512)
    per = ts * rate.denominator // rate.numerator
    w, h = stream.size
    pk = stream.packets

    def sample(p):
        nals = nal_units(p.data)
        if strip_ps:
            nals = [n for n in nals if nal_type(n) not in (VPS, SPS, PPS)]
        return b"".join(len(n).to_bytes(4, "big") + n for n in nals)

    samples = [sample(p) for p in pk]
    first_dts = pk[0].dts
    dts = [(p.dts - first_dts) * per for p in pk]
    cts = [(p.pts - p.dts) * per for p in pk]
    n = len(pk)
    start_ct = min(d + c for d, c in zip(dts, cts))
    dur = n * per
    mov = path.lower().endswith(".mov")
    brand = (b"qt  ", 0x200, b"qt  ") if mov else (b"isom", 0x200, b"isomiso2mp41")
    _box, _full = hf._box, hf._full
    ftyp = _box(b"ftyp", brand[0], struct.pack(">I", brand[1]), brand[2])
    head = ftyp + _box(b"free")
    offsets, o = [], len(head) + 8
    for s in samples:
        offsets.append(o)
        o += len(s)
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    edit_ms = -(-(dur - trim * per) * 1000 // ts)
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, edit_ms),
                 struct.pack(">IH10x", 0x10000, 0x100), matrix, b"\x00" * 24, struct.pack(">I", 2))
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, edit_ms), b"\x00" * 8,
                 struct.pack(">hhHH", 0, 0, 0, 0), matrix, struct.pack(">II", w << 16, h << 16))
    elst = _full(b"elst", 0, 0, struct.pack(">IIiI", 1, edit_ms, start_ct + trim * per, 0x10000))
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, ts, dur, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"VideoHandler\x00")
    dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
    entry = _box(sample_entry, b"\x00" * 6, struct.pack(">H", 1), b"\x00" * 16,
                 struct.pack(">HHIII", w, h, 0x480000, 0x480000, 0), struct.pack(">H", 1),
                 b"\x00" * 32, struct.pack(">Hh", 24, -1),
                 _box(b"hvcC", hvcc(stream.extradata, chroma, bit_depth)), extra_boxes)
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, per))
    keys = [i + 1 for i, p in enumerate(pk) if p.key]
    parts = [stsd, stts]
    if len(keys) < n:
        parts.append(_full(b"stss", 0, 0, struct.pack(">I", len(keys)),
                           struct.pack(f">{len(keys)}I", *keys)))
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
    trak = _box(b"trak", tkhd, _box(b"edts", elst), _box(b"mdia", mdhd, hdlr, minf))
    with open(path, "wb") as f:
        f.write(head + _box(b"mdat", b"".join(samples)) + _box(b"moov", mvhd, trak))


def write_avi(path: str, stream: Stream, fourcc: bytes = b"HEVC") -> None:
    """The stream in an AVI: Annex B access units (the parameter sets before
    the first), FourCC `fourcc`."""
    hf.write_avi(path, stream, fourcc)


# --------------------------------------------------------------------------- #
# fixtures
# --------------------------------------------------------------------------- #

# a Dolby Vision configuration box (profile 8.4, HLG-compatible base layer),
# as an iPhone writes beside hvcC; FFmpeg reads and ignores it
DVVC = hf._box(b"dvvC", bytes([1, 0, 0x10, 0x0D, 0x40]) + b"\x00" * 19)
DVCC = hf._box(b"dvcC", bytes([1, 0, 0x10, 0x0D, 0x40]) + b"\x00" * 19)
HLG = "colorprim=bt2020:transfer=arib-std-b67:colormatrix=bt2020nc"
TRIM = 5
TRUNCATE_AT = 0.75

# name -> (frames, encode(...) keyword arguments, container, note)
FIXTURES = {
    "a_default_320x240.mp4": (
        lambda: scene(24, 240, 320), dict(params="keyint=12:min-keyint=12"), "mp4",
        "x265 defaults: CTU 64, WPP, SAO, TMVP, B-pyramid, open GOP (a CRA with RASL "
        "pictures at frame 12)"),
    "b_hev1_repeat_320x240.mp4": (
        lambda: scene(24, 240, 320), dict(params="keyint=6:min-keyint=6:repeat-headers=1:open-gop=0"),
        "hev1", "hev1 with the parameter sets in band, closed GOPs of 6"),
    "c_ctu16_slices_328x244.mov": (
        lambda: scene(12, 244, 328),
        dict(params="ctu=16:slices=3:tskip=1:scaling-list=default:amp=1:rect=1:weightb=1:keyint=6"),
        "mp4", "CTU 16, 3 slices, transform skip, the default scaling lists, AMP, weighted "
               "bi-prediction; 328x244 coded 336x248 (conformance window) in a .mov"),
    "d_lossless_noise.mp4": (
        lambda: noisy(4, 96, 128, 1), dict(params="lossless=1"), "mp4",
        "lossless (cu_transquant_bypass) on noise"),
    "d_qp4_noise.mp4": (
        lambda: noisy(4, 96, 128, 2), dict(options={"qp": "4"}), "mp4",
        "QP 4 on noise (large coefficient levels)"),
    "e_fullrange_bt709.mp4": (
        lambda: scene(12, 120, 160), dict(params="range=full:colorprim=bt709:transfer=bt709:"
                                                  "colormatrix=bt709"), "mp4",
        "full range, BT.709 VUI"),
    "f_main10_hlg_640x480.mov": (
        lambda: scene(12, 480, 640), dict(profile="main10", pix_fmt="yuv420p10le", params=HLG),
        "iphone", "Main 10, BT.2020 HLG, hvc1 with a Dolby Vision dvvC box in a .mov, as an "
                  "iPhone records HDR video (planes only: cv2 converts it colour-managed)"),
    "g_still_320x240.mp4": (
        lambda: scene(1, 240, 320), dict(profile="mainstillpicture"), "mp4",
        "Main Still Picture"),
    "h_hevc_320x240.avi": (
        lambda: scene(24, 240, 320), dict(params="keyint=12:min-keyint=12"), "avi",
        "HEVC in AVI, FourCC HEVC, Annex B"),
    "i_dvh1_320x240.mp4": (
        lambda: scene(24, 240, 320), dict(params="keyint=12:min-keyint=12"), "dvh1",
        "the default clip under a dvh1 sample entry with a dvcC box"),
    "j_trimmed_320x240.mp4": (
        lambda: scene(24, 240, 320), dict(params="keyint=12:min-keyint=12:open-gop=0"), "trim",
        "edit list starting 5 frames in, as an editor trims without re-encoding"),
    "k_truncated_320x240.mp4": (
        lambda: scene(24, 240, 320), dict(params="keyint=12:min-keyint=12:open-gop=0"),
        "truncate", "moov first, cut at 75% of the file, inside the second GOP"),
    "l_640x480.mp4": (
        lambda: scene(24, 480, 640), dict(params="keyint=24"), "mp4",
        "x265 defaults at 640x480, 24 frames (timed and tracked by chip_smoke.py)"),
    "m_1920x1080.mp4": (
        lambda: scene(4, 1080, 1920), dict(params="bframes=2"), "mp4",
        "1920x1080 (coded 1088, cropped), 4 frames (timed by chip_smoke.py)"),
    "n_main10_bt601_640x480.mp4": (
        lambda: scene(12, 480, 640), dict(profile="main10", pix_fmt="yuv420p10le",
                                          params="colorprim=smpte170m:transfer=smpte170m:"
                                                 "colormatrix=smpte170m"), "mp4",
        "Main 10, BT.601 VUI: converted as swscale's scaled 10-bit path, frame for frame "
        "(timed by chip_smoke.py)"),
    "o_noise64_qp4.mp4": (
        lambda: noisy(6, 64, 64, 2), dict(options={"qp": "4"}), "mp4",
        "QP 4 on 64x64 noise: x265's motion search at one-CTU-wide pictures writes MD5 SEI "
        "that some of its P and B pictures do not match (MD5_DIFFERS)"),
    "o_noise64_qp20.mp4": (
        lambda: noisy(6, 64, 64, 1), dict(options={"qp": "20"}), "mp4",
        "QP 20 on 64x64 noise, as above"),
    "z_main12.mp4": (lambda: scene(1, 48, 64), dict(profile="main12", pix_fmt="yuv420p12le"),
                     "mp4", "refused: 12 bits a sample"),
    "z_422.mp4": (lambda: scene(1, 48, 64), dict(profile="main422-10", pix_fmt="yuv422p10le"),
                  "mp4", "refused: 4:2:2 chroma"),
    "z_444.mp4": (lambda: scene(1, 48, 64), dict(profile="main444-8", pix_fmt="yuv444p"), "mp4",
                  "refused: 4:4:4 chroma"),
}
# access units whose pictures differ from their MD5 SEI, where the port and
# cv2 decode the stream alike: x265 (libx265 199) with a motion search range
# at pictures 64 samples wide writes a different stream from run to run, and
# hashes for some pictures that are not the ones its stream codes (with
# merange=0 neither happens). Remaking these clips changes the lists.
MD5_DIFFERS = {"o_noise64_qp4.mp4": [1, 2, 3, 4], "o_noise64_qp20.mp4": [2, 3]}
REFUSED = {"z_main12.mp4": "12-bit", "z_422.mp4": "4:2:2", "z_444.mp4": "4:4:4"}
CHROMA = {"yuv422p10le": 2, "yuv444p": 3}


def write_fixture(name: str, path: str) -> None:
    frames, kw, how, _ = FIXTURES[name]
    stream = encode(frames(), **kw)
    pix = kw.get("pix_fmt", "yuv420p")
    depth = 12 if "12" in pix else 10 if "10" in pix else 8
    fmt = dict(chroma=CHROMA.get(pix, 1), bit_depth=depth)
    if how == "avi":
        write_avi(path, stream)
    elif how == "hev1":
        write_mp4(path, stream, sample_entry=b"hev1", strip_ps=False, **fmt)
    elif how == "iphone":
        write_mp4(path, stream, extra_boxes=DVVC, **fmt)
    elif how == "dvh1":
        write_mp4(path, stream, sample_entry=b"dvh1", extra_boxes=DVCC, **fmt)
    elif how == "trim":
        write_mp4(path, stream, trim=TRIM, **fmt)
    elif how == "truncate":
        write_mp4(path, stream, **fmt)
        data = faststart(open(path, "rb").read())
        with open(path, "wb") as f:
            f.write(data[:int(len(data) * TRUNCATE_AT)])
    else:
        write_mp4(path, stream, **fmt)


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


# --------------------------------------------------------------------------- #
# streams written from scratch: the tools x265 never writes, for the refusals
# (bits, escaping and the arithmetic coder of tests/h264_streams.py)
# --------------------------------------------------------------------------- #

def nal(kind: int, rbsp_bytes: bytes) -> bytes:
    """An HEVC NAL unit (layer 0, TemporalId 0) in Annex B."""
    return b"\x00\x00\x00\x01" + bytes([kind << 1, 1]) + hs.escape(rbsp_bytes)


def sps_bits(w: int, h: int, pcm: bool = False, long_term: bool = False) -> bytes:
    """An SPS of Main 4:2:0 8-bit, CTB 16, minimum CB 8, TBs 4-16, no
    SAO, log2_max_poc_lsb 8; with pcm, PCM enabled for 8x8 to 16x16 CBs;
    with long_term, long-term reference pictures present."""
    b = hs.Writer()
    for v, n in ((0, 4), (0, 3), (1, 1), (1, 8), (0x60000000, 32), (0x90, 8), (0, 40), (30, 8)):
        b.u(v, n)                                   # ids, profile_tier_level
    for v in (0, 1, w, h):
        b.ue(v)
    b.u(0, 1)                                       # no conformance window
    for v in (0, 0, 4):
        b.ue(v)                                     # 8 bits, log2_max_poc_lsb 8
    b.u(1, 1)
    for v in (4, 0, 0, 0, 1, 0, 2, 1, 1):
        b.ue(v)                                     # DPB 5, no reordering; CB 8-16, TB 4-16
    for v in (0, 0, 0, int(pcm)):
        b.u(v, 1)                                   # scaling lists, AMP, SAO, PCM
    if pcm:
        b.u(7, 4), b.u(7, 4), b.ue(0), b.ue(1), b.u(0, 1)
    b.ue(0)                                         # no short-term RPS in the SPS
    b.u(int(long_term), 1)
    if long_term:
        b.ue(0)
    b.u(0, 4)                                       # TMVP, strong smoothing, VUI, extensions
    return nal(SPS, b.rbsp())


def pps_bits(dependent: bool = False, tiles: bool = False, lists_modification: bool = False) -> bytes:
    b = hs.Writer()
    b.ue(0), b.ue(0), b.u(int(dependent), 1), b.u(0, 1), b.u(0, 3), b.u(0, 2)
    b.ue(0), b.ue(0), b.se(0), b.u(0, 3), b.se(0), b.se(0), b.u(0, 4)
    b.u(int(tiles), 1), b.u(0, 1)                   # tiles, entropy_coding_sync
    if tiles:
        b.ue(1), b.ue(0), b.u(1, 1), b.u(1, 1)      # 2x1, uniform, filtered across
    b.u(0, 3), b.u(int(lists_modification), 1), b.ue(0), b.u(0, 2)
    return nal(PPS, b.rbsp())


def refused_stream(case: str) -> bytes:
    """An Annex B stream that uses one tool the port does not decode, at
    the first point the decoder meets it: "pcm" (a 16x16 IDR picture
    whose one CU is PCM: split_cu_flag 0, then a pcm_flag of 1), "tiles"
    (an IDR slice of a PPS with 2x1 tiles), "dependent" (a dependent slice
    segment), "long_term" (a P slice with a long-term reference picture),
    "lists_modification" (a P slice that modifies its list 0)."""
    head = sps_bits(16, 16, pcm=case == "pcm", long_term=case == "long_term")
    head += pps_bits(dependent=case == "dependent", tiles=case == "tiles",
                     lists_modification=case == "lists_modification")
    b = hs.Writer()
    if case == "dependent":        # not the first segment; dependent_slice_segment_flag 1
        b.u(0, 2), b.ue(0), b.u(1, 1), b.u(0, 16)
        return head + nal(IDR_W_RADL_NUT, b.rbsp())
    if case in ("long_term", "lists_modification"):
        b.u(1, 1), b.ue(0), b.ue(1), b.u(1, 8), b.u(0, 1)      # P, POC lsb 1, its own RPS:
        b.ue(2), b.ue(0), b.ue(0), b.u(1, 1), b.ue(0), b.u(1, 1)   # refs -1, -2, both used
        if case == "long_term":
            b.ue(1)                                          # num_long_term_pics
        else:
            b.u(0, 1), b.u(1, 1)                             # no override; modify list 0
        b.u(0, 16)
        return head + nal(TRAIL_R_NUT, b.rbsp())
    # an IDR slice: first segment, no_output_of_prior_pics 0, PPS 0, I, QP 26,
    # byte_alignment(), then split_cu_flag 0 and the pcm_flag (or, without
    # PCM, end_of_slice_segment_flag) of its one CTB
    b.u(1, 1), b.u(0, 1), b.ue(0), b.ue(2), b.se(0), b.u(1, 1)
    b.align_zeros()
    cabac = hs.CabacEncoder(b, 26)
    m, n = (139 >> 4) * 5 - 45, ((139 & 15) << 3) - 16       # split_cu_flag's initValue
    pre = max(1, min(126, ((m * 26) >> 4) + n))
    cabac.st["split_cu_flag"] = [63 - pre, 0] if pre <= 63 else [pre - 64, 1]
    cabac.decision("split_cu_flag", 0)
    cabac.terminate(1)
    b.align_zeros()
    return head + nal(IDR_W_RADL_NUT, b.rbsp()[:-1] + b"\xff\xff")


IDR_W_RADL_NUT, TRAIL_R_NUT = 19, 1
REFUSED_TOOLS = {"pcm": "PCM", "tiles": "tiles", "dependent": "dependent slice",
                 "long_term": "long-term", "lists_modification": "ref_pic_lists_modification"}
