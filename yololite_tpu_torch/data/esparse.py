"""Elementary streams as FFmpeg's parsers cut them, and frame rates as FFmpeg
estimates them, for the containers that carry a codec's bytes without
marking its pictures (MPEG-TS, raw Annex B) or without a rate.

Access units are split as `h264_find_frame_end`, `hevc_find_frame_end`
and `ff_mpeg4_find_frame_end` split them (FFmpeg's h264, hevc and
mpeg4video parsers): a packet ends before the start code of the NAL unit
(or start code) that begins the next picture, with one zero byte before a
3-byte start code counted as part of it; the bytes after the last cut are
the last packet (the parser's flush at the end of the stream).

  - H.264: a new picture begins at an SEI, SPS, PPS or access unit
    delimiter once a slice has been seen, or at a slice (coded, IDR or
    partition A) whose first_mb_in_slice is not above the last slice's;
  - HEVC: at a VPS, SPS, PPS, AUD, end of sequence or bitstream, prefix
    SEI or reserved 41-44/48-55 NAL unit once a slice has been seen, or at
    a slice with first_slice_segment_in_pic_flag after one;
  - MPEG-4 Part 2: at the first start code (other than a slice's) after a
    VOP start code.

`avg_rate` follows how `avformat_find_stream_info` fills a stream's
`avg_frame_rate`, which cv2 reports as CAP_PROP_FPS: the packets'
durations (the container's, else one frame of the codec's own rate) over
the packets after the first two, reduced to 60000 at most and moved to a
standard rate within 1%; without durations the standard rate that fits
the timestamps best (`ff_rfps_calculate`).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

H264_AU_STARTS = {6, 7, 8, 9}            # SEI, SPS, PPS, AUD
H264_SLICES = {1, 2, 5}                  # coded slice, partition A, IDR slice
HEVC_AU_STARTS = set(range(32, 38)) | {39} | set(range(41, 45)) | set(range(48, 56))
HEVC_SLICES = set(range(0, 10)) | set(range(16, 22))
MPEG4_VOP, MPEG4_SLICE = 0xB6, 0xB7


def start_codes(data, begin: int = 0, end: Optional[int] = None):
    """Offsets of each 00 00 01 in data[begin:end]."""
    end = len(data) if end is None else end
    i = data.find(b"\x00\x00\x01", begin, end)
    while i >= 0:
        yield i
        i = data.find(b"\x00\x00\x01", i + 3, end)


def _cut(data, sc: int) -> int:
    """Where a packet ends before the start code at `sc`: one zero byte
    before it goes with the next packet."""
    return sc - 1 if sc > 0 and data[sc - 1] == 0 else sc


def _ue(data, pos: int, limit: int = 6) -> Optional[int]:
    """An Exp-Golomb code read from data[pos:pos+limit] (emulation bytes
    not removed, as the parser reads it), None if it does not end there."""
    bits = int.from_bytes(bytes(data[pos:pos + limit]), "big")
    n = 8 * len(data[pos:pos + limit])
    if not n:
        return None
    zeros = n - bits.bit_length()
    if 2 * zeros + 1 > n:
        return None
    return (bits >> (n - 2 * zeros - 1)) - 1


class Splitter:
    """FFmpeg's parser for one codec over a byte stream fed in pieces:
    `feed(data)` appends and returns the offsets (in the whole stream) where
    packets end. Only the bytes a start code may still need are kept."""

    LOOKAHEAD = 10                    # bytes after a start code its NAL header may need

    def __init__(self, codec: str):
        if codec not in ("h264", "hevc", "mp4v"):
            raise ValueError(codec)
        self.codec = codec
        self.buf = bytearray()
        self.base = 0                 # stream offset of buf[0]
        self.pos = 0                  # stream offset to search from
        self.started = False          # a slice (VOP) of the current packet seen
        self.last_mb = 0

    def feed(self, data: bytes, final: bool = False) -> List[int]:
        self.buf += data
        cuts = []
        i = self.pos - self.base
        while True:
            sc = self.buf.find(b"\x00\x00\x01", i)
            if sc < 0:
                i = max(len(self.buf) - 2, i)
                break
            if not final and sc + 3 + self.LOOKAHEAD > len(self.buf):
                i = sc
                break
            cut = self._at(sc) if sc + 3 < len(self.buf) else None
            if cut is not None:
                cuts.append(self.base + cut)
            i = sc + 3
        self.pos = self.base + i
        drop = i - 1
        if drop > 65536:
            del self.buf[:drop]
            self.base += drop
        return cuts

    def _at(self, sc: int) -> Optional[int]:
        """The cut before the start code at buf[sc], if it begins a packet."""
        b, h = self.buf, sc + 3
        if self.codec == "h264":
            t = b[h] & 0x1F
            if t in H264_AU_STARTS:
                if self.started:
                    self.started = False
                    return _cut(b, sc)
            elif t in H264_SLICES:
                mb = _ue(b, h + 1)
                if mb is None:
                    return None
                last, self.last_mb = self.last_mb, mb
                if not self.started:
                    self.started = True
                elif mb <= last:              # the rescan from the cut begins the picture
                    return _cut(b, sc)
            return None
        if self.codec == "hevc":
            if h + 2 >= len(b):
                return None
            t = (b[h] >> 1) & 0x3F
            if t in HEVC_AU_STARTS:
                if self.started:
                    self.started = False
                    return _cut(b, sc)
            elif t in HEVC_SLICES and b[h + 2] & 0x80:
                if self.started:
                    return _cut(b, sc)          # this slice begins the next picture
                self.started = True
            return None
        t = b[h]
        if not self.started:
            self.started = t == MPEG4_VOP
            return None
        if t == MPEG4_SLICE:
            return None
        self.started = t == MPEG4_VOP         # the rescan from the cut: a VOP begins one
        return sc


# --------------------------------------------------------------------------- #
# the codec's own frame rate (what FFmpeg's parser sets as avctx->framerate)
# --------------------------------------------------------------------------- #

class _Bits:
    def __init__(self, data: bytes):
        self.v = int.from_bytes(data, "big")
        self.n = 8 * len(data)
        self.p = 0

    def u(self, k: int) -> int:
        if self.p + k > self.n:
            raise ValueError("header cut short")
        self.p += k
        return (self.v >> (self.n - self.p)) & ((1 << k) - 1) if k else 0

    def ue(self) -> int:
        z = 0
        while not self.u(1):
            z += 1
            if z > 31:
                raise ValueError("Exp-Golomb code too long")
        return (1 << z) - 1 + self.u(z)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def unescape(nal: bytes) -> bytes:
    """A NAL unit's bytes without emulation prevention bytes."""
    return bytes(nal).replace(b"\x00\x00\x03", b"\x00\x00")


def nal_units(annexb: bytes) -> List[bytes]:
    """The NAL units of Annex B bytes (start codes stripped)."""
    scs = list(start_codes(annexb))
    out = []
    for k, sc in enumerate(scs):
        end = scs[k + 1] if k + 1 < len(scs) else len(annexb)
        out.append(bytes(annexb[sc + 3:end]).rstrip(b"\x00") if k + 1 < len(scs)
                   else bytes(annexb[sc + 3:end]))
    return out


def _scaling_lists(r: _Bits, n: int) -> None:
    for i in range(n):
        if r.u(1):
            last = nxt = 8
            for _ in range(16 if i < 6 else 64):
                if nxt:
                    nxt = (last + r.se()) % 256
                last = nxt or last


def h264_rate(sps_nal: bytes) -> Optional[Fraction]:
    """The frame rate of an H.264 SPS's VUI timing (time_scale over twice
    num_units_in_tick), None without one."""
    r = _Bits(unescape(sps_nal[1:]))
    profile = r.u(8)
    r.u(16)
    r.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        chroma = r.ue()
        if chroma == 3:
            r.u(1)
        r.ue(), r.ue(), r.u(1)
        if r.u(1):
            _scaling_lists(r, 8 if chroma != 3 else 12)
    r.ue()
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.u(1), r.se(), r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue(), r.u(1), r.ue(), r.ue()
    if not r.u(1):
        r.u(1)
    r.u(1)
    if r.u(1):
        r.ue(), r.ue(), r.ue(), r.ue()
    if not r.u(1):
        return None
    if r.u(1) and r.u(8) == 255:
        r.u(32)
    if r.u(1):
        r.u(1)
    if r.u(1):
        r.u(4)
        if r.u(1):
            r.u(24)
    if r.u(1):
        r.ue(), r.ue()
    if not r.u(1):
        return None
    units, scale = r.u(32), r.u(32)
    return Fraction(scale, 2 * units) if units and scale else None


def _ptl(r: _Bits, sub_layers: int) -> None:
    r.u(88)
    r.u(8)
    flags = [(r.u(1), r.u(1)) for _ in range(sub_layers)]
    if sub_layers:
        r.u(2 * (8 - sub_layers))
    for prof, lvl in flags:
        if prof:
            r.u(88)
        if lvl:
            r.u(8)


def hevc_rate(vps_nal: bytes) -> Optional[Fraction]:
    """The frame rate of an HEVC VPS's timing info (time_scale over
    num_units_in_tick), None without one."""
    r = _Bits(unescape(vps_nal[2:]))
    r.u(4), r.u(2)
    r.u(6)
    sub = r.u(3)
    r.u(1), r.u(16)
    _ptl(r, sub)
    ordering = r.u(1)
    for _ in range(0 if ordering else sub, sub + 1):
        r.ue(), r.ue(), r.ue()
    max_layer_id = r.u(6)
    for _ in range(r.ue()):
        r.u(max_layer_id + 1)
    if not r.u(1):
        return None
    units, scale = r.u(32), r.u(32)
    return Fraction(scale, units) if units and scale else None


def hevc_sps_rate(sps_nal: bytes) -> Optional[Fraction]:
    """The frame rate of an HEVC SPS's VUI timing, None without one."""
    r = _Bits(unescape(sps_nal[2:]))
    r.u(4)
    sub = r.u(3)
    r.u(1)
    _ptl(r, sub)
    r.ue()
    if r.ue() == 3:
        r.u(1)
    r.ue(), r.ue()
    if r.u(1):
        r.ue(), r.ue(), r.ue(), r.ue()
    r.ue(), r.ue()
    poc_bits = r.ue() + 4
    ordering = r.u(1)
    for _ in range(0 if ordering else sub, sub + 1):
        r.ue(), r.ue(), r.ue()
    for _ in range(6):
        r.ue()
    if r.u(1) and r.u(1):
        for size in range(4):
            for _ in range(0, 6, 3 if size == 3 else 1):
                if not r.u(1):
                    r.ue()
                    continue
                if size > 1:
                    r.se()
                for _ in range(min(64, 1 << (4 + (size << 1)))):
                    r.se()
    r.u(1), r.u(1)
    if r.u(1):
        r.u(8), r.ue(), r.ue(), r.u(1)
    deltas: List[int] = []
    for idx in range(r.ue()):
        if idx and r.u(1):
            r.u(1), r.ue()
            n = 0
            for _ in range(deltas[-1] + 1):
                used = r.u(1)
                n += 1 if used or r.u(1) else 0
            deltas.append(n)
        else:
            neg, pos = r.ue(), r.ue()
            for _ in range(neg + pos):
                r.ue(), r.u(1)
            deltas.append(neg + pos)
    if r.u(1):
        for _ in range(r.ue()):
            r.u(poc_bits), r.u(1)
    r.u(1), r.u(1)
    if not r.u(1):
        return None
    if r.u(1) and r.u(8) == 255:
        r.u(32)
    if r.u(1):
        r.u(1)
    if r.u(1):
        r.u(4)
        if r.u(1):
            r.u(24)
    if r.u(1):
        r.ue(), r.ue()
    r.u(3)
    if r.u(1):
        r.ue(), r.ue(), r.ue(), r.ue()
    if not r.u(1):
        return None
    units, scale = r.u(32), r.u(32)
    return Fraction(scale, units) if units and scale else None


def mpeg4_rate(vol: bytes) -> Optional[Fraction]:
    """vop_time_increment_resolution over fixed_vop_time_increment (over 1
    without a fixed rate) of the VOL in `vol`, as FFmpeg sets the codec's
    frame rate; None without a VOL."""
    i = next((sc for sc in start_codes(vol) if sc + 3 < len(vol) and 0x20 <= vol[sc + 3] <= 0x2F),
             None)
    if i is None:
        return None
    r = _Bits(vol[i + 4:i + 40])
    r.u(1), r.u(8)
    ver = 1
    if r.u(1):
        ver = r.u(4)
        r.u(3)
    if r.u(4) == 15:
        r.u(16)
    if r.u(1):
        r.u(3)
        if r.u(1):
            r.u(79)
    shape = r.u(2)
    if shape == 3 and ver != 1:
        r.u(4)
    r.u(1)
    res = r.u(16)
    if not res:
        return None
    r.u(1)
    bits = max((res - 1).bit_length(), 1)
    inc = r.u(bits) if r.u(1) else 1
    return Fraction(res, inc) if inc else None


def codec_rate(codec: str, annexb: bytes) -> Optional[Fraction]:
    """The codec's own frame rate from the parameter sets (or VOL) in
    Annex B bytes, None where they carry none. A header that does not
    parse gives None."""
    try:
        if codec == "mp4v":
            return mpeg4_rate(annexb)
        nals = [n for n in nal_units(annexb) if len(n) > 2]
        if codec == "h264":
            return next((h264_rate(n) for n in nals if n[0] & 0x1F == 7), None)
        # FFmpeg takes the SPS's VUI timing, else the VPS's
        sps = next((n for n in nals if (n[0] >> 1) & 0x3F == 33), None)
        vps = next((n for n in nals if (n[0] >> 1) & 0x3F == 32), None)
        return (sps and hevc_sps_rate(sps)) or (vps and hevc_rate(vps)) or None
    except (ValueError, IndexError):
        return None
    return None


# --------------------------------------------------------------------------- #
# frame rates as avformat_find_stream_info estimates them
# --------------------------------------------------------------------------- #

ANALYZED = 42          # packets avformat_find_stream_info reads for 40 frame durations


def _std_rates() -> List[int]:
    """get_std_framerate(i) for every i: rates in units of 1/(12*1001)."""
    out = [(i + 1) * 1001 for i in range(30 * 12)]
    out += [(i + 31) * 1001 * 12 for i in range(30)]
    out += [r * 1001 * 12 for r in (80, 120, 240)]
    out += [r * 1000 * 12 for r in (24, 30, 60, 12, 15, 48)]
    return out


STD_RATES = _std_rates()


def reduce(num: int, den: int, limit: int) -> Fraction:
    """av_reduce(num, den, limit): the continued-fraction approximation of
    num/den whose terms stay within `limit`."""
    if not den:
        return Fraction(0)
    g = math.gcd(num, den)
    num, den = num // g, den // g
    if num <= limit and den <= limit:
        return Fraction(num, den)
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    while den:
        x = num // den
        nxt = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, nxt
    return Fraction(a1n, a1d)


def snap(rate: Fraction) -> Fraction:
    """The standard rate within 1% of `rate` nearest to it, else `rate`."""
    best, best_err = None, 0.01
    for s in STD_RATES:
        err = abs(float(rate) / (s / (12 * 1001)) - 1)
        if err < best_err:
            best, best_err = s, err
    return Fraction(best, 12 * 1001) if best else rate


def rfps(ticks: Sequence[int], tb: Fraction) -> Optional[Fraction]:
    """ff_rfps_calculate's rate from increasing timestamps (in units of
    `tb`): the standard rate whose frame grid they fit best, None if none
    fits within its limits."""
    err = [[[0.0] * len(STD_RATES) for _ in range(2)] for _ in range(2)]
    count, total, last = 0, 0, None
    for ts in ticks:
        if last is not None and ts > last:
            dts = ts * float(tb)
            for i, s in enumerate(STD_RATES):
                if err[0][1][i] < 1e10:
                    sdts = dts * s / (1001 * 12)
                    for j in range(2):
                        t = math.floor(sdts + j * 0.5 + 0.5)
                        e = sdts - t + j * 0.5
                        err[j][0][i] += e
                        err[j][1][i] += e * e
            count += 1
            total += ts - last
            if count % 10 == 0:
                for i in range(len(STD_RATES)):
                    if err[0][1][i] < 1e10:
                        a0 = err[0][0][i] / count
                        e0 = err[0][1][i] / count - a0 * a0
                        a1 = err[1][0][i] / count
                        e1 = err[1][1][i] / count - a1 * a1
                        if e0 > 0.04 and e1 > 0.04:
                            err[0][1][i] = err[1][1][i] = 2e10
        last = ts
    if count < 2:
        return None
    best_err, num = 0.01, 0
    for i, s in enumerate(STD_RATES):
        if s < 1001 * 12:
            continue
        if float(tb) * total / count < (1001 * 12.0 * 0.8) / s:
            continue
        for k in range(2):
            a = err[k][0][i] / count
            e = err[k][1][i] / count - a * a
            if e < best_err and best_err > 1e-9:
                best_err, num = e, s
    return Fraction(num, 12 * 1001) if num else None


def avg_rate(durations: Sequence[int], ticks: Sequence[int], tb: Fraction) -> Fraction:
    """A stream's avg_frame_rate as `avformat_find_stream_info` estimates it
    from the packets it reads (`durations` in units of `tb`, 0 where
    unknown; `ticks` their decoding timestamps in order)."""
    counted = [d for d in durations[2:] if d > 0]
    if counted:
        return snap(reduce(len(counted) * tb.denominator, sum(counted) * tb.numerator, 60000))
    r = rfps(ticks, tb)
    if r is None:
        return Fraction(0)
    steps = [b - a for a, b in zip(ticks, ticks[1:]) if b > a]
    if len(steps) > 2 and abs(1 / float(r * tb) - sum(steps) / len(steps)) <= 1.0:
        return r
    return Fraction(0)


def frame_duration(rate: Optional[Fraction], tb: Fraction) -> int:
    """One frame of the codec's rate in units of `tb`, rounded down, as
    FFmpeg gives a packet without a duration one; 0 where the rate is
    unknown or 1000 fps or more."""
    if not rate or rate.denominator * 1000 <= rate.numerator:
        return 0
    return int(Fraction(rate.denominator, rate.numerator) / tb)


def frame_count(duration_s: float, fps: float) -> int:
    """cv2's CAP_PROP_FRAME_COUNT without nb_frames: duration x fps,
    rounded."""
    return int(math.floor(duration_s * fps + 0.5))



# --------------------------------------------------------------------------- #
# raw Annex B probes (FFmpeg's h264_probe and hevc_probe)
# --------------------------------------------------------------------------- #

def _probe_ue(data, pos: int) -> int:
    """get_ue_golomb_long from data[pos:], zeros past the end (FFmpeg's
    padding): an all-zero code reads as 2^32 - 1."""
    bits = int.from_bytes(bytes(data[pos:pos + 8]).ljust(8, b"\x00"), "big")
    top = bits >> 32
    if not top:
        return (1 << 32) - 1
    log = 31 - (top.bit_length() - 1)
    return ((bits >> (64 - 2 * log - 1)) & ((1 << (log + 1)) - 1)) - 1


_H264_REF_ZERO = (2, 0, 0, 0, 0, -1, 1, -1, -1, 1, 1, 1, 1, -1, 2, 2,
                  2, 2, 2, 0, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)


def h264_probe(buf: bytes) -> bool:
    """FFmpeg's h264_probe: an SPS, a PPS naming it, and an IDR slice or more
    than 3 slices naming the PPS, with few NAL units of reserved types."""
    sps = pps = idr = sli = res = 0
    sps_ids, pps_ids = set(), set()
    n = len(buf)
    for sc in start_codes(buf, 0, max(n - 1, 0)):
        i = sc + 3
        if i + 2 >= n + 2 or i >= n:
            break
        code = buf[i]
        ref, t = (code >> 5) & 3, code & 0x1F
        if code & 0x80:
            return False
        if _H264_REF_ZERO[t] == 1 and ref:
            return False
        if _H264_REF_ZERO[t] == -1 and not ref:
            return False
        if _H264_REF_ZERO[t] == 2 and not (code == 0 and sc + 5 < n and not buf[i + 1]
                                           and not buf[i + 2]):
            res += 1
        if t in (1, 5):
            r = _Bits(bytes(buf[i + 1:i + 33]).ljust(32, b"\x00"))
            try:
                r.ue()
                if r.ue() > 9:
                    return False
                pid = r.ue()
            except ValueError:
                return False
            if pid > 256:
                return False
            if pid in pps_ids:
                if t == 1:
                    sli += 1
                else:
                    idr += 1
        elif t == 7:
            if i + 3 >= n or buf[i + 2] & 3:
                return False
            sid = _probe_ue(buf, i + 4)
            if sid > 32:
                return False
            sps_ids.add(sid)
            sps += 1
        elif t == 8:
            r = _Bits(bytes(buf[i + 1:i + 33]).ljust(32, b"\x00"))
            try:
                pid, sid = r.ue(), r.ue()
            except ValueError:
                return False
            if pid > 256 or sid > 32:
                return False
            if sid in sps_ids:
                pps_ids.add(pid)
                pps += 1
    return bool(sps and pps and (idr or sli > 3) and res < sps + pps + idr)


def hevc_probe(buf: bytes) -> bool:
    """FFmpeg's hevc_probe: a VPS, an SPS, a PPS and an IRAP slice, with
    every NAL header's forbidden and layer bits zero."""
    vps = sps = pps = irap = 0
    n = len(buf)
    for sc in start_codes(buf):
        i = sc + 3
        if i + 1 >= n:
            break
        code, nal2 = buf[i], buf[i + 1]
        if code & 0x81 or nal2 & 0xF8:
            return False
        t = (code & 0x7E) >> 1
        vps += t == 32
        sps += t == 33
        pps += t == 34
        irap += 16 <= t <= 21 and t not in (22, 23)
    return bool(vps and sps and pps and irap)


RAW_EXTENSIONS = {"h264": (".h264", ".264", ".h26l", ".avc"), "hevc": (".hevc", ".h265", ".265")}
PROBE_SIZES = tuple(2048 << k for k in range(10))       # 2 KiB .. 1 MiB, as FFmpeg grows its probe


def sniff_raw(head: bytes, name: str = "") -> str:
    """"h264" or "hevc" if FFmpeg would open `head` (a file's first MiB) as a
    raw Annex B stream: its probe at the first of its growing sizes that
    passes, else the file's extension; "" otherwise."""
    for size in PROBE_SIZES:
        buf = head[:size]
        if h264_probe(buf):
            return "h264"
        if hevc_probe(buf):
            return "hevc"
        if size >= len(head):
            break
    ext = name.lower().rsplit(".", 1)[-1] if "." in name else ""
    for codec, exts in RAW_EXTENSIONS.items():
        if "." + ext in exts:
            return codec
    return ""

