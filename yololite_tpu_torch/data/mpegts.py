"""MPEG-TS and M2TS: the first video stream of a transport stream as FFmpeg's
mpegts demuxer and its parser give it to cv2.VideoCapture.

The stream is found by the PAT and the first PMT that lists a video
stream; its PES packets are reassembled from the transport packets'
payloads (adaptation fields skipped; a PES of known length ends at its
length, the bytes after it up to the next unit start dropped, as FFmpeg
drops them; continuity errors and the transport error bit do not drop
data, as FFmpeg only flags them), and the elementary stream they carry is
cut into packets by `esparse.Splitter`, as FFmpeg's parser cuts it: a PES
may hold several access units and an access unit may span several PES.
Opening a file walks it once, keeping per PES only where it starts (the
file offset of its first transport packet and the offset of its first
byte in the elementary stream) and its timestamps, and per packet its
offset and size in the elementary stream (`video.Sample`). Reading walks
the transport packets again, from the PES that holds the packet
(`EsView`), as FFmpeg reads a stream.

Packets are 188 bytes, 192 in M2TS (a 4-byte arrival time first) and 204
with Reed-Solomon parity after each; a lost sync byte is found again as
FFmpeg finds it. Stream types read: 0x1B H.264, 0x24 HEVC, 0x10 MPEG-4
Part 2; the rest raise `UnsupportedVideo` by name.

fps is what FFmpeg estimates from the packets (`esparse.avg_rate`, 90 kHz
ticks: one frame of the codec's rate each, else the PES timestamps), and
frame_count is cv2's ⌊duration x fps + 0.5⌋ with FFmpeg's duration: the
last PTS plus one frame, less the first.
"""

from __future__ import annotations

from array import array
from bisect import bisect_right
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from yololite_tpu_torch.data import esparse

SYNC = 0x47
SIZES = ((188, 0), (192, 4), (204, 0))          # (packet size, offset of the TS header)
VIDEO_TYPES = {0x1B: "h264", 0x24: "hevc", 0x10: "mp4v"}
NAMED_TYPES = {0x01: "MPEG-1 video", 0x02: "MPEG-2 video", 0x20: "H.264 MVC", 0x21: "JPEG 2000",
               0x33: "H.266/VVC", 0x42: "AVS (CAVS)", 0xD1: "Dirac", 0xD2: "AVS2", 0xD4: "AVS3",
               0xEA: "VC-1"}
TB = Fraction(1, 90000)
PTS_WRAP = 1 << 33
READ = 1 << 20
FEED = 1 << 16              # bytes of the elementary stream handed to the parser at once
MAX_PROBE = 10
NONE = -1                   # a PES without that timestamp


def packet_layout(head: bytes) -> Optional[Tuple[int, int]]:
    """(packet size, header offset) if `head` starts a transport stream:
    the sync byte at each of its first packets (at most `MAX_PROBE`)."""
    for size, off in SIZES:
        n = min(len(head) // size, MAX_PROBE)
        if n and all(head[off + k * size] == SYNC for k in range(n)):
            return size, off
    return None


def _crc_table():
    out = []
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else c << 1
        out.append(c & 0xFFFFFFFF)
    return out


_CRC = _crc_table()


def crc32(data: bytes) -> int:
    """CRC-32/MPEG-2 of a PSI section (0 over a section with its CRC)."""
    c = 0xFFFFFFFF
    for b in data:
        c = ((c << 8) & 0xFFFFFFFF) ^ _CRC[(c >> 24) ^ b]
    return c


def _ts(b: bytes, i: int) -> int:
    return (((b[i] >> 1) & 7) << 30 | b[i + 1] << 22 | (b[i + 2] >> 1) << 15
            | b[i + 3] << 7 | b[i + 4] >> 1)


class _Pes:
    """The PES being reassembled."""

    def __init__(self):
        self.head = bytearray()       # its header's bytes, as they come
        self.header_len = None        # bytes of header, once known
        self.length = 0               # PES_packet_length (0: unbounded)
        self.got = 0                  # bytes after the length field
        self.done = False


class TsDemuxer:
    """Walks a file's transport packets. Opening (`pid` None): finds the
    video stream by the PSI and keeps its PES starts (`pes_at`, `pes_es`),
    timestamps and the parser's cuts of its elementary stream; reading
    (`pid` given): collects the elementary stream's bytes in `collect`."""

    def __init__(self, f, file_size: int, layout: Tuple[int, int], pid: Optional[int] = None,
                 es_len: int = 0):
        self.f, self.file_size = f, file_size
        self.size, self.off = layout
        self.scanning = pid is None
        self.pmt_pids: List[int] = []
        self.pid = pid
        self.codec = None
        self.other_video: Optional[str] = None
        self.sections: Dict[int, bytearray] = {}
        self.pes: Optional[_Pes] = None
        self.es_len = es_len
        self.buf, self.base = b"", 0
        self.collect = bytearray()                       # reading: the stream's bytes
        self.pes_at = array("q")                         # file offset of each PES's first packet
        self.pes_es = array("q")                         # stream offset of its first byte
        self.pts, self.dts = array("q"), array("q")      # each PES's, NONE where it has none
        self.splitter: Optional[esparse.Splitter] = None
        self.pending = bytearray()                       # stream bytes not yet parsed
        self.cuts = array("q")
        self.head_bytes = bytearray()                    # the stream's first bytes

    # -- transport packets ---------------------------------------------------
    def run(self, pos: int = 0, until: Optional[int] = None) -> int:
        """Walks the packets from file offset `pos` to the end of the file,
        or until the stream holds `until` bytes; the offset to go on from,
        -1 at the end."""
        size = self.size
        while pos + size <= self.file_size:
            if pos < self.base or pos + size > self.base + len(self.buf):
                self.f.seek(pos)
                self.buf, self.base = self.f.read(READ), pos
            i = pos - self.base
            if self.buf[i + self.off] != SYNC:
                pos = self._resync(pos)
                if pos < 0:
                    break
                continue
            self._packet(self.buf[i + self.off:i + self.off + 188], pos)
            pos += size
            if until is not None and self.es_len >= until:
                return pos
        if self.splitter is not None:
            self._feed(final=True)
        return -1

    def _resync(self, pos: int) -> int:
        """The next offset whose sync byte has another one packet after it
        (FFmpeg's resync), -1 at the end of the file."""
        while True:
            self.f.seek(pos + 1)
            chunk = self.f.read(READ + self.size + 1)
            if len(chunk) <= self.size:
                return -1
            j = 0
            while True:
                j = chunk.find(bytes([SYNC]), j)
                if j < 0 or j + self.size >= len(chunk):
                    break
                if chunk[j + self.size] == SYNC:
                    return pos + 1 + j - self.off
                j += 1
            pos += READ

    def _packet(self, p: bytes, at: int) -> None:
        pid = (p[1] & 0x1F) << 8 | p[2]
        start = bool(p[1] & 0x40)
        afc = (p[3] >> 4) & 3
        i = 4
        if afc & 2:
            i = 5 + p[4]
        if not afc & 1 or i >= 188:
            return
        payload = p[i:]
        if pid == self.pid:
            if start and self.scanning:
                self.pes_at.append(at)
                self.pes_es.append(self.es_len)
            self._pes(payload, start)
        elif self.pid is None and not self.other_video and (pid == 0 or pid in self.pmt_pids):
            self._section(pid, payload, start)

    # -- PSI -----------------------------------------------------------------
    def _section(self, pid: int, payload: bytes, start: bool) -> None:
        if start:
            ptr = payload[0]
            self.sections[pid] = bytearray(payload[1 + ptr:])
        elif pid in self.sections:
            self.sections[pid] += payload
        else:
            return
        sec = self.sections[pid]
        if len(sec) < 3:
            return
        n = ((sec[1] & 0x0F) << 8 | sec[2]) + 3
        if len(sec) < n:
            return
        del self.sections[pid]
        if crc32(bytes(sec[:n])):
            return                                     # FFmpeg drops a section whose CRC fails
        sec = bytes(sec[:n - 4])
        if pid == 0 and sec[0] == 0x00:
            for k in range(8, len(sec) - 3, 4):
                program = sec[k] << 8 | sec[k + 1]
                pmt = (sec[k + 2] & 0x1F) << 8 | sec[k + 3]
                if program and pmt not in self.pmt_pids:
                    self.pmt_pids.append(pmt)
        elif sec[0] == 0x02 and self.pid is None and not self.other_video and len(sec) >= 12:
            k = 12 + ((sec[10] & 0x0F) << 8 | sec[11])
            while k + 5 <= len(sec):
                kind = sec[k]
                epid = (sec[k + 1] & 0x1F) << 8 | sec[k + 2]
                k += 5 + ((sec[k + 3] & 0x0F) << 8 | sec[k + 4])
                if kind in VIDEO_TYPES:
                    self.pid, self.codec = epid, VIDEO_TYPES[kind]
                    self.splitter = esparse.Splitter(self.codec)
                    return
                if kind in NAMED_TYPES:         # cv2 takes the first video stream
                    self.other_video = f"{NAMED_TYPES[kind]} (stream type 0x{kind:02X})"
                    return

    # -- PES -----------------------------------------------------------------
    def _pes(self, payload: bytes, start: bool) -> None:
        if start:
            self.pes = _Pes()
        pes = self.pes
        if pes is None or pes.done:
            return
        k = 0
        if pes.header_len is None or len(pes.head) < pes.header_len:
            take = payload[:(pes.header_len or 9) - len(pes.head)]
            pes.head += take
            k = len(take)
            if pes.header_len is None and len(pes.head) >= 9:
                h = pes.head
                if h[:3] != b"\x00\x00\x01":
                    pes.done = True                  # not a PES: dropped, as FFmpeg drops it
                    return
                pes.length = h[4] << 8 | h[5]
                pes.header_len = 9 + h[8]
                take = payload[k:k + pes.header_len - len(h)]
                pes.head += take
                k += len(take)
            if pes.header_len is None or len(pes.head) < pes.header_len:
                return
            if self.scanning:
                self._stamp(pes.head)
            pes.got = pes.header_len - 6
        data = payload[k:]
        if pes.length:
            data = data[:max(pes.length - pes.got, 0)]
        if data:
            self._es(data)
            pes.got += len(data)
        if pes.length and pes.got >= pes.length:
            pes.done = True

    def _stamp(self, h: bytearray) -> None:
        flags = h[7] >> 6
        pts = dts = NONE
        if flags & 2 and len(h) >= 14:
            pts = _ts(h, 9)
            dts = _ts(h, 14) if flags == 3 and len(h) >= 19 else pts
        self.pts.append(pts)
        self.dts.append(dts)

    def _es(self, data: bytes) -> None:
        self.es_len += len(data)
        if not self.scanning:
            self.collect += data
            return
        if len(self.head_bytes) < 1 << 16:
            self.head_bytes += data[:(1 << 16) - len(self.head_bytes)]
        self.pending += data
        if len(self.pending) >= FEED:
            self._feed()

    def _feed(self, final: bool = False) -> None:
        self.cuts.extend(self.splitter.feed(bytes(self.pending), final=final))
        self.pending.clear()

    # -- results -------------------------------------------------------------
    def packets(self) -> List[Tuple[int, int]]:
        """(stream offset, size) of each packet, in order."""
        edges = [0] + [c for c in self.cuts if 0 < c < self.es_len] + [self.es_len]
        return [(a, b - a) for a, b in zip(edges, edges[1:]) if b > a]

    def timestamps(self) -> List[int]:
        """The PES presentation times, unwrapped, in file order."""
        out, prev, add = [], None, 0
        for pts in self.pts:
            if pts == NONE:
                continue
            if prev is not None and pts + add < prev - PTS_WRAP // 2:
                add += PTS_WRAP
            out.append(pts + add)
            prev = pts + add
        return out

    def decode_times(self) -> List[int]:
        return [d for d in self.dts if d != NONE]


class EsView:
    """The elementary stream of one PID as a file: `seek` to an offset of
    the stream, `read` its bytes. A read walks the transport packets from
    the PES that holds its first byte, or on from where the last read
    stopped when it starts there."""

    def __init__(self, f, file_size: int, layout: Tuple[int, int], pid: int, pes_at: array,
                 pes_es: array):
        self.f, self.file_size, self.layout, self.pid = f, file_size, layout, pid
        self.pes_at, self.pes_es = pes_at, pes_es
        self.pos, self.lo, self.next = 0, 0, -1      # lo: stream offset of walk.collect[0]
        self.walk: Optional[TsDemuxer] = None

    def seek(self, pos: int) -> None:
        self.pos = pos

    def read(self, n: int) -> bytes:
        a, w = self.pos, self.walk
        if w is None or not self.lo <= a <= w.es_len:
            k = max(bisect_right(self.pes_es, a) - 1, 0)
            w = self.walk = TsDemuxer(self.f, self.file_size, self.layout, self.pid,
                                      self.pes_es[k] if self.pes_es else 0)
            self.lo, self.next = w.es_len, self.pes_at[k] if self.pes_at else -1
        while w.es_len < a + n and self.next >= 0:
            self.next = w.run(self.next, until=a + n)
        del w.collect[:a - self.lo]
        self.lo = a
        data = bytes(w.collect[:n])
        self.pos = a + len(data)
        return data


class Demuxed:
    """What `demux` finds: the codec, each packet as a `video.Sample` of the
    elementary stream, fps and frame_count as cv2 reports them; `source(f)`
    is the elementary stream of the open file `f`."""

    def __init__(self, d: TsDemuxer):
        from yololite_tpu_torch.data.video import Sample
        self.codec = d.codec
        self.samples = [Sample(a, n) for a, n in d.packets()]
        self.fps, self.frame_count = 0.0, 0
        self._view = (d.file_size, (d.size, d.off), d.pid, d.pes_at, d.pes_es)

    def source(self, f) -> EsView:
        return EsView(f, *self._view)


def demux(f, file_size: int, layout: Tuple[int, int]) -> Demuxed:
    """The first video stream of a transport stream (`Demuxed`)."""
    from yololite_tpu_torch.data.video import unsupported
    d = TsDemuxer(f, file_size, layout)
    d.run()
    if d.pid is None:
        if d.other_video:
            raise unsupported(f"{d.other_video} in MPEG-TS")
        raise ValueError("MPEG-TS without a video stream in its PMT")
    out = Demuxed(d)
    if not out.samples:
        raise ValueError("MPEG-TS video stream without data")
    rate = esparse.codec_rate(d.codec, bytes(d.head_bytes))
    dur = esparse.frame_duration(rate, TB)
    fps = esparse.avg_rate([dur] * len(out.samples), d.decode_times(), TB)
    pts = d.timestamps()
    if pts and fps:
        end = esparse.frame_duration(fps, TB)
        us = round((max(pts) + end - min(pts)) * Fraction(10 ** 6, 90000))
        out.frame_count = esparse.frame_count(us / 1e6, float(fps))
    out.fps = float(fps)
    return out
