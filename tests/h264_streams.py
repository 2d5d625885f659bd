"""H.264 syntax that x264 never writes, made by rewriting x264's streams
(`h264_fixtures.encode`) at the bit level: parameter sets and slice headers
are parsed and written again with a change, the slice data copied bit for
bit (CAVLC) or byte for byte after the CABAC alignment. Each rewrite is a
legal stream; cv2 decodes it and `tests/test_torch_port_h264.py` holds the
port to cv2 on it.

  - `poc_type1`: POC type 1 (an offset cycle and per-slice deltas that give
    the original POCs), B-frames;
  - `poc_type1_always_zero`: POC type 1 with delta_pic_order_always_zero,
    P-only;
  - `long_term_idr`: every IDR a long-term reference, P and B (temporal
    direct with a long-term picture);
  - `mmco`: MMCO 4, 3, 6, 2, 1 and 5 (frame_num and POC reset) on a P-only
    stream, more frames kept (max_num_ref_frames raised);
  - `list_modification`: reordering commands (short- and long-term) in P
    slices;
  - `gaps`: gaps_in_frame_num_value_allowed with frame_num doubled (a
    non-existing frame before each picture, in the lists of a P-only
    stream with 3 references);
  - `ipcm_cavlc` / `ipcm_cabac`: the IDR picture as I_PCM macroblocks
    (CABAC through an arithmetic encoder, 9.3.4), the later pictures as
    x264 wrote them;
  - `explicit_bipred`: weighted_bipred_idc 1 with a pred_weight_table in
    each B slice (x264 writes implicit weights only);
  - `second_chroma_offset`: a second_chroma_qp_index_offset unlike the first;
  - `direct_4x4`: direct_8x8_inference_flag 0;
  - `mvc_svc_nal_units`: prefix NAL units (14), a subset SPS (15) and slice
    extensions (20) around the base view, which FFmpeg skips;
  - `aud_filler_sei`: access unit delimiters, filler data and unregistered
    SEI around the slices;
  - `no_restriction_*`: B-frame streams whose VUI lacks
    bitstream_restriction, so the output delay is FFmpeg's guess;
  - `sps_repeated_between_slices`: the SPS sent again, unchanged, between
    the slices of each picture;
  - `inband_pps_buffering_sei`: a PPS without an SPS and buffering-period
    SEI in the packets, where FFmpeg's `h264_mp4toannexb` adds avcC's
    parameter sets.

`refused_stream` and `malformed_stream` make what the decoder refuses or
rejects.
"""

from __future__ import annotations

import os
import re
from typing import List

import h264_fixtures as hf

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "yololite_tpu_torch", "csrc", "h264dec.cpp")


# --------------------------------------------------------------------------- #
# bits
# --------------------------------------------------------------------------- #

def unescape(payload: bytes) -> bytes:
    out, zeros = bytearray(), 0
    for b in payload:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        zeros = zeros + 1 if b == 0 else 0
        out.append(b)
    return bytes(out)


def escape(rbsp: bytes) -> bytes:
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class Reader:
    def __init__(self, data: bytes):
        self.d, self.pos = data, 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.d[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        z = 0
        while not self.u(1):
            z += 1
        return (1 << z) - 1 + self.u(z)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def rest(self) -> List[int]:
        """The remaining bits up to and excluding rbsp_stop_one_bit."""
        last = len(self.d) * 8 - 1
        while last >= 0 and not (self.d[last >> 3] >> (7 - (last & 7))) & 1:
            last -= 1
        return [(self.d[i >> 3] >> (7 - (i & 7))) & 1 for i in range(self.pos, last)]


class Writer:
    def __init__(self):
        self.bits: List[int] = []

    def u(self, v: int, n: int):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def ue(self, v: int):
        n = (v + 1).bit_length()
        self.u(0, n - 1)
        self.u(v + 1, n)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def rbsp(self) -> bytes:
        """The bits with rbsp_trailing_bits."""
        b = self.bits + [1]
        b += [0] * (-len(b) % 8)
        return bytes(int("".join(map(str, b[i:i + 8])), 2) for i in range(0, len(b), 8))

    def align_ones(self):
        while len(self.bits) % 8:
            self.bits.append(1)

    def align_zeros(self):
        while len(self.bits) % 8:
            self.bits.append(0)


def nal(nal_type: int, ref_idc: int, rbsp: bytes) -> bytes:
    return bytes([(ref_idc << 5) | nal_type]) + escape(rbsp)


# --------------------------------------------------------------------------- #
# parameter sets and slice headers
# --------------------------------------------------------------------------- #

HIGH = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


def parse_sps(rbsp: bytes) -> dict:
    r = Reader(rbsp)
    s = {"profile": r.u(8), "constraint": r.u(8), "level": r.u(8), "id": r.ue()}
    if s["profile"] in HIGH:
        s["chroma"] = r.ue()
        s["bd"] = (r.ue(), r.ue())
        s["bypass"] = r.u(1)
        s["scaling"] = r.u(1)
        assert not s["scaling"], "SPS scaling lists are not rewritten"
    s["log2_fn"] = r.ue() + 4
    s["poc_type"] = r.ue()
    if s["poc_type"] == 0:
        s["log2_lsb"] = r.ue() + 4
    elif s["poc_type"] == 1:
        s["always_zero"], s["non_ref"], s["t2b"] = r.u(1), r.se(), r.se()
        s["cycle"] = [r.se() for _ in range(r.ue())]
    s["max_refs"], s["gaps"] = r.ue(), r.u(1)
    s["mbw"], s["mbh"] = r.ue() + 1, r.ue() + 1
    s["frame_mbs_only"] = r.u(1)
    assert s["frame_mbs_only"]
    s["direct_8x8"] = r.u(1)
    s["crop"] = [r.ue() for _ in range(4)] if r.u(1) else None
    s["tail"] = r.rest()           # vui_parameters_present_flag and the VUI, as they are
    return s


def write_sps(s: dict) -> bytes:
    w = Writer()
    w.u(s["profile"], 8), w.u(s["constraint"], 8), w.u(s["level"], 8), w.ue(s["id"])
    if s["profile"] in HIGH:
        w.ue(s["chroma"]), w.ue(s["bd"][0]), w.ue(s["bd"][1]), w.u(s["bypass"], 1), w.u(0, 1)
    w.ue(s["log2_fn"] - 4), w.ue(s["poc_type"])
    if s["poc_type"] == 0:
        w.ue(s["log2_lsb"] - 4)
    elif s["poc_type"] == 1:
        w.u(s["always_zero"], 1), w.se(s["non_ref"]), w.se(s["t2b"]), w.ue(len(s["cycle"]))
        for v in s["cycle"]:
            w.se(v)
    w.ue(s["max_refs"]), w.u(s["gaps"], 1), w.ue(s["mbw"] - 1), w.ue(s["mbh"] - 1)
    w.u(1, 1), w.u(s["direct_8x8"], 1)
    w.u(1 if s["crop"] else 0, 1)
    for v in s["crop"] or []:
        w.ue(v)
    w.bits += s["tail"]
    return w.rbsp()


def parse_pps(rbsp: bytes) -> dict:
    r = Reader(rbsp)
    p = {"id": r.ue(), "sps": r.ue(), "cabac": r.u(1), "bfpo": r.u(1)}
    assert r.ue() == 0
    p["refs"] = (r.ue() + 1, r.ue() + 1)
    p["wp"], p["wbi"] = r.u(1), r.u(2)
    p["qp"], p["qs"], p["cqp"] = r.se(), r.se(), r.se()
    p["deblock"], p["cip"], p["rpc"] = r.u(1), r.u(1), r.u(1)
    tail = r.rest()
    p["t8x8"] = p["scaling"] = None
    if tail:
        r2 = Reader(bytes(int("".join(map(str, (tail + [1] + [0] * 7)[i:i + 8])), 2)
                          for i in range(0, len(tail) + 8, 8)))
        p["t8x8"], p["scaling"] = r2.u(1), r2.u(1)
        assert not p["scaling"], "PPS scaling lists are not rewritten"
        p["cqp2"] = r2.se()
    return p


def write_pps(p: dict) -> bytes:
    w = Writer()
    w.ue(p["id"]), w.ue(p["sps"]), w.u(p["cabac"], 1), w.u(p["bfpo"], 1), w.ue(0)
    w.ue(p["refs"][0] - 1), w.ue(p["refs"][1] - 1), w.u(p["wp"], 1), w.u(p["wbi"], 2)
    w.se(p["qp"]), w.se(p["qs"]), w.se(p["cqp"])
    w.u(p["deblock"], 1), w.u(p["cip"], 1), w.u(p["rpc"], 1)
    if p["t8x8"] is not None:
        w.u(p["t8x8"], 1), w.u(0, 1), w.se(p["cqp2"])
    return w.rbsp()


def parse_slice(rbsp: bytes, nal_type: int, ref_idc: int, sps: dict, pps: dict) -> dict:
    r = Reader(rbsp)
    h = {"nal_type": nal_type, "ref_idc": ref_idc, "first_mb": r.ue(), "type_raw": r.ue(),
         "pps": r.ue()}
    t = h["type"] = h["type_raw"] % 5
    h["frame_num"] = r.u(sps["log2_fn"])
    if nal_type == 5:
        h["idr_id"] = r.ue()
    if sps["poc_type"] == 0:
        h["lsb"] = r.u(sps["log2_lsb"])
        if pps["bfpo"]:
            h["dbottom"] = r.se()
    if sps["poc_type"] == 1 and not sps["always_zero"]:
        h["dpoc"] = [r.se()] + ([r.se()] if pps["bfpo"] else [])
    if pps["rpc"]:
        h["rpc"] = r.ue()
    if t == 1:
        h["direct_spatial"] = r.u(1)
    if t in (0, 1):
        h["override"] = r.u(1)
        if h["override"]:
            h["nref"] = [r.ue() + 1] + ([r.ue() + 1] if t == 1 else [])
    nref = h.get("nref") or [pps["refs"][0], pps["refs"][1]]
    h["mods"] = []
    for lst in range({0: 1, 1: 2}.get(t, 0)):
        mods = None
        if r.u(1):
            mods = []
            while True:
                idc = r.ue()
                if idc == 3:
                    break
                mods.append((idc, r.ue()))
        h["mods"].append(mods)
    if (pps["wp"] and t == 0) or (pps["wbi"] == 1 and t == 1):
        h["pwt"] = _parse_pwt(r, t, nref)
    if ref_idc:
        if nal_type == 5:
            h["no_output"], h["long_term"] = r.u(1), r.u(1)
        else:
            h["adaptive"] = r.u(1)
            h["mmco"] = []
            if h["adaptive"]:
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    args = [r.ue()] if op in (1, 2, 4, 6) else [r.ue(), r.ue()]
                    h["mmco"].append((op, *args))
    if pps["cabac"] and t != 2:
        h["cabac_init"] = r.ue()
    h["qp_delta"] = r.se()
    if pps["deblock"]:
        h["dfi"] = r.ue()
        if h["dfi"] != 1:
            h["alpha"], h["beta"] = r.se(), r.se()
    if pps["cabac"]:
        r.pos = (r.pos + 7) // 8 * 8
        h["data"] = rbsp[r.pos // 8:]            # slice data bytes with the trailing bits
    else:
        h["data_bits"] = r.rest()
    return h


def _parse_pwt(r: Reader, t: int, nref) -> dict:
    w = {"ld": r.ue(), "cd": r.ue(), "lists": []}
    for lst in range(2 if t == 1 else 1):
        entries = []
        for _ in range(nref[lst]):
            luma = (r.se(), r.se()) if r.u(1) else None
            chroma = [(r.se(), r.se()), (r.se(), r.se())] if r.u(1) else None
            entries.append((luma, chroma))
        w["lists"].append(entries)
    return w


def _write_pwt(w: Writer, p: dict):
    w.ue(p["ld"]), w.ue(p["cd"])
    for entries in p["lists"]:
        for luma, chroma in entries:
            w.u(1 if luma else 0, 1)
            if luma:
                w.se(luma[0]), w.se(luma[1])
            w.u(1 if chroma else 0, 1)
            if chroma:
                for a, b in chroma:
                    w.se(a), w.se(b)


def header_bits(h: dict, sps: dict, pps: dict) -> Writer:
    """slice_header() of h, without the CABAC alignment."""
    w = Writer()
    t = h["type"]
    w.ue(h["first_mb"]), w.ue(h["type_raw"]), w.ue(h["pps"]), w.u(h["frame_num"], sps["log2_fn"])
    if h["nal_type"] == 5:
        w.ue(h["idr_id"])
    if sps["poc_type"] == 0:
        w.u(h["lsb"], sps["log2_lsb"])
        if pps["bfpo"]:
            w.se(h["dbottom"])
    if sps["poc_type"] == 1 and not sps["always_zero"]:
        for v in h["dpoc"]:
            w.se(v)
    if pps["rpc"]:
        w.ue(h["rpc"])
    if t == 1:
        w.u(h["direct_spatial"], 1)
    if t in (0, 1):
        w.u(h["override"], 1)
        if h["override"]:
            for v in h["nref"]:
                w.ue(v - 1)
    for mods in h["mods"]:
        w.u(0 if mods is None else 1, 1)
        if mods is not None:
            for idc, v in mods:
                w.ue(idc), w.ue(v)
            w.ue(3)
    if (pps["wp"] and t == 0) or (pps["wbi"] == 1 and t == 1):
        _write_pwt(w, h["pwt"])
    if h["ref_idc"]:
        if h["nal_type"] == 5:
            w.u(h["no_output"], 1), w.u(h["long_term"], 1)
        else:
            w.u(1 if h["mmco"] else 0, 1)
            if h["mmco"]:
                for op, *args in h["mmco"]:
                    w.ue(op)
                    for a in args:
                        w.ue(a)
                w.ue(0)
    if pps["cabac"] and t != 2:
        w.ue(h["cabac_init"])
    w.se(h["qp_delta"])
    if pps["deblock"]:
        w.ue(h["dfi"])
        if h["dfi"] != 1:
            w.se(h["alpha"]), w.se(h["beta"])
    return w


def to_bytes(bits: List[int]) -> bytes:
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def write_slice(h: dict, sps: dict, pps: dict) -> bytes:
    """The slice's RBSP: its header written again, its data as it was."""
    w = header_bits(h, sps, pps)
    if pps["cabac"]:
        w.align_ones()
        return to_bytes(w.bits) + h["data"]
    w.bits += h["data_bits"]
    return w.rbsp()


# --------------------------------------------------------------------------- #
# a stream as parsed units
# --------------------------------------------------------------------------- #

class Parsed:
    """The SPS, PPS and, per packet, its NAL units (type, ref_idc, parsed
    slice header or raw payload)."""

    def __init__(self, stream: hf.Stream):
        self.stream = stream
        ps = hf.nal_units(stream.extradata)
        self.sps = parse_sps(unescape(next(n for n in ps if n[0] & 31 == 7)[1:]))
        self.pps = parse_pps(unescape(next(n for n in ps if n[0] & 31 == 8)[1:]))
        self.packets = []
        for p in stream.packets:
            units = []
            for n in hf.nal_units(p.data):
                t, ref = n[0] & 31, n[0] >> 5
                if t in (1, 5):
                    units.append([t, ref, parse_slice(unescape(n[1:]), t, ref, self.sps, self.pps)])
                else:
                    units.append([t, ref, n[1:]])
            self.packets.append((p, units))

    def slices(self):
        for p, units in self.packets:
            for u in units:
                if u[0] in (1, 5):
                    yield p, u[2]

    def build(self) -> hf.Stream:
        return _build_raw(self)


def poc_type0(parsed: Parsed) -> List[int]:
    """The POC of each picture (8.2.1.1) of a POC type 0 stream, in decoding order."""
    s = parsed.sps
    max_lsb = 1 << s["log2_lsb"]
    prev_msb = prev_lsb = 0
    out, seen = [], set()
    for p, h in parsed.slices():
        if id(p) in seen:
            continue
        seen.add(id(p))
        if h["nal_type"] == 5:
            prev_msb = prev_lsb = 0
        lsb = h["lsb"]
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        out.append(msb + lsb)
        if h["ref_idc"]:
            prev_msb, prev_lsb = msb, lsb
    return out


# --------------------------------------------------------------------------- #
# the rewrites
# --------------------------------------------------------------------------- #

def _poc_type1(always_zero: bool) -> hf.Stream:
    params = "bframes=0:ref=2" if always_zero else "bframes=3:b-pyramid=normal:ref=3"
    parsed = Parsed(hf.encode(hf.scene(14, 96, 128), profile="main", params=params))
    pocs = poc_type0(parsed) if parsed.sps["poc_type"] == 0 else None
    s = parsed.sps
    s.update(poc_type=1, always_zero=int(always_zero), non_ref=-1, t2b=0, cycle=[2])
    max_fn = 1 << s["log2_fn"]
    prev_fn, offset, k, seen = 0, 0, -1, set()
    for p, h in parsed.slices():
        if id(p) not in seen:
            seen.add(id(p))
            k += 1
            if h["nal_type"] == 5:
                offset = 0
            elif prev_fn > h["frame_num"]:
                offset += max_fn
            prev_fn = h["frame_num"]
            abs_fn = offset + h["frame_num"]
            if not h["ref_idc"] and abs_fn > 0:
                abs_fn -= 1
            expected = 2 * (abs_fn - 1) + 2 if abs_fn > 0 else 0
            if not h["ref_idc"]:
                expected += s["non_ref"]
        h.pop("lsb", None)
        if not always_zero:
            h["dpoc"] = [pocs[k] - expected]
    return parsed.build()


def _long_term_idr() -> hf.Stream:
    parsed = Parsed(hf.encode(hf.scene(16, 96, 128), profile="main",
                              params="keyint=8:bframes=2:b-pyramid=none:direct=temporal:ref=1"))
    parsed.sps["max_refs"] += 1
    for _, h in parsed.slices():
        if h["nal_type"] == 5:
            h["long_term"] = 1
    return parsed.build()


def _mmco() -> hf.Stream:
    """P-only (POC type 2), one reference: frame 1 and 3 made long-term by
    MMCO 3 (after MMCO 4 allows three indices), frame 5 by MMCO 6, frame 1
    freed by MMCO 2 and frame 6 by MMCO 1 at frame 7, and MMCO 5 at frame 9
    (frame_num counts from 0 again after it)."""
    parsed = Parsed(hf.encode(hf.scene(14, 96, 128), profile="main", params="bframes=0:ref=1"))
    parsed.sps["max_refs"] = 6
    ops = {2: [(4, 3), (3, 0, 0)], 4: [(3, 0, 1)], 5: [(6, 2)], 7: [(2, 0), (1, 0)], 9: [(5,)]}
    shift = 0
    for k, (_, h) in enumerate(parsed.slices()):
        h["frame_num"] -= shift
        if k in ops:
            h["adaptive"], h["mmco"] = 1, ops[k]
        if k == 9:
            shift = h["frame_num"]
    return parsed.build()


def _list_modification() -> hf.Stream:
    """P-only, one active reference: from frame 3 on, every third P slice
    refers to the picture before last (abs_diff_pic_num_minus1 1), every
    third to long-term 0 (frame 2, made long-term by MMCO 3 at frame 4),
    the others to the last picture by an explicit command."""
    parsed = Parsed(hf.encode(hf.scene(14, 96, 128), profile="main", params="bframes=0:ref=1"))
    parsed.sps["max_refs"] = 5
    for k, (_, h) in enumerate(parsed.slices()):
        if h["type"] != 0 or k < 3:
            continue
        if k == 4:
            h["adaptive"], h["mmco"] = 1, [(4, 1), (3, 1, 0)]
        if k % 3 == 0:
            h["mods"] = [[(0, 1)]]
        elif k % 3 == 1 and k > 4:
            h["mods"] = [[(2, 0)]]
        elif k % 3 == 2:
            h["mods"] = [[(0, 0)]]
    return parsed.build()


def _double_frame_num(parsed: Parsed) -> None:
    """gaps_in_frame_num_value_allowed, frame_num doubled: a non-existing
    frame before each picture, in the sliding window and the lists (x264's
    list modifications and MMCO differences doubled with it,
    max_num_ref_frames raised to hold them)."""
    parsed.sps["gaps"] = 1
    parsed.sps["log2_fn"] += 1
    parsed.sps["max_refs"] = min(16, 2 * parsed.sps["max_refs"] + 2)
    for _, h in parsed.slices():
        h["frame_num"] *= 2
        h["mods"] = [None if m is None else [(i, 2 * v + 1 if i < 2 else v) for i, v in m]
                     for m in h["mods"]]
        if h.get("mmco"):
            h["mmco"] = [(op, 2 * a[0] + 1, *a[1:]) if op in (1, 3) else (op, *a)
                         for op, *a in h["mmco"]]


def _gaps() -> hf.Stream:
    """P-only, 3 references, frame_num doubled (`_double_frame_num`)."""
    parsed = Parsed(hf.encode(hf.scene(12, 96, 128), profile="main", params="bframes=0:ref=3"))
    _double_frame_num(parsed)
    return parsed.build()


def gaps_b_frames(colocated_non_existing: bool = False) -> hf.Stream:
    """Non-reference B pictures with temporal direct across frame_num gaps
    (`_double_frame_num`): before each B the decoder makes a non-existing
    frame, a copy of the last reference with its POC + 2 (as FFmpeg fills
    it), which lands in the B's lists, at the B's own POC for the first.
    colocated_non_existing: each B's POC is moved to just after the last
    reference's, so that list 1 starts with that non-existing frame, the
    colocated picture of temporal direct."""
    parsed = Parsed(hf.encode(hf.scene(12, 96, 128), profile="main",
                              params="bframes=1:b-adapt=0:direct=temporal:ref=2:weightb=0"))
    _double_frame_num(parsed)
    max_lsb = 1 << parsed.sps["log2_lsb"]
    last_ref_lsb = 0
    for _, h in parsed.slices():
        if h["type"] == 1 and colocated_non_existing:
            h["lsb"] = (last_ref_lsb + 1) % max_lsb
        if h["ref_idc"]:
            last_ref_lsb = h["lsb"]
    return parsed.build()


def _bits_reader(bits: List[int]) -> Reader:
    return Reader(to_bytes(bits + [0] * (-len(bits) % 8)))


def without_restriction(tail: List[int]) -> List[int]:
    """An SPS tail (vui_parameters_present_flag and the VUI, HRD-free as
    x264 writes it) with bitstream_restriction_flag 0."""
    r = _bits_reader(tail)
    n0 = len(tail)
    if not r.u(1):
        return tail
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
    if r.u(1):
        r.u(32), r.u(32), r.u(1)
    assert not r.u(1) and not r.u(1), "HRD parameters are not rewritten"
    r.u(1)                                            # pic_struct_present_flag
    at = r.pos
    assert r.u(1) and r.pos <= n0
    return tail[:at] + [0]


def _no_restriction(params: str, frames: int = 14) -> hf.Stream:
    parsed = Parsed(hf.encode(hf.scene(frames, 96, 128), profile="main", params=params))
    parsed.sps["tail"] = without_restriction(parsed.sps["tail"])
    return parsed.build()


def _direct_4x4() -> hf.Stream:
    parsed = Parsed(hf.encode(hf.scene(12, 96, 128), profile="main",
                              params="bframes=3:direct=temporal:8x8dct=0"))
    parsed.sps["direct_8x8"] = 0
    return parsed.build()


def _second_chroma_offset() -> hf.Stream:
    parsed = Parsed(hf.encode(hf.scene(10, 96, 128), profile="high", params="bframes=2",
                              options={"qp": "30"}))
    parsed.pps["cqp2"] = -7
    return parsed.build()


def _explicit_bipred() -> hf.Stream:
    parsed = Parsed(hf.encode(hf.scene(12, 96, 128), profile="main",
                              params="bframes=3:b-pyramid=normal:ref=2:weightb=0"))
    parsed.pps["wbi"] = 1
    for k, (_, h) in enumerate(parsed.slices()):
        if h["type"] != 1:
            continue
        nref = h.get("nref") or list(parsed.pps["refs"])
        lists = []
        for lst in range(2):
            entries = []
            for i in range(nref[lst]):
                luma = (24 + 7 * ((k + i + lst) % 4), ((k * 5 + i) % 11) - 5) \
                    if (k + i + lst) % 3 else None
                chroma = [(30 - lst * 4, 2 - i), (26 + i, -3)] if (k + lst) % 2 else None
                entries.append((luma, chroma))
            lists.append(entries)
        h["pwt"] = {"ld": 5, "cd": 4 + k % 2, "lists": lists}
    return parsed.build()


def _insert_units(kinds) -> hf.Stream:
    parsed = Parsed(hf.encode(hf.scene(10, 96, 128), profile="high", params="bframes=2"))
    for k, (p, units) in enumerate(parsed.packets):
        out = []
        if "aud" in kinds:
            out.append([9, 0, b"\xf0"])                      # primary_pic_type 7
        if "subset_sps" in kinds and k == 0:
            out.append([15, 3, b"\x53\x00\x0a\xff\xa0\x80"])
        if "sei" in kinds:
            out.append([6, 0, bytes([5, 20]) + b"\x01" * 16 + b"yolo" + b"\x80"])
        for u in units:
            if u[0] in (1, 5) and "prefix" in kinds:
                out.append([14, u[1], bytes([0x80 | 0x40, 0x00, 0x07]) + b"\x80"])
            out.append(u)
            if u[0] in (1, 5) and "extension" in kinds:
                out.append([20, u[1], bytes([0x80, 0x01, 0x07]) + b"\x12\x34\x56\x80"])
        if "buffering_sei" in kinds and k % 2:
            out.append([6, 0, b"\x00\x01\x80\x80"])      # buffering period, SPS 0, no HRD
        if "pps" in kinds and k and k % 2 == 0:
            out.append([8, 3, escape(write_pps(parsed.pps))])
        if "filler" in kinds:
            out.append([12, 0, b"\xff" * 9 + b"\x80"])
        parsed.packets[k] = (p, out)
    return parsed.build()


def _sps_between_slices(sps: dict) -> hf.Stream:
    """`sps` (an SPS with x264's id) before the second slice of each picture."""
    parsed = Parsed(hf.encode(hf.scene(4, 48, 64), profile="high", params="slices=2:bframes=0"))
    unit = [7, 3, escape(write_sps(sps(parsed.sps)))]
    for _, units in parsed.packets:
        second = [i for i, u in enumerate(units) if u[0] in (1, 5)][1]
        units.insert(second, unit)
    return _build_raw(parsed)


# ----- I_PCM pictures ------------------------------------------------------ #

def _tables():
    """rangeTabLPS and transIdxLPS (Tables 9-44, 9-45), read from the port's
    source so the encoder below uses the decoder's own tables."""
    src = open(SRC).read()
    lps = re.search(r"kRangeLps\[64\]\[4\] = \{(.*?)\};", src, re.S).group(1)
    trans = re.search(r"kTransLps\[64\] = \{(.*?)\};", src, re.S).group(1)
    nums = [int(v) for v in re.findall(r"\d+", lps)]
    return [nums[4 * i:4 * i + 4] for i in range(64)], [int(v) for v in re.findall(r"\d+", trans)]


class CabacEncoder:
    """The arithmetic encoder of 9.3.4 for the few bins of an I_PCM picture."""

    def __init__(self, w: Writer, qp: int):
        self.lps, self.trans = _tables()
        self.w = w
        self.st = {}
        for ctx, (m, n) in {3: (20, -15), 4: (2, 54), 5: (3, 74)}.items():
            pre = max(1, min(126, ((m * max(0, min(51, qp))) >> 4) + n))
            self.st[ctx] = [63 - pre, 0] if pre <= 63 else [pre - 64, 1]
        self.start()

    def start(self):
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def put(self, b: int):
        if self.first:
            self.first = False
        else:
            self.w.u(b, 1)
        while self.outstanding:
            self.w.u(1 - b, 1)
            self.outstanding -= 1

    def renorm(self):
        while self.range < 256:
            if self.low < 256:
                self.put(0)
            elif self.low >= 512:
                self.low -= 512
                self.put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, b: int):
        p, mps = self.st[ctx]
        lps = self.lps[p][(self.range >> 6) & 3]
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            if p == 0:
                mps = 1 - mps
            p = self.trans[p]
        else:
            p = min(p + 1, 62)
        self.st[ctx] = [p, mps]
        self.renorm()

    def terminate(self, b: int):
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self.renorm()
            self.put((self.low >> 9) & 1)
            self.w.u(((self.low >> 7) & 3) | 1, 2)
        else:
            self.renorm()


def _pcm_idr(cabac: bool) -> hf.Stream:
    """The IDR picture as I_PCM macroblocks carrying the samples x264's IDR
    decodes to, so the P pictures after it predict from the same samples."""
    from yololite_tpu_torch.data.video import H264Decoder
    stream = hf.encode(hf.scene(8, 48, 64), profile="main" if cabac else "baseline",
                       params="bframes=0:keyint=8")
    planes, _ = H264Decoder(stream.extradata).decode(stream.packets[0].data, planes=True)[0]
    parsed = Parsed(stream)
    w_px, h_px = stream.size
    mbw, mbh = parsed.sps["mbw"], parsed.sps["mbh"]
    assert (mbw * 16, mbh * 16) == (w_px, h_px)
    lum, cb, cr = planes
    p0, units = parsed.packets[0]
    idr = next(u for u in units if u[0] == 5)
    h = dict(idr[2], first_mb=0)
    w = header_bits(h, parsed.sps, parsed.pps)
    enc = None
    if cabac:
        w.align_ones()
        enc = CabacEncoder(w, 26 + parsed.pps["qp"] + h["qp_delta"])
    for a in range(mbw * mbh):
        x, y = a % mbw, a // mbw
        if cabac:
            enc.decision(3 + (x > 0) + (y > 0), 1)      # neighbours are I_PCM, not I_NxN
            enc.terminate(1)
        else:
            w.ue(25)
        w.align_zeros()
        for plane, s_ in ((lum, 16), (cb, 8), (cr, 8)):
            for b in plane[y * s_:y * s_ + s_, x * s_:x * s_ + s_].tobytes():
                w.u(b, 8)
        if cabac:
            enc.start()
            enc.terminate(1 if a == mbw * mbh - 1 else 0)
    if cabac:
        w.align_zeros()             # the flush wrote rbsp_stop_one_bit
        body = to_bytes(w.bits)
    else:
        body = w.rbsp()
    idr[2] = body
    idr.append("rbsp")
    return _build_raw(parsed)


def _build_raw(parsed: Parsed) -> hf.Stream:
    """As Parsed.build, with units marked "rbsp" taken as they are."""
    ext = (b"\x00\x00\x00\x01" + nal(7, 3, write_sps(parsed.sps)) + b"\x00\x00\x00\x01"
           + nal(8, 3, write_pps(parsed.pps)))
    packets = []
    for p, units in parsed.packets:
        data = b""
        for u in units:
            t, ref, body = u[0], u[1], u[2]
            if len(u) > 3:
                payload = escape(body)
            elif t in (1, 5):
                payload = escape(write_slice(body, parsed.sps, parsed.pps))
            else:
                payload = body
            data += b"\x00\x00\x00\x01" + bytes([(ref << 5) | t]) + payload
        packets.append(hf.Packet(data, p.pts, p.dts, p.key))
    return hf.Stream(packets, ext, parsed.stream.rate, parsed.stream.size)


REWRITES = {
    "poc_type1": lambda: _poc_type1(False),
    "poc_type1_always_zero": lambda: _poc_type1(True),
    "long_term_idr": _long_term_idr,
    "mmco": _mmco,
    "list_modification": _list_modification,
    "gaps": _gaps,
    "gaps_b_frames": gaps_b_frames,
    "direct_4x4": _direct_4x4,
    "second_chroma_offset": _second_chroma_offset,
    "explicit_bipred": _explicit_bipred,
    "no_restriction_b1": lambda: _no_restriction("bframes=1"),
    "no_restriction_b3": lambda: _no_restriction("bframes=3"),
    "no_restriction_pyramid": lambda: _no_restriction("bframes=3:b-pyramid=normal", 30),
    "ipcm_cavlc": lambda: _pcm_idr(False),
    "ipcm_cabac": lambda: _pcm_idr(True),
    "mvc_svc_nal_units": lambda: _insert_units({"prefix", "subset_sps", "extension"}),
    "aud_filler_sei": lambda: _insert_units({"aud", "sei", "filler"}),
    "sps_repeated_between_slices": lambda: _sps_between_slices(lambda s: s),
    "inband_pps_buffering_sei": lambda: _insert_units({"pps", "buffering_sei"}),
}


def write(case: str, path: str) -> hf.Stream:
    stream = REWRITES[case]()
    hf.write_mp4(path, stream)
    return stream


# syntax the decoder refuses, made by rewriting x264's parameter sets,
# slice headers and NAL unit types: case -> what the message names
REFUSED_SYNTAX = {"data_partitioning": "data partitioning", "slice_groups": "slice groups",
                  "sp_slices": "SP/SI"}


def refused_stream(case: str) -> hf.Stream:
    parsed = Parsed(hf.encode(hf.scene(3, 48, 64), profile="baseline", params="bframes=0"))
    if case == "data_partitioning":      # slices relabelled partition A
        for _, units in parsed.packets:
            for u in units:
                if u[0] == 1:
                    u[0], u[2] = 2, write_slice(u[2], parsed.sps, parsed.pps)
                    u.append("rbsp")
    elif case == "slice_groups":
        w = Writer()
        p = parsed.pps
        w.ue(p["id"]), w.ue(p["sps"]), w.u(p["cabac"], 1), w.u(p["bfpo"], 1)
        w.ue(1), w.ue(0), w.ue(0), w.ue(0)          # two groups, interleaved, runs of 1
        w.ue(p["refs"][0] - 1), w.ue(p["refs"][1] - 1), w.u(0, 1), w.u(0, 2)
        w.se(p["qp"]), w.se(p["qs"]), w.se(p["cqp"]), w.u(p["deblock"], 1), w.u(0, 1), w.u(0, 1)
        stream = _build_raw(parsed)
        nals = hf.nal_units(stream.extradata)
        ext = b"\x00\x00\x00\x01" + nals[0] + b"\x00\x00\x00\x01" + nal(8, 3, w.rbsp())
        return hf.Stream(stream.packets, ext, stream.rate, stream.size)
    else:                                # P slices relabelled SP
        for _, h in parsed.slices():
            if h["type"] == 0:
                h["type_raw"] = 3
    return _build_raw(parsed)


# malformed parameter sets the decoder rejects (ValueError): case -> what
# the message names
MALFORMED_SYNTAX = {"sps_resized_between_slices": "different SPSs",
                    "crop_offset_wraps": "frame_crop_left_offset out of range",
                    "crop_offset_past_width": "frame_crop_right_offset out of range"}


def malformed_stream(case: str) -> hf.Stream:
    if case == "sps_resized_between_slices":     # two macroblocks wider and higher
        return _sps_between_slices(lambda s: dict(s, mbw=s["mbw"] + 2, mbh=s["mbh"] + 2))
    parsed = Parsed(hf.encode(hf.scene(2, 48, 64), profile="high", params="bframes=0"))
    if case == "crop_offset_wraps":              # 2 * offset is -32 in 32 bits: left + right = 0
        parsed.sps["crop"] = [2 ** 31 - 16, 16, 0, 0]
    else:                                        # one offset past the coded width
        parsed.sps["crop"] = [0, 8 * parsed.sps["mbw"], 0, 0]
    return _build_raw(parsed)
