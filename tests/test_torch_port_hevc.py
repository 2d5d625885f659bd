"""The port's HEVC decoding (`yololite_tpu_torch/csrc/hevcdec.cpp` through
`data/video.py`) against `cv2.VideoCapture` (OpenCV 5.0 with FFmpeg's avcodec
62.28.101) and against the encoder's own pictures: every stream here carries
x265's MD5 decoded picture hash SEI, and every decoded picture's planes are
held to it.

  - the committed fixtures (`tests/data/video/hevc/`): their manifest is
    cv2's reading of them; the port's packets (`CAP_PROP_FORMAT = -1`), fps,
    frame count, size and every BGR frame equal it, and every picture's
    planes equal its MD5 SEI;
  - short streams written at test time by the system's libx265 (through its
    FFmpeg 5.1 libavcodec, `tests/hevc_fixtures.py`), one per tool x265 can
    switch on, each equal to cv2 and to its MD5 SEI;
  - the formats and tools the port refuses raise `UnsupportedVideo` naming
    them (the tools x265 never writes come from streams written from
    scratch by `hevc_fixtures.refused_stream`);
  - mutated parameter sets, slice headers and entry points, run in a
    subprocess that must exit normally;
  - the tracker CLI on an HEVC .mp4 gives the tracks of the same clip's
    PNG sequence.

10-bit frames equal cv2's: the port converts them as swscale's scaled
bicubic path does. What cv2 5.0 (FFmpeg 8) converts colour-managed, BT.2020
and the other wide primaries and the PQ and HLG transfers, 8 or 10 bits,
raises `UnsupportedVideo` naming it (the HLG fixture's planes are still held
to their MD5 SEI). Where the port differs from cv2 on purpose (ROADMAP,
"Where the port deliberately differs"): FFmpeg's loop filters at CTU 16 (a
few chroma samples at CTB corners, where the port follows the standard and
the MD5 SEI), held by its own test; and x265's MD5 SEI on a few pictures of
64x64 noise, which both decoders decode alike. Tolerances: none, but the
CTU 16 count, stated in its test.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import cv2

from yololite_tpu_torch.data import video

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import hevc_fixtures as hv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(hv.DIR, "manifest.json")
FIXTURE_BYTES = 700_000
MAIN10 = "f_main10_hlg_640x480.mov"
MAIN10_601 = "n_main10_bt601_640x480.mp4"
CTU16 = "c_ctu16_slices_328x244.mov"
# the fixtures cv2 converts colour-managed: what the port's refusal names
COLOUR_MANAGED = {MAIN10: r"colour_primaries 9 \(BT\.2020\).*transfer_characteristics 18 "
                          r"\(ARIB STD-B67 \(HLG\)\)"}


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    level = cv2.utils.logging.getLogLevel()
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)
    yield
    cv2.utils.logging.setLogLevel(level)


@pytest.fixture
def x265():
    """The system's libx265, for the tests that encode at test time."""
    if not hv.available():
        pytest.skip("no system libavcodec 59 with libx265")


def committed():
    with open(MANIFEST) as f:
        return json.load(f)


def port_read(path):
    r = video.VideoReader(path)
    frames = list(r)
    return r, frames, list(r.packets())


def decoded_planes(r):
    """(planes, sample index) of every picture of a reader's track, decoded
    from the start, before cropping."""
    dec = video.HevcDecoder(r.track.extradata, uncropped=True)
    out = []
    try:
        for k, sample in enumerate(r.samples()):
            out += dec.decode(sample, k, planes=True)
        out += dec.flush(planes=True)
    except ValueError:              # only the sample a truncated file cuts short
        if not r.cut_short:
            raise
    finally:
        dec.close()
    return out


def assert_md5(r, differs=()):
    """Every decoded picture's planes equal the MD5 SEI of its access unit,
    but those of the access units `differs` names, which differ."""
    packets = list(r.packets())
    got = decoded_planes(r)
    assert got
    for planes, k in got:
        hashes = hv.picture_hashes(packets[k])
        assert hashes, f"access unit {k} carries no picture hash"
        assert (hv.planes_md5(planes) == hashes[0]) == (k not in differs), f"access unit {k}"


def assert_equal_cv2(path):
    fps, count, size, packets, frames = hv.cv2_read(path)
    r, got, pk = port_read(path)
    assert (r.fps, r.frame_count, tuple(r.size)) == (fps, count, tuple(size))
    assert len(pk) == len(packets) and all(a == b for a, b in zip(pk, packets))
    assert len(got) == len(frames) > 0
    for k, (a, b) in enumerate(zip(got, frames)):
        assert np.array_equal(a, b), f"frame {k} of {path}"
    assert_md5(r)


def test_manifest_is_cv2s_and_small():
    assert hv.manifest() == committed()
    total = sum(os.path.getsize(os.path.join(hv.DIR, n)) for n in os.listdir(hv.DIR))
    assert total < FIXTURE_BYTES


@pytest.mark.parametrize("name", sorted(n for n, m in committed().items() if "refused" not in m))
def test_fixture_equals_manifest(name):
    m = committed()[name]
    r = video.VideoReader(os.path.join(hv.DIR, name))
    packets = list(r.packets())
    assert (r.fps, r.frame_count, list(r.size)) == (m["fps"], m["frame_count"], m["size"])
    assert [hv.sha(p) for p in packets] == m["packets"]
    assert r.codec == "hevc"
    if name in COLOUR_MANAGED:
        with pytest.raises(video.UnsupportedVideo, match=COLOUR_MANAGED[name]):
            next(iter(r))
        return
    frames = list(r)
    assert len(frames) == len(m["frames"])
    if name != CTU16:
        assert [hv.sha(np.ascontiguousarray(f)) for f in frames] == m["frames"]


@pytest.mark.parametrize("name", sorted(n for n, m in committed().items() if "refused" not in m))
def test_fixture_pictures_match_their_md5(name):
    assert_md5(video.VideoReader(os.path.join(hv.DIR, name)), hv.MD5_DIFFERS.get(name, ()))


def _cv2_frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def test_main10_frames_against_cv2():
    """Main 10 BT.601: every BGR frame equals cv2's. Main 10 HLG: cv2 maps
    the HLG transfer and the BT.2020 primaries to BT.709 SDR, and the port
    refuses the frames naming both; the HLG picture's planes through the
    converter the BT.601 clip uses differ from cv2's frame, the same planes
    re-encoded losslessly without the VUI's colour description equal cv2's
    frame of that stream, so the mapping is what differs."""
    path = os.path.join(hv.DIR, MAIN10_601)
    ours, ref = list(video.VideoReader(path)), _cv2_frames(path)
    assert len(ours) == len(ref) == 12
    for k, (a, b) in enumerate(zip(ours, ref)):
        assert np.array_equal(a, b), f"frame {k}"
    path = os.path.join(hv.DIR, MAIN10)
    with pytest.raises(video.UnsupportedVideo, match=COLOUR_MANAGED[MAIN10]):
        list(video.VideoReader(path))
    planes, _ = decoded_planes(video.VideoReader(path))[0]
    flat = np.concatenate([p.ravel() for p in planes])
    pic = video.Picture(640, 480, 0, 9, 0, depth=10)
    assert np.abs(video.to_bgr(flat, pic, "HEVC").astype(int) - _cv2_frames(path)[0]).max() > 64


# the VUI (x265's params) of the 10-bit streams held to cv2 frame for frame
MAIN10_VUIS = {
    "untagged": "",
    "bt601": "colorprim=smpte170m:transfer=smpte170m:colormatrix=smpte170m",
    "bt709": "colorprim=bt709:transfer=bt709:colormatrix=bt709",
    "bt2020_matrix": "colormatrix=bt2020nc",
    "full_range_bt709": "range=full:colorprim=bt709:transfer=bt709:colormatrix=bt709",
    "fcc_srgb_transfer": "colormatrix=fcc:transfer=iec61966-2-1",
    "smpte240m_lossless_noise": "colormatrix=smpte240m:lossless=1",
}


@pytest.mark.parametrize("vui", sorted(MAIN10_VUIS))
def test_main10_bgr_equals_cv2(x265, tmp_path, vui):
    """10-bit frames through swscale's scaled path as cv2 takes them: the
    15-bit horizontal chroma filter, the MMX vertical rows, the C rows at
    the bottom, for each matrix and range; 56x40 keeps the edge taps."""
    params = MAIN10_VUIS[vui]
    frames = hv.noisy(3, 40, 56, 5) if "noise" in vui else hv.scene(4, 40, 56)
    path = str(tmp_path / f"{vui}.mp4")
    hv.write_mp4(path, hv.encode(frames, profile="main10", pix_fmt="yuv420p10le", params=params),
                 bit_depth=10)
    assert_equal_cv2(path)


# 8-bit streams cv2 converts colour-managed: x265's params, what the port names
MAPPED = {
    "bt2020": ("colorprim=bt2020:transfer=bt709:colormatrix=bt2020nc", r"colour_primaries 9 "),
    "display_p3": ("colorprim=smpte432", r"colour_primaries 12 "),
    "pq": ("transfer=smpte2084", r"transfer_characteristics 16 "),
    "hlg": ("transfer=arib-std-b67", r"transfer_characteristics 18 "),
}


@pytest.mark.parametrize("case", sorted(MAPPED))
def test_colour_managed_streams_raise_naming_it(x265, tmp_path, case):
    """cv2 maps these colours before BGR, at 8 bits too: the port's frames
    would differ from cv2's (shown by converting the decoded planes as an
    untagged stream's), so the reader raises naming the property."""
    params, match = MAPPED[case]
    path = str(tmp_path / f"{case}.mp4")
    hv.write_mp4(path, hv.encode(hv.scene(2, 48, 64), params=params))
    with pytest.raises(video.UnsupportedVideo, match=match + r".*colour-managed"):
        list(video.VideoReader(path))
    planes, _ = decoded_planes(video.VideoReader(path))[0]
    flat = np.concatenate([p.ravel() for p in planes])
    plain = video.to_bgr(flat, video.Picture(64, 48, 0, 9 if "2020" in params else 2, 0), "HEVC")
    assert not np.array_equal(plain, _cv2_frames(path)[0])


def test_main10_refuses_what_its_converter_does_not_hold(x265, tmp_path):
    """Chroma sited other than left, and pictures under 14 samples a side,
    where swscale's 10-bit filters change: refused by name."""
    path = str(tmp_path / "loc1.mp4")
    hv.write_mp4(path, hv.encode(hv.scene(1, 48, 64), profile="main10", pix_fmt="yuv420p10le",
                                 params="chromaloc=1"), bit_depth=10)
    with pytest.raises(video.UnsupportedVideo, match="chroma_sample_loc_type 1"):
        list(video.VideoReader(path))
    for w, h in ((64, 12), (12, 64)):         # x265 writes nothing this small
        planes = np.zeros(w * h * 3 // 2, np.uint16)
        with pytest.raises(video.UnsupportedVideo, match="under 14 samples"):
            video.to_bgr(planes, video.Picture(w, h, 0, 2, 0, depth=10), "HEVC")


def test_ctu16_differs_from_cv2_only_at_ctb_corners():
    """At CTU 16, FFmpeg's deblocking of horizontal chroma edges lags one
    CTB behind (16 luma columns), so its SAO of a CTB reads the chroma
    samples across the next CTB's corner before they are deblocked, where
    the standard deblocks the whole picture first; the port's planes are
    x265's own (MD5 above). In the I pictures (frames 0 and 6) the frames
    differ from cv2's only in 2x2 pixel blocks (one chroma sample each)
    beside a CTB corner; the P and B pictures predicted from them carry
    FFmpeg's samples on, and few pixels differ in all."""
    path = os.path.join(hv.DIR, CTU16)
    ours, ref = list(video.VideoReader(path)), _cv2_frames(path)
    assert len(ours) == len(ref) == 12
    near = (14, 15, 0, 1)
    differing = 0
    for k, (a, b) in enumerate(zip(ours, ref)):
        ys, xs = np.nonzero((a != b).any(axis=2))
        differing += len(ys)
        if k in (0, 6):
            assert len(ys) and all(y % 16 in near and x % 16 in near for y, x in zip(ys, xs))
    assert differing <= CTU16_PIXELS


CTU16_PIXELS = 132         # measured: 132 of 960,384


def test_truncated_fixture_stops_as_cv2():
    name = "k_truncated_320x240.mp4"
    r, frames, _ = port_read(os.path.join(hv.DIR, name))
    assert len(frames) == len(committed()[name]["frames"])
    assert r.cut_short and r.stop_reason.startswith("sample 12 of 24 is cut short")


def test_trimmed_fixture_hides_the_cut_frames():
    r, frames, packets = port_read(os.path.join(hv.DIR, "j_trimmed_320x240.mp4"))
    assert len(packets) == r.frame_count == 24 and len(frames) == 24 - hv.TRIM
    assert sum(r.track.shown) == 24 - hv.TRIM


@pytest.mark.parametrize("name", sorted(hv.REFUSED))
def test_refused_formats_raise_naming_them(name):
    with pytest.raises(video.UnsupportedVideo, match=hv.REFUSED[name]):
        video.VideoReader(os.path.join(hv.DIR, name))
    assert committed()[name] == {"refused": hv.REFUSED[name]}


@pytest.mark.parametrize("case", sorted(hv.REFUSED_TOOLS))
def test_refused_tools_raise_naming_them(case):
    dec = video.HevcDecoder()
    with pytest.raises(video.UnsupportedVideo, match=hv.REFUSED_TOOLS[case]):
        dec.decode(hv.refused_stream(case), 0)
        dec.flush()


# (name, (h, w), frames, encode keyword arguments) of the test-time matrix
MATRIX = [
    ("no_wpp", (96, 128), 6, dict(params="pools=none")),
    ("ctu32_slices3", (192, 160), 4, dict(params="ctu=32:slices=3")),
    ("ctu16_wpp", (96, 128), 4, dict(params="ctu=16")),
    ("tskip_scaling", (96, 128), 4, dict(params="tskip=1:scaling-list=default")),
    ("amp_rect_refs", (96, 128), 6, dict(params="amp=1:rect=1:ref=4:bframes=4")),
    ("weighted", (96, 128), 6, dict(params="weightp=1:weightb=1")),
    ("qp_groups", (128, 128), 4, dict(params="aq-mode=2:qg-size=8:cbqpoffs=3:crqpoffs=-2")),
    ("constrained_intra", (96, 128), 6, dict(params="constrained-intra=1")),
    ("deblock_offsets_no_sao", (96, 128), 4, dict(params="deblock=-3,2:sao=0")),
    ("no_signhide_no_tmvp", (96, 128), 4, dict(params="signhide=0:temporal-mvp=0")),
    ("merge1_no_sis", (128, 128), 4, dict(params="max-merge=1:strong-intra-smoothing=0")),
    ("tu_depth3", (96, 128), 4, dict(params="tu-intra-depth=3:tu-inter-depth=3")),
    ("lossless_noise", (64, 96), 3, dict(params="lossless=1", noise=True)),
    ("bpyramid_keyint", (64, 96), 12, dict(params="keyint=5:min-keyint=5:bframes=3")),
]


@pytest.mark.parametrize("name,size,n,kw", MATRIX, ids=[m[0] for m in MATRIX])
def test_x265_matrix_equals_cv2_and_md5(x265, tmp_path, name, size, n, kw):
    kw = dict(kw)
    frames = hv.noisy(n, *size, seed=n) if kw.pop("noise", False) else hv.scene(n, *size)
    path = str(tmp_path / f"{name}.mp4")
    hv.write_mp4(path, hv.encode(frames, **kw))
    assert_equal_cv2(path)


@pytest.mark.parametrize("qp", [4, 12, 20])
def test_one_ctu_wide_noise_equals_cv2_and_md5_without_a_search_range(x265, tmp_path, qp):
    """64x64 noise, where x265's motion search writes MD5 SEI its stream
    does not code (the o_noise64 fixtures; their frames equal cv2's there):
    with merange=0 x265 writes the same stream every run, and every picture
    equals cv2's and its MD5 SEI."""
    path = str(tmp_path / f"noise64_qp{qp}.mp4")
    hv.write_mp4(path, hv.encode(hv.noisy(6, 64, 64, 2), params="merange=0",
                                 options={"qp": str(qp)}))
    assert_equal_cv2(path)


def test_main10_planes_equal_md5(x265, tmp_path):
    path = str(tmp_path / "m10.mp4")
    hv.write_mp4(path, hv.encode(hv.scene(6, 96, 128), profile="main10", pix_fmt="yuv420p10le",
                                 params="ctu=32:aq-mode=2:weightb=1"), bit_depth=10)
    assert_md5(video.VideoReader(path))


def test_avi_fourccs_equal_cv2(x265, tmp_path):
    stream = hv.encode(hv.scene(6, 64, 96))
    for fourcc in (b"HEVC", b"H265", b"hev1", b"hvc1"):
        path = str(tmp_path / f"{fourcc.decode()}.avi")
        hv.write_avi(path, stream, fourcc)
        assert_equal_cv2(path)


def test_decoding_that_starts_at_a_cra_skips_its_rasl_pictures(x265, tmp_path):
    """An open GOP cut before its CRA picture, as a stream joined late: the
    RASL pictures after the CRA reference pictures that are gone, and are
    dropped as FFmpeg drops them."""
    stream = hv.encode(hv.scene(16, 64, 96), params="keyint=8:min-keyint=8:bframes=3")
    kinds = [hv.nal_type(next(n for n in hv.nal_units(p.data) if hv.nal_type(n) < 32))
             for p in stream.packets]
    cra = kinds.index(21)
    assert any(k in (8, 9) for k in kinds[cra:]), kinds     # RASL pictures follow
    late = hv.Stream(stream.packets[cra:], stream.extradata, stream.rate, stream.size)
    path = str(tmp_path / "late.avi")
    hv.write_avi(path, late)
    assert_equal_cv2(path)
    assert len(list(video.VideoReader(path))) < len(late.packets)


# --------------------------------------------------------------------------- #
# malformed input, in a subprocess
# --------------------------------------------------------------------------- #

FUZZ = r"""
import os, random, struct, sys
sys.path.insert(0, sys.argv[3])
import hevc_fixtures as hv
from yololite_tpu_torch.data import video

rng = random.Random(int(sys.argv[1]))
n = int(sys.argv[2])
sources = []
for name in ("a_default_320x240.mp4", "b_hev1_repeat_320x240.mp4", "c_ctu16_slices_328x244.mov",
             "d_qp4_noise.mp4", "f_main10_hlg_640x480.mov", "h_hevc_320x240.avi"):
    r = video.VideoReader(os.path.join(hv.DIR, name))
    sources.append((r.track.extradata, list(r.samples())[:6], name.endswith(".avi")))


def nal_spans(data, annexb):
    # (start, end) of each NAL unit's bytes
    out = []
    if annexb:
        i = data.find(b"\x00\x00\x01")
        while i >= 0:
            j = data.find(b"\x00\x00\x01", i + 3)
            out.append((i + 3, j if j >= 0 else len(data)))
            i = j
        return out
    i = 0
    while i + 4 <= len(data):
        size = struct.unpack(">I", data[i:i + 4])[0]
        out.append((i + 4, min(len(data), i + 4 + size)))
        i += 4 + size
    return out


def flip(data, start, end, bits):
    data = bytearray(data)
    for _ in range(bits):
        if end > start:
            k = rng.randrange(start, end)
            data[k] ^= 1 << rng.randrange(8)
    return bytes(data)


codes = {}
for case in range(n):
    extradata, packets, annexb = rng.choice(sources)
    packets = list(packets)
    kind = rng.choice(["ps", "slice_header", "entry_points", "cut", "bytes", "ps_between_slices"])
    if kind == "ps":
        if annexb:
            spans = [s for s in nal_spans(packets[0], True) if 32 <= (packets[0][s[0]] >> 1) & 63 <= 34]
            s, e = rng.choice(spans)
            packets[0] = flip(packets[0], s + 2, e, rng.randint(1, 4))
        else:
            extradata = flip(extradata, 23, len(extradata), rng.randint(1, 4))
    elif kind in ("slice_header", "entry_points"):
        k = rng.randrange(len(packets))
        spans = [s for s in nal_spans(packets[k], annexb) if (packets[k][s[0]] >> 1) & 63 < 32]
        if spans:
            s, e = rng.choice(spans)
            lo, hi = (s + 2, min(e, s + 8)) if kind == "slice_header" else (s + 4, min(e, s + 24))
            packets[k] = flip(packets[k], lo, hi, rng.randint(1, 6))
    elif kind == "ps_between_slices":
        # a parameter set of the stream, a bit or two changed, sent again
        # after the first slice of a picture
        held = [(k, s) for k in range(len(packets)) for s in nal_spans(packets[k], annexb)
                if 32 <= (packets[k][s[0]] >> 1) & 63 <= 34]
        k = rng.randrange(len(packets))
        slices = [s for s in nal_spans(packets[k], annexb) if (packets[k][s[0]] >> 1) & 63 < 32]
        if held and slices:
            j, (s, e) = rng.choice(held)
            ps = flip(packets[j][s:e], 2, e - s, rng.randint(0, 2))
            at = slices[0][1]
            packets[k] = (packets[k][:at] + (b"\x00\x00\x00\x01" if annexb else struct.pack(">I", len(ps)))
                          + ps + packets[k][at:])
    elif kind == "cut":
        k = rng.randrange(len(packets))
        packets[k] = packets[k][:rng.randrange(len(packets[k]) + 1)]
    else:
        k = rng.randrange(len(packets))
        p = bytearray(packets[k])
        for _ in range(rng.randint(1, 8)):
            if p:
                p[rng.randrange(len(p))] = rng.randrange(256)
        packets[k] = bytes(p)
    try:
        dec = video.HevcDecoder(extradata)
        for t, p in enumerate(packets):
            dec.decode(p, t)
        dec.flush()
        codes["decoded"] = codes.get("decoded", 0) + 1
    except (ValueError, video.UnsupportedVideo) as e:
        key = type(e).__name__
        codes[key] = codes.get(key, 0) + 1
print("cases", n, sorted(codes.items()))
"""


def test_parameter_sets_changed_between_slices_raise(x265):
    """An SPS or PPS re-sent with other bytes between two slices of one
    picture (x265's SPS with another log2_max_pic_order_cnt_lsb, its PPS
    with another cb_qp_offset): the next slice raises, where it would be
    parsed against the new set and decoded with the picture's old one. The
    same bytes sent again change nothing."""
    base = hv.encode(hv.scene(1, 192, 192), params="slices=3")
    nals = hv.nal_units(base.packets[0].data)
    first = next(i for i, n in enumerate(nals) if hv.nal_type(n) < 32)
    assert sum(hv.nal_type(n) < 32 for n in nals) == 3
    for other, kind in (("log2-max-poc-lsb=6", hv.SPS), ("cbqpoffs=2", hv.PPS)):
        alt = hv.encode(hv.scene(1, 192, 192), params="slices=3:" + other)
        new_ps, old_ps = (next(n for n in hv.nal_units(x.extradata) if hv.nal_type(n) == kind)
                          for x in (alt, base))
        assert new_ps != old_ps
        for ps, raises in ((new_ps, True), (old_ps, False)):
            au = b"".join(b"\x00\x00\x00\x01" + n for n in nals[:first + 1] + [ps] + nals[first + 1:])
            dec = video.HevcDecoder(base.extradata)
            if raises:
                with pytest.raises(ValueError, match="slices of one picture name different SPSs/PPSs"):
                    dec.decode(au, 0)
            else:
                assert len(dec.decode(au, 0) + dec.flush()) == 1


def test_malformed_streams_end_with_a_code_in_a_subprocess():
    """Mutated parameter sets, slice headers, entry points, cut and
    overwritten packets of the fixtures: every call returns a code, none
    crashes or hangs the process."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", FUZZ, "2022", "300",
                           os.path.dirname(os.path.abspath(__file__))],
                          capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("cases 300"), proc.stdout


# --------------------------------------------------------------------------- #
# the tracker
# --------------------------------------------------------------------------- #

def test_tracker_on_an_hevc_mp4_gives_the_tracks_of_its_png_sequence(x265, tmp_path, capsys):
    """`tracker --video clip.mp4` on HEVC (B-frames, WPP) and on the PNG
    sequence of cv2's frames of the same clip: the same tracks."""
    import chip_smoke
    import torch
    from tests.test_torch_port_models import edge_cfg, jax_edge
    from yololite_tpu_torch.tools import tracker as tracker_tool
    from yololite_tpu.train.checkpoint import build_meta, save_checkpoint
    img = 64
    _, params, bs = jax_edge(img)
    params = dict(params)
    for head in ("head3", "head4", "head5"):
        params[head] = dict(params[head])
        for part in ("obj", "cls"):
            params[head][part] = dict(params[head][part], kernel=params[head][part]["kernel"] * 100.0)
    cfg = edge_cfg(img)
    ckpt = save_checkpoint(str(tmp_path / "edge.ckpt"), params, bs,
                           build_meta(cfg, {}, "AP", ["c0", "c1", "c2"], (1, 1, 1)))
    frames = chip_smoke.make_clip(10, h=48, w=64, seed=3)
    clip = str(tmp_path / "clip.mp4")
    hv.write_mp4(clip, hv.encode(frames, params="bframes=3"))
    seq = tmp_path / "seq"
    seq.mkdir()
    for k, f in enumerate(_cv2_frames(clip)):
        chip_smoke.write_png(str(seq / ("%04d.png" % (k + 1))), f[..., ::-1])
    torch.manual_seed(0)
    runs = []
    for source in (clip, str(seq / "%04d.png")):
        runs.append(tracker_tool.main(["--weights", ckpt, "--video", source, "--device", "cpu",
                                       "--conf", "0.05", "--min_hits", "1"]))
    a, b = runs
    assert len(a) == len(b) == 10 and sum(map(len, a)) > 0
    for fa, fb in zip(a, b):
        assert [(t["track_id"], t["cls"]) for t in fa] == [(t["track_id"], t["cls"]) for t in fb]
        for ta, tb in zip(fa, fb):
            np.testing.assert_array_equal(ta["bbox"], tb["bbox"])
