"""The port's H.264 decoding (`yololite_tpu_torch/csrc/h264dec.cpp` through
`data/video.py`) against `cv2.VideoCapture` (OpenCV 5.0 with FFmpeg's avcodec
62.28.101), on streams that the system's libx264 writes (`tests/h264_fixtures.py`,
through the system's FFmpeg 5.1 libavcodec).

  - the committed fixtures (`tests/data/video/h264/`): their manifest is
    cv2's reading of them, and the port's packets (`CAP_PROP_FORMAT = -1`),
    fps, frame count, size and every BGR frame equal it;
  - a matrix of small streams written at test time over x264's profiles and
    tools, each equal to cv2 frame for frame, packet for packet;
  - syntax x264 never writes, made by rewriting its streams
    (`tests/h264_streams.py`), each equal to cv2;
  - the kinds the port refuses raise `UnsupportedVideo` naming the tool;
  - malformed parameter sets are rejected with `ValueError`.

The tests of the committed fixtures need cv2 only; those that encode at test
time take the `x264` fixture and skip without the system's libavcodec 59.
Tolerances: none.
"""

import json
import os
import sys

import numpy as np
import pytest

import cv2

from yololite_tpu_torch.data import video

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import h264_fixtures as hf  # noqa: E402
import h264_streams as hs  # noqa: E402

MANIFEST = os.path.join(hf.DIR, "manifest.json")
FIXTURE_BYTES = 1_500_000


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    level = cv2.utils.logging.getLogLevel()
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)
    yield
    cv2.utils.logging.setLogLevel(level)


@pytest.fixture
def x264():
    """The system's libx264, for the tests that encode at test time."""
    if not hf.available():
        pytest.skip("no system libavcodec 59 with libx264")


def committed():
    with open(MANIFEST) as f:
        return json.load(f)


def port_read(path):
    r = video.VideoReader(path)
    frames = list(r)
    return r, frames, list(r.packets())


def assert_equal_cv2(path):
    fps, count, size, packets, frames = hf.cv2_read(path)
    r, got, pk = port_read(path)
    assert (r.fps, r.frame_count, tuple(r.size)) == (fps, count, tuple(size))
    assert len(pk) == len(packets) and all(a == b for a, b in zip(pk, packets))
    assert len(got) == len(frames) > 0
    for k, (a, b) in enumerate(zip(got, frames)):
        assert np.array_equal(a, b), f"frame {k} of {path}"


def test_manifest_is_cv2s_and_small():
    assert hf.manifest() == committed()
    total = sum(os.path.getsize(os.path.join(hf.DIR, n)) for n in os.listdir(hf.DIR))
    assert total < FIXTURE_BYTES


@pytest.mark.parametrize("name", sorted(n for n, m in committed().items() if "refused" not in m))
def test_fixture_equals_manifest(name):
    m = committed()[name]
    r, frames, packets = port_read(os.path.join(hf.DIR, name))
    assert (r.fps, r.frame_count, list(r.size)) == (m["fps"], m["frame_count"], m["size"])
    assert [hf.sha(p) for p in packets] == m["packets"]
    assert [hf.sha(np.ascontiguousarray(f)) for f in frames] == m["frames"]
    assert r.codec == "h264"


def test_truncated_fixture_stops_as_cv2():
    r, frames, _ = port_read(os.path.join(hf.DIR, "k_truncated_320x240.mp4"))
    assert len(frames) == len(committed()["k_truncated_320x240.mp4"]["frames"])
    assert r.stop_reason.startswith("sample 13 of 24 is cut short")


def test_trimmed_fixture_hides_the_cut_frames():
    r, frames, packets = port_read(os.path.join(hf.DIR, "j_trimmed_320x240.mp4"))
    assert len(packets) == r.frame_count == 24 and len(frames) == 24 - hf.TRIM
    assert sum(r.track.shown) == 24 - hf.TRIM


@pytest.mark.parametrize("name", sorted(hf.REFUSED))
def test_refused_kinds_raise_naming_the_tool(name):
    with pytest.raises(video.UnsupportedVideo, match=hf.REFUSED[name]):
        video.VideoReader(os.path.join(hf.DIR, name))
    assert committed()[name] == {"refused": hf.REFUSED[name]}


# (name, (h, w), frames, encode keyword arguments) of the test-time matrix
MATRIX = [
    ("baseline", (48, 64), 10, dict(profile="baseline")),
    ("baseline_slices", (96, 128), 8, dict(profile="baseline", params="slices=3")),
    ("baseline_qp2", (48, 64), 6, dict(profile="baseline", options={"qp": "2"})),
    ("baseline_ref4", (96, 128), 10, dict(profile="baseline", params="ref=4")),
    ("main_cavlc_b", (96, 128), 10, dict(profile="main", params="cabac=0:bframes=3")),
    ("main_cabac_p", (96, 128), 10, dict(profile="main", params="bframes=0")),
    ("main_b1", (48, 64), 10, dict(profile="main", params="bframes=1")),
    ("main_bpyr_normal", (144, 176), 10, dict(profile="main", params="bframes=3:b-pyramid=normal")),
    ("main_bpyr_strict", (144, 176), 10, dict(profile="main", params="bframes=3:b-pyramid=strict")),
    ("main_bframes16", (48, 64), 12, dict(profile="main", params="bframes=16:b-adapt=0")),
    ("direct_temporal", (144, 176), 10, dict(profile="main", params="bframes=3:direct=temporal")),
    ("direct_spatial", (144, 176), 10, dict(profile="main", params="bframes=3:direct=spatial")),
    ("direct_temporal_pyr", (96, 128), 10,
     dict(profile="main", params="bframes=3:direct=temporal:b-pyramid=normal:ref=3")),
    ("direct_auto", (96, 128), 10, dict(profile="main", params="bframes=3:direct=auto")),
    ("weightp1", (96, 128), 10, dict(profile="main", params="weightp=1")),
    ("weightp2_ref4", (144, 176), 10, dict(profile="main", params="weightp=2:ref=4")),
    ("weightb_temporal", (96, 128), 10,
     dict(profile="main", params="bframes=3:weightb=1:direct=temporal")),
    ("weightb_pyr", (144, 176), 10,
     dict(profile="main", params="bframes=3:weightb=1:b-pyramid=normal")),
    ("weightb_cavlc", (96, 128), 10, dict(profile="main", params="bframes=2:weightb=1:cabac=0")),
    ("ref1", (96, 128), 10, dict(profile="high", params="ref=1")),
    ("ref16_pyr", (96, 128), 12, dict(profile="high", params="ref=16:bframes=3:b-pyramid=normal")),
    ("mixed_refs0", (96, 128), 10, dict(profile="high", params="mixed-refs=0:ref=3")),
    ("high_8x8", (144, 176), 10, dict(profile="high", params="8x8dct=1")),
    ("high_no8x8", (96, 128), 10, dict(profile="high", params="8x8dct=0")),
    ("high_i8x8_only", (96, 128), 4, dict(profile="high", params="keyint=1:analyse=i8x8")),
    ("high_i4x4_only", (96, 128), 4, dict(profile="high", params="keyint=1:analyse=i4x4:8x8dct=0")),
    ("high_partitions_all", (144, 176), 10, dict(profile="high", params="partitions=all")),
    ("cqm_jvt", (96, 128), 10, dict(profile="high", params="cqm=jvt")),
    ("cqm_jvt_cavlc", (96, 128), 10, dict(profile="high", params="cqm=jvt:cabac=0:bframes=2")),
    ("cqm_flat_8x8", (96, 128), 10, dict(profile="high", params="cqm=flat:8x8dct=1")),
    ("slices4", (144, 176), 10, dict(profile="high", params="slices=4")),
    ("slices_max_mbs", (96, 128), 10, dict(profile="high", params="slice-max-mbs=7")),
    ("slices_cavlc_b", (96, 128), 10, dict(profile="high", params="slices=3:cabac=0:bframes=2")),
    ("deblock_-6_6", (96, 128), 10, dict(profile="high", params="deblock=-6,6")),
    ("deblock_6_-6", (96, 128), 10, dict(profile="high", params="deblock=6,-6")),
    ("deblock_off", (96, 128), 10, dict(profile="high", params="no-deblock=1")),
    ("deblock_slices", (96, 128), 10, dict(profile="high", params="slices=4:deblock=2,2")),
    ("constrained_intra", (144, 176), 10, dict(profile="high", params="constrained-intra=1")),
    ("constrained_intra_cavlc", (96, 128), 10,
     dict(profile="main", params="constrained-intra=1:cabac=0:bframes=2")),
    ("open_gop", (96, 128), 16, dict(profile="high", params="open-gop=1:keyint=6:bframes=3")),
    ("keyint1", (48, 64), 6, dict(profile="high", params="keyint=1")),
    ("intra_refresh", (96, 128), 10, dict(profile="main", params="intra-refresh=1:keyint=5")),
    ("qp0_chroma_offset", (96, 128), 8, dict(profile="high", params="chroma-qp-offset=12",
                                             options={"qp": "20"})),
    ("qp51", (96, 128), 8, dict(profile="high", options={"qp": "51"})),
    ("qp4_cabac", (96, 128), 6, dict(profile="high", options={"qp": "4"})),
    ("qp4_cavlc", (96, 128), 6, dict(profile="high", params="cabac=0", options={"qp": "4"})),
    ("crf_high_motion", (144, 176), 10, dict(profile="high", params="me=umh:subme=9:merange=32")),
    ("trellis_psy", (96, 128), 10, dict(profile="high", params="trellis=2:psy-rd=1.0,0.5")),
    ("cabac_init", (96, 128), 10, dict(profile="main", params="bframes=2", options={"qp": "30"})),
    ("fullrange_fcc", (48, 64), 6, dict(profile="high", params="fullrange=on:colormatrix=fcc")),
    ("smpte240m", (48, 64), 6, dict(profile="high", params="colormatrix=smpte240m")),
    ("bt2020nc", (48, 64), 6, dict(profile="high", params="colormatrix=bt2020nc")),
    ("odd_crop", (50, 66), 8, dict(profile="high", params="bframes=2")),
    ("fps_30000_1001", (48, 64), 8, dict(profile="high", fps=hf.Fraction(30000, 1001))),
]


@pytest.mark.parametrize("name,size,n,kw", MATRIX, ids=[m[0] for m in MATRIX])
def test_x264_matrix_equals_cv2(x264, tmp_path, name, size, n, kw):
    frames = hf.scene(n, *size) if name != "qp4_cavlc" else hf.noisy(n, *size)
    stream = hf.encode(frames, **kw)
    path = str(tmp_path / f"{name}.mp4")
    hf.write_mp4(path, stream)
    assert_equal_cv2(path)


def test_avi_variants_equal_cv2(x264, tmp_path):
    stream = hf.encode(hf.scene(8, 48, 64), profile="high", params="bframes=2")
    for fourcc in (b"H264", b"X264", b"avc1"):
        path = str(tmp_path / f"{fourcc.decode()}.avi")
        hf.write_avi(path, stream, fourcc)
        assert_equal_cv2(path)


def test_libavformat_mov_equals_cv2(x264, tmp_path):
    stream = hf.encode(hf.scene(12, 96, 128), profile="high", params="bframes=3:weightb=1")
    for ext in ("mov", "mp4"):
        path = str(tmp_path / f"lav.{ext}")
        hf.mov_mux(path, stream)
        assert_equal_cv2(path)


@pytest.mark.parametrize("trim", [1, 4, 12])
def test_edit_lists_equal_cv2(x264, tmp_path, trim):
    stream = hf.encode(hf.scene(24, 48, 64), profile="high",
                       params="keyint=8:bframes=3:b-pyramid=normal")
    path = str(tmp_path / f"trim{trim}.mp4")
    hf.write_mp4(path, stream, trim=trim)
    assert_equal_cv2(path)


@pytest.mark.parametrize("case", sorted(hs.REWRITES))
def test_rewritten_syntax_equals_cv2(x264, tmp_path, case):
    """Syntax x264 never writes (POC type 1, long-term references, MMCO,
    gaps in frame_num, I_PCM, MVC/SVC NAL units, ...), made by rewriting
    its streams."""
    path = str(tmp_path / f"{case}.mp4")
    stream = hs.write(case, path)
    assert_equal_cv2(path)
    assert len(hf.cv2_read(path)[4]) == len(stream.packets)      # legal: every picture shown


def test_b_slices_whose_colocated_is_a_non_existing_frame(x264, tmp_path):
    """A deliberate difference: the B pictures whose list-1 picture, the
    colocated one of temporal direct, is a frame made for a frame_num gap.
    The port gives that frame no motion (its macroblocks count as intra);
    FFmpeg reads the motion buffers its picture pool hands the frame, left
    from earlier pictures (8.2.5.2 leaves the frame's content unspecified).
    Every other picture equals cv2; those B pictures differ in the few
    macroblocks that take direct prediction from it."""
    path = str(tmp_path / "gaps_colocated.mp4")
    stream = hs.gaps_b_frames(colocated_non_existing=True)
    hf.write_mp4(path, stream)
    parsed = hs.Parsed(stream)
    pocs = hs.poc_type0(parsed)
    kinds = [h["type"] for p, h in parsed.slices() if h["first_mb"] == 0]
    b_shown = {k for k, (_, t) in enumerate(sorted(zip(pocs, kinds))) if t == 1}
    assert len(b_shown) == 5 and len(kinds) == len(stream.packets) == 12
    frames = hf.cv2_read(path)[4]
    got = port_read(path)[1]
    assert len(got) == len(frames) == 12
    for k, (a, b) in enumerate(zip(got, frames)):
        if k in b_shown:
            assert np.abs(a.astype(np.int16) - b).mean() < 0.5, k
        else:
            assert np.array_equal(a, b), k


def test_decoder_refuses_syntax_it_does_not_decode(x264):
    for case, match in hs.REFUSED_SYNTAX.items():
        stream = hs.refused_stream(case)
        with pytest.raises(video.UnsupportedVideo, match=match):
            dec = video.H264Decoder(stream.extradata)
            for p in stream.packets:
                dec.decode(p.data)


@pytest.mark.parametrize("case", sorted(hs.MALFORMED_SYNTAX))
def test_decoder_rejects_malformed_parameter_sets(x264, case):
    """An SPS that changes the picture's size between two of its slices,
    cropping offsets that wrap or pass the coded size: each raises, where
    the picture's buffers would otherwise be read or written past their
    end."""
    stream = hs.malformed_stream(case)
    with pytest.raises(ValueError, match=hs.MALFORMED_SYNTAX[case]):
        dec = video.H264Decoder(stream.extradata)
        for p in stream.packets:
            dec.decode(p.data)
        dec.flush()


def test_damaged_slice_ends_the_stream_with_the_pictures_before_it(x264, tmp_path):
    """A slice cut short inside its data: cv2 conceals it and goes on, the
    port stops with the pictures before it (ROADMAP, "deliberately
    differs")."""
    stream = hf.encode(hf.scene(10, 48, 64), profile="high", params="bframes=0")
    cut = hf.Packet(stream.packets[4].data[:16], 4, 4, False)
    path = str(tmp_path / "bad.mp4")
    hf.write_mp4(path, hf.Stream(stream.packets[:4] + [cut] + stream.packets[5:],
                                 stream.extradata, stream.rate, stream.size))
    r = video.VideoReader(path)
    frames = list(r)
    assert r.stop_reason.startswith("packet 4 does not decode")
    want = hf.cv2_read(path)[4]
    assert len(frames) == 4 and len(want) == 10
    for a, b in zip(frames, want):
        assert np.array_equal(a, b)
