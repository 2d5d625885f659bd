"""The port's video files (`yololite_tpu_torch/data/video.py`,
`csrc/videocodec.cpp`, the Motion-JPEG planes of `csrc/imgcodec.cpp`) against
`cv2.VideoCapture`/`cv2.VideoWriter` (OpenCV 5.0 with FFmpeg's avcodec
62.28.101 on this machine), and the tracker tool on a video file.

The fixtures are cv2's own clips (`tests/video_fixtures.py`): mp4v in MP4
at 30 and 29.97 fps and at 328x244, XVID in AVI, Motion-JPEG in AVI, MOV and
MP4, a truncated MP4 and a VP8 WebM; and random MPEG-4 Part 2 syntax
(`mpeg4_streams.py`) for the tools cv2's encoder never uses (AC prediction,
dquant, DC among the AC codes, video packets, MPEG quantization, 4MV, f_code
above 2). Tolerances: none. Packets, fps, frame counts, sizes and every
decoded frame (the last P-VOP of each GOP included) equal cv2's; the one
exception is the picture of the truncated clip's last,
cut-short sample, which FFmpeg conceals by its own error resilience: only
the frame count is held there. The writer is held to cv2's reading of its
files (rate, count, and the port's decoder equal to cv2's frame for frame)
and to its canvas: luma PSNR >= 40 dB at the writer's quantizer
(`WRITER_QUANT` = 2), and BGR PSNR no lower than cv2's own mp4v writer gets
on the same canvas (4:2:0 chroma bounds both: `make_clip`'s per-channel
noise has a 4:2:0 ceiling near 28 dB).
"""

import json
import os
import struct
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import cv2

import chip_smoke
from yololite_tpu_torch.data import codecs, video
from yololite_tpu_torch.data.imwrite import AviWriter
from yololite_tpu_torch.tools import tracker as tracker_tool

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import mpeg4_streams  # noqa: E402
from video_fixtures import DIR, manifest  # noqa: E402

FIXTURES = sorted(n for n in os.listdir(DIR) if not n.endswith((".json", ".webm"))
                  and os.path.isfile(os.path.join(DIR, n)))        # h264/ has its own tests
MIN_LUMA_PSNR = 40.0


@pytest.fixture(autouse=True)
def _restore_threads():
    """The tracker tests run on one thread; later tests in this worker get
    the count back (the fp32-vs-fp64 gradient test of
    tests/test_torch_port_train.py, for one, depends on it)."""
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _quiet_cv2():
    level = cv2.utils.logging.getLogLevel()
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)
    yield
    cv2.utils.logging.setLogLevel(level)


def cv2_frames(path, convert=True):
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, int(convert)])
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def cv2_packets(path):
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            return out
        out.append(p.tobytes())


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def luma(bgr):
    f = bgr.astype(np.int32)
    return ((66 * f[..., 2] + 129 * f[..., 1] + 25 * f[..., 0] + 128) >> 8) + 16


def vop_types(packets):
    """'I'/'P'/... of the first VOP of each MPEG-4 packet."""
    out = []
    for p in packets:
        i = p.find(b"\x00\x00\x01\xb6")
        out.append("IPBS"[p[i + 4] >> 6])
    return "".join(out)


# --------------------------------------------------------------------------- #
# fixtures and containers
# --------------------------------------------------------------------------- #

def test_fixture_manifest_is_cv2s():
    """The committed manifest is cv2's reading of the committed clips."""
    with open(os.path.join(DIR, "manifest.json")) as f:
        assert json.load(f) == manifest()
    total = sum(os.path.getsize(os.path.join(DIR, n)) for n in os.listdir(DIR)
                if os.path.isfile(os.path.join(DIR, n)))
    assert total < 420 * 1024


@pytest.mark.parametrize("name", FIXTURES)
def test_packets_and_properties_equal_cv2(name):
    path = os.path.join(DIR, name)
    cap = cv2.VideoCapture(path)
    r = video.VideoReader(path)
    assert r.fps == cap.get(cv2.CAP_PROP_FPS)
    assert r.frame_count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert r.size == (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                      int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    assert r.codec == ("mjpeg" if name.startswith("mjpg") else "mp4v")
    got = list(r.packets())
    assert got == cv2_packets(path)
    if name == "mp4v_truncated.mp4":
        assert len(got) < r.frame_count and r.stop_reason


@pytest.mark.parametrize("name", FIXTURES)
def test_frames_equal_cv2(name):
    path = os.path.join(DIR, name)
    want = cv2_frames(path)
    r = video.VideoReader(path)
    got = list(r)
    assert len(got) == len(want) > 0
    exact = len(got) - 1 if name == "mp4v_truncated.mp4" else len(got)
    for k in range(exact):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} frame {k}")
    if name == "mp4v_truncated.mp4":
        assert r.damaged == [len(got) - 1] and "cut short" in r.stop_reason
    elif r.codec == "mp4v":
        kinds = vop_types(r.packets())
        gops = -(-len(kinds) // 12)                  # cv2's encoder: an I-VOP every 12
        assert kinds.count("I") == gops and kinds.count("P") == len(kinds) - gops, kinds


def test_sniff():
    heads = {"mp4v_320x240_30.mp4": "mp4", "xvid_320x240.avi": "avi",
             "vp80_64x48.webm": "ebml", "manifest.json": ""}
    for name, kind in heads.items():
        with open(os.path.join(DIR, name), "rb") as f:
            assert video.sniff(f.read(video.SNIFF_BYTES)) == kind


def _stub(tmp_path, src, old, new, name):
    data = open(os.path.join(DIR, src), "rb").read()
    assert data.count(old) == 1
    path = tmp_path / name
    path.write_bytes(data.replace(old, new))
    return str(path)


@pytest.mark.parametrize("case,match", [
    ("webm", "WebM"), ("avc1", "H.264"), ("hev1", "HEVC"), ("vp09", "VP9"),
    ("moof", "fragmented MP4"), ("avi_hevc", "HEVC"), ("avix", "OpenDML"),
    ("avi_div3", "MS-MPEG4"),
])
def test_containers_that_raise(tmp_path, case, match):
    if case == "webm":
        path = os.path.join(DIR, "vp80_64x48.webm")
    elif case in ("avc1", "hev1", "vp09"):
        path = _stub(tmp_path, "mp4v_320x240_30.mp4", b"mp4v\x00\x00", case.encode() + b"\x00\x00",
                     f"{case}.mp4")
    elif case == "moof":
        path = tmp_path / "frag.mp4"
        path.write_bytes(open(os.path.join(DIR, "mp4v_320x240_30.mp4"), "rb").read()
                         + struct.pack(">I4s", 8, b"moof"))
        path = str(path)
    elif case == "avi_hevc":             # H.264 in AVI is read (test_torch_port_h264.py)
        path = _stub(tmp_path, "xvid_320x240.avi", b"strf(\x00\x00\x00(\x00\x00\x00@\x01\x00\x00"
                     b"\xf0\x00\x00\x00\x01\x00\x18\x00XVID",
                     b"strf(\x00\x00\x00(\x00\x00\x00@\x01\x00\x00\xf0\x00\x00\x00\x01\x00"
                     b"\x18\x00HEVC", "hevc.avi")
    elif case == "avi_div3":
        path = _stub(tmp_path, "xvid_320x240.avi", b"\x18\x00XVID", b"\x18\x00DIV3", "div3.avi")
    else:
        path = tmp_path / "avix.avi"
        path.write_bytes(open(os.path.join(DIR, "xvid_320x240.avi"), "rb").read()
                         + b"RIFF" + struct.pack("<I", 4) + b"AVIX")
        path = str(path)
    with pytest.raises(video.UnsupportedVideo, match=match):
        video.VideoReader(str(path))


def test_not_a_video(tmp_path):
    path = tmp_path / "x.mp4"
    path.write_bytes(b"not a video at all")
    with pytest.raises(ValueError):
        video.VideoReader(str(path))
    with pytest.raises(FileNotFoundError):
        video.VideoReader(str(tmp_path / "missing.mp4"))


# --------------------------------------------------------------------------- #
# MPEG-4 Part 2 streams that raise by name
# --------------------------------------------------------------------------- #

class Bits:
    def __init__(self):
        self.s = ""

    def put(self, v, n):
        self.s += format(v, f"0{n}b") if n else ""
        return self

    def bytes(self):
        s = self.s + "0" + "1" * ((7 - len(self.s) % 8) % 8)
        return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def vol(ver=1, interlaced=0, sprite=0, not8=0, quarter=0, partitioned=0, shape=0,
        complexity_disabled=1, scalable=0, w=64, h=48):
    b = Bits().put(0, 1).put(1, 8).put(1, 1).put(ver, 4).put(1, 3).put(1, 4)
    b.put(0, 1).put(shape, 2).put(1, 1).put(30, 16).put(1, 1).put(0, 1)
    b.put(1, 1).put(w, 13).put(1, 1).put(h, 13).put(1, 1)
    b.put(interlaced, 1).put(1, 1).put(sprite, 1 if ver == 1 else 2).put(not8, 1).put(0, 1)
    if ver != 1:
        b.put(quarter, 1)
    b.put(complexity_disabled, 1).put(1, 1).put(partitioned, 1)
    if partitioned:
        b.put(0, 1)
    if ver != 1:
        b.put(0, 1).put(0, 1)
    b.put(scalable, 1)
    return b"\x00\x00\x01\x20" + b.bytes()


@pytest.mark.parametrize("flags,match", [
    (dict(interlaced=1), "interlaced"), (dict(sprite=1), "GMC"),
    (dict(ver=2, quarter=1), "quarter-pel"), (dict(partitioned=1), "data partitioning"),
    (dict(not8=1), "N-bit"), (dict(shape=1), "non-rectangular"),
    (dict(complexity_disabled=0), "complexity estimation"), (dict(scalable=1), "scalability"),
])
def test_vol_tools_that_raise(flags, match):
    video.Mpeg4Decoder(vol())                        # the plain VOL opens
    with pytest.raises(video.UnsupportedVideo, match=match):
        video.Mpeg4Decoder(vol(**flags))


@pytest.mark.parametrize("kind,match", [(2, "B-VOPs"), (3, "S-VOPs")])
def test_vop_types_that_raise(kind, match):
    dec = video.Mpeg4Decoder(vol())
    vop = b"\x00\x00\x01\xb6" + Bits().put(kind, 2).put(0, 1).put(1, 1).put(0, 5).put(1, 1).bytes()
    with pytest.raises(video.UnsupportedVideo, match=match):
        dec.decode(vop)


def test_packed_bitstream_raises():
    path = os.path.join(DIR, "xvid_320x240.avi")
    pk = list(video.VideoReader(path).packets())
    dec = video.Mpeg4Decoder()
    with pytest.raises(video.UnsupportedVideo, match="packed"):
        dec.decode(pk[0] + pk[1])


# --------------------------------------------------------------------------- #
# random streams: the coding tools cv2's encoder does not use
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", range(16))
def test_random_streams_equal_cv2(tmp_path, seed):
    """Random MPEG-4 Part 2 syntax (`mpeg4_streams.py`: AC prediction,
    dquant, every intra_dc_vlc_thr, video packets with and without the
    header extension, MPEG quantization with default and loaded matrices,
    4MV, f_code 1-4, both rounding types, stuffing, the three escapes, large
    DC and AC levels), two GOPs of I and P-VOPs at sizes with partial MBs:
    every frame equal to cv2's."""
    rng = np.random.RandomState(seed)
    w, h = [(80, 48), (72, 40), (112, 64), (48, 32)][seed % 4]
    quant_type, resync = int(seed % 3 == 1), seed % 2 == 1
    mats = (None, None)
    if quant_type and seed % 4 == 1:
        mats = (list(rng.randint(8, 64, 64)), list(rng.randint(8, 64, rng.randint(1, 64))))
    extra = mpeg4_streams.vol(w, h, quant_type, mats, resync)
    gen = mpeg4_streams.StreamGen(rng, w, h, resync)
    path = str(tmp_path / "random.mp4")
    mux = video.Mp4Muxer(path, (w, h), Fraction(mpeg4_streams.DEFAULT_RES), extra)
    for kind in "IPPPPIPP":
        mux.write(gen.vop(kind == "P"))
    mux.close()
    want = cv2_frames(path)
    r = video.VideoReader(path)
    got = list(r)
    assert len(got) == len(want) == 8 and not r.damaged
    for k, (g, wb) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, wb, err_msg=f"frame {k}")


# --------------------------------------------------------------------------- #
# the conversion and the IDCT, probed apart
# --------------------------------------------------------------------------- #

def _flat_planes(rng, mbw, mbh):
    """Y, U, V of flat 8x8 luma and 8x8 chroma blocks (one value each)."""
    edges = np.array([0, 1, 15, 16, 17, 128, 234, 235, 236, 254, 255])
    yv = rng.randint(0, 256, (2 * mbh, 2 * mbw))
    uv = rng.randint(0, 256, (2, mbh, mbw))
    yv[:2, :len(edges)] = edges
    uv[:, 0, :len(edges)] = edges
    uv[1, 0, :len(edges)] = edges[::-1]
    up = lambda a, k: np.repeat(np.repeat(a, k, 0), k, 1).astype(np.uint8)
    return up(yv, 8), up(uv[0], 8), up(uv[1], 8)


def test_flat_block_conversion_probe(tmp_path):
    """Flat blocks of known Y/Cb/Cr, coded DC-only (quantizer 1: DC scale 8,
    so each sample decodes to its value under any IDCT): cv2's BGR equals the
    port's conversion of those planes, and the port's decoder gives the
    planes back."""
    rng = np.random.RandomState(0)
    mbw, mbh = 40, 30
    lib = video.library()
    muxed = tmp_path / "flat.mp4"
    enc = video.Mpeg4Encoder((mbw * 16, mbh * 16), 25)
    mux = video.Mp4Muxer(str(muxed), (mbw * 16, mbh * 16), enc.rate, enc.headers)
    truth = []
    for t in range(3):
        y, u, v = _flat_planes(rng, mbw, mbh)
        truth.append((y, u, v))
        planes = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
        out = np.empty(planes.size * 4, np.uint8)
        n = lib.yl_m4v_encode(planes.ctypes.data, 1, mbw * 16, mbh * 16, 1, 0, t, enc.inc_bits,
                              out.ctypes.data, out.size)
        mux.write(out[:n].tobytes())
    mux.close()
    want = cv2_frames(str(muxed))
    dec = video.Mpeg4Decoder(enc.headers)
    assert len(want) == 3
    for (y, u, v), pkt, w in zip(truth, video.VideoReader(str(muxed)).packets(), want):
        planes = dec.decode(pkt, planes=True)
        np.testing.assert_array_equal(planes, np.concatenate([y.ravel(), u.ravel(), v.ravel()]))
        got = np.empty(w.shape, np.uint8)
        lib.yl_yuv_to_bgr(planes.ctypes.data, y.shape[1], y.shape[0], u.shape[0], 0, 2,
                          got.ctypes.data)
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("quality,subsample", [(100, 2), (60, 2), (90, 1), (3, 2)])
def test_mjpeg_planes_and_full_range_conversion(tmp_path, quality, subsample):
    """Motion-JPEG in an AVI of PIL's JPEGs (4:2:0 and 4:2:2): the Y plane
    equals FFmpeg's (cv2 with CONVERT_RGB off), the BGR frame cv2's."""
    from PIL import Image
    import io
    frames = chip_smoke.make_clip(3, h=64, w=96, seed=5)

    def encode(f):
        buf = io.BytesIO()
        Image.fromarray(f[..., ::-1]).save(buf, "JPEG", quality=quality, subsampling=subsample)
        return buf.getvalue()

    path = str(tmp_path / "pil.avi")
    w = AviWriter(path, 10, (96, 64), encode=encode)
    for f in frames:
        w.write(f)
    w.close()
    want, want_y = cv2_frames(path), cv2_frames(path, convert=False)
    got = list(video.VideoReader(path))
    assert len(got) == len(want) == 3
    for g, wb, wy, pkt in zip(got, want, want_y, video.VideoReader(path).packets()):
        np.testing.assert_array_equal(codecs.jpeg_planes(pkt)[0], wy[:64])
        np.testing.assert_array_equal(g, wb)


def test_mjpeg_layouts_that_raise():
    from PIL import Image
    import io
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "JPEG", subsampling=0)
    with pytest.raises(codecs.UnsupportedImage, match="Motion-JPEG"):
        codecs.jpeg_planes(buf.getvalue())


# --------------------------------------------------------------------------- #
# the writer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("ext,fps", [(".mp4", 29.97), (".avi", 29.97), (".mov", 25.0),
                                     (".m4v", 30.0)])
def test_writer_read_by_cv2(tmp_path, ext, fps):
    frames = chip_smoke.make_clip(14, h=120, w=160, seed=1)
    path = str(tmp_path / f"out{ext}")
    with video.VideoWriter(path, fps, (160, 120)) as w:
        for f in frames:
            w.write(f)
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FPS) == fps
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(frames)
    want, want_y = cv2_frames(path), cv2_frames(path, convert=False)
    assert len(want) == len(frames)
    ref = str(tmp_path / f"cv2{ext}")
    vw = cv2.VideoWriter(ref, cv2.VideoWriter_fourcc(*"mp4v"), fps, (160, 120))
    for f in frames:
        vw.write(f)
    vw.release()
    for k, (f, wb, wy, cv) in enumerate(zip(frames, want, want_y, cv2_frames(ref))):
        assert psnr(wy[:120], luma(f)) >= MIN_LUMA_PSNR, k
        assert psnr(wb, f) >= psnr(cv, f), k
    r = video.VideoReader(path)
    assert r.fps == fps and r.frame_count == len(frames) and r.size == (160, 120)
    for g, wb in zip(r, want):
        np.testing.assert_array_equal(g, wb)


def test_writer_rejects(tmp_path):
    with pytest.raises(ValueError, match="writes"):
        video.VideoWriter(str(tmp_path / "x.mkv"), 30, (64, 48))
    with video.VideoWriter(str(tmp_path / "x.mp4"), 30, (64, 48)) as w:
        with pytest.raises(ValueError, match="differs"):
            w.write(np.zeros((48, 60, 3), np.uint8))


@pytest.mark.parametrize("w,h", [(328, 244), (34, 18), (21, 13)])
def test_odd_sizes_round_trip(tmp_path, w, h):
    """Sizes that are not multiples of 16 (edge MBs), and odd ones, which
    are coded at the even size below as cv2.VideoWriter codes them."""
    frames = chip_smoke.make_clip(3, h=h, w=w, seed=2)
    for ext in (".mp4", ".avi"):
        path = str(tmp_path / f"o{w}x{h}{ext}")
        with video.VideoWriter(path, 30, (w, h)) as vw:
            for f in frames:
                vw.write(f)
        ref = str(tmp_path / f"cv2_{w}x{h}{ext}")
        cw = cv2.VideoWriter(ref, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        cw.write(frames[0])
        cw.release()
        want = cv2_frames(path)
        assert want[0].shape == cv2_frames(ref)[0].shape == (h & ~1, w & ~1, 3)
        got = list(video.VideoReader(path))
        assert len(got) == len(want) == 3
        for g, wb in zip(got, want):
            np.testing.assert_array_equal(g, wb)


# --------------------------------------------------------------------------- #
# the tracker on a video file
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.test_torch_port_models import edge_cfg, jax_edge
    from yololite_tpu.train.checkpoint import build_meta, save_checkpoint
    _, params, bs = jax_edge(64)
    params = dict(params)
    for head in ("head3", "head4", "head5"):       # scores spread over 0.01-0.16
        params[head] = dict(params[head])
        for part in ("obj", "cls"):
            params[head][part] = dict(params[head][part],
                                      kernel=params[head][part]["kernel"] * 100.0)
    meta = build_meta(edge_cfg(64), {}, "AP", ["c0", "c1", "c2"], (1, 1, 1))
    return save_checkpoint(str(tmp_path_factory.mktemp("video") / "edge_n.ckpt"),
                           params, bs, meta)


def test_tracker_on_mp4_equals_png_sequence(ckpt, tmp_path, capsys):
    torch.set_num_threads(1)
    frames = chip_smoke.make_clip(10, h=48, w=64, seed=3)
    clip = str(tmp_path / "clip.mp4")
    vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for f in frames:
        vw.write(f)
    vw.release()
    decoded = list(video.VideoReader(clip))
    os.makedirs(tmp_path / "seq")
    for k, f in enumerate(decoded):
        cv2.imwrite(str(tmp_path / "seq" / ("%04d.png" % k)), f)
    argv = ["--weights", ckpt, "--device", "cpu", "--conf", "0.05", "--min_hits", "1"]
    out = str(tmp_path / "out.mp4")
    a = tracker_tool.main(argv + ["--video", clip, "--out", out])
    assert capsys.readouterr().out.splitlines()[-1].startswith(f"Processed 10 frames @ ")
    b = tracker_tool.main(argv + ["--video", str(tmp_path / "seq" / "%04d.png")])
    assert len(a) == len(b) == 10 and sum(map(len, a)) > 0
    assert [[(t["track_id"], t["cls"], t["bbox"].tolist(), t["score"]) for t in fr]
            for fr in a] == [[(t["track_id"], t["cls"], t["bbox"].tolist(), t["score"])
                              for t in fr] for fr in b]
    cap = cv2.VideoCapture(out)                     # the source's rate, every frame
    assert cap.get(cv2.CAP_PROP_FPS) == 30.0 and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 10


def test_tracker_on_h264_mp4_equals_png_sequence(ckpt, tmp_path, capsys):
    """The tracker on an H.264 .mp4 (High, CABAC, B-frames; libx264 through
    the system's libavcodec) and on a PNG sequence of cv2's frames of it:
    the same tracks, frame for frame."""
    import h264_fixtures
    if not h264_fixtures.available():
        pytest.skip("no system libavcodec 59 with libx264")
    torch.set_num_threads(1)
    frames = chip_smoke.make_clip(10, h=48, w=64, seed=3)
    clip = str(tmp_path / "clip.mp4")
    h264_fixtures.write_mp4(clip, h264_fixtures.encode(frames, profile="high",
                                                       params="bframes=3:b-pyramid=normal"))
    os.makedirs(tmp_path / "seq")
    for k, f in enumerate(cv2_frames(clip)):
        cv2.imwrite(str(tmp_path / "seq" / ("%04d.png" % k)), f)
    argv = ["--weights", ckpt, "--device", "cpu", "--conf", "0.05", "--min_hits", "1"]
    a = tracker_tool.main(argv + ["--video", clip, "--out", str(tmp_path / "out.mp4")])
    assert capsys.readouterr().out.splitlines()[-1].startswith("Processed 10 frames @ ")
    b = tracker_tool.main(argv + ["--video", str(tmp_path / "seq" / "%04d.png")])
    assert len(a) == len(b) == 10 and sum(map(len, a)) > 0
    assert [[(t["track_id"], t["cls"], t["bbox"].tolist(), t["score"]) for t in fr]
            for fr in a] == [[(t["track_id"], t["cls"], t["bbox"].tolist(), t["score"])
                              for t in fr] for fr in b]
    cap = cv2.VideoCapture(str(tmp_path / "out.mp4"))      # the source's 25 fps
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0 and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 10


def test_tracker_stops_where_cv2_stops(ckpt, capsys):
    path = os.path.join(DIR, "mp4v_truncated.mp4")
    got = tracker_tool.main(["--weights", ckpt, "--device", "cpu", "--video", path])
    lines = capsys.readouterr().out.splitlines()
    assert len(got) == len(cv2_frames(path))
    assert any(line.startswith("[stop] sample 14 of 24 is cut short") for line in lines)


def test_tracker_sources_that_raise(ckpt, tmp_path):
    with pytest.raises(SystemExit, match="Cannot open video source"):
        tracker_tool.main(["--weights", ckpt, "--device", "cpu", "--video",
                           str(tmp_path / "missing.mp4")])
    with pytest.raises(NotImplementedError, match="camera 0"):
        tracker_tool.main(["--weights", ckpt, "--device", "cpu", "--video", "0"])
    with pytest.raises(video.UnsupportedVideo, match="VP8"):
        tracker_tool.main(["--weights", ckpt, "--device", "cpu", "--video",
                           os.path.join(DIR, "vp80_64x48.webm")])
    with pytest.raises(NotImplementedError, match="other containers"):
        tracker_tool.main(["--weights", ckpt, "--device", "cpu", "--video",
                           os.path.join(DIR, "mp4v_320x240_30.mp4"), "--out", "o.mkv"])
