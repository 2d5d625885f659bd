"""The port's containers around its decoders (`yololite_tpu_torch/data/mkv.py`,
`data/mpegts.py`, `data/esparse.py` and `data/video.py`'s fragmented MP4,
OpenDML AVI and raw Annex B) against `cv2.VideoCapture` (OpenCV 5.0 with
FFmpeg's libavformat 62.12.101 on this machine), and the `.mkv` writer
against `cv2.VideoWriter`.

  - the committed fixtures (`tests/data/video/containers/`,
    `tests/container_fixtures.py`): one x264 and one x265 stream muxed by
    the system's libavformat 59 as Matroska, MPEG-TS, M2TS and fragmented
    MP4 and written as raw Annex B, cv2's own mp4v `.mkv` and `.ts`,
    Matroska rewritten with lacing, header stripping, unknown sizes and cut
    short, a TS whose PES split and join access units, and an OpenDML AVI
    of small RIFFs. Their manifest is cv2's reading of them; the port's
    fps, frame count, size, packets (`CAP_PROP_FORMAT = -1`) and frames
    equal it, but where cv2's frame count has no meaning (a raw stream, a
    Matroska file without `Duration`: the port counts its packets, pinned
    here and listed in ROADMAP's deliberate differences);
  - layouts written at test time (fixed lacing, zlib content compression,
    `V_MS/VFW/FOURCC`, `V_MJPEG`, `V_MPEG4/ISO/SP`, 204-byte TS packets, a
    TS that loses its sync, OpenDML without a super index), each equal to
    cv2;
  - the codecs and containers the port refuses raise `UnsupportedVideo`
    naming them;
  - the `.mkv` writer read back by cv2 at the fps and frame count of cv2's
    own `.mkv`, its frames equal to the port's;
  - the tracker on a `.mkv` and on the `.mp4` of the same stream: equal
    tracks; its `--out x.mkv` read by cv2;
  - mutated Matroska and TS files read in a subprocess that must exit
    normally.

Tolerances: none.
"""

import json
import os
import shutil
import struct
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import cv2

from yololite_tpu_torch.data import esparse, mpegts, video

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import container_fixtures as cf  # noqa: E402
import h264_fixtures as hf  # noqa: E402
from video_fixtures import DIR as VIDEO_DIR, cv2_read, scene, sha  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(cf.DIR, "manifest.json")
NAMES = sorted(n for n in os.listdir(cf.DIR) if n != "manifest.json")
MAX_BYTES = 300 * 1024
KINDS = {".mkv": "ebml", ".ts": "ts", ".m2ts": "ts", ".mp4": "mp4", ".avi": "avi",
         ".h264": "h264", ".hevc": "hevc"}


@pytest.fixture(autouse=True, scope="module")
def _quiet():
    level = cv2.utils.logging.getLogLevel()
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_ERROR)
    yield
    cv2.utils.logging.setLogLevel(level)


@pytest.fixture(autouse=True)
def _restore_threads():
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def committed():
    with open(MANIFEST) as f:
        return json.load(f)


def assert_equal_cv2(path, frame_count=None):
    """The port's reading of a file equals cv2's (the frame count
    `frame_count` where given)."""
    fps, count, size, packets, frames = cv2_read(path)
    r = video.VideoReader(path)
    got = list(r)
    assert (r.fps, r.size) == (fps, tuple(size))
    assert r.frame_count == (count if frame_count is None else frame_count)
    assert list(r.packets()) == packets
    assert len(got) == len(frames) > 0
    for k, (a, b) in enumerate(zip(got, frames)):
        assert np.array_equal(a, b), f"frame {k} of {path}"


# --------------------------------------------------------------------------- #
# the committed fixtures
# --------------------------------------------------------------------------- #

def test_manifest_is_cv2s_and_small():
    assert committed() == cf.manifest()
    total = sum(os.path.getsize(os.path.join(cf.DIR, n)) for n in os.listdir(cf.DIR))
    assert total < MAX_BYTES


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_manifest(name):
    want = committed()[name]
    r = video.VideoReader(os.path.join(cf.DIR, name))
    packets, frames = list(r.packets()), list(r)
    assert (r.fps, list(r.size)) == (want["fps"], want["size"])
    assert r.frame_count == want.get("port_frame_count", want["frame_count"])
    assert [sha(p) for p in packets] == want["packets"]
    assert [sha(np.ascontiguousarray(f)) for f in frames] == want["frames"]
    with open(os.path.join(cf.DIR, name), "rb") as f:
        assert video.sniff(f.read(video.SNIFF_BYTES), name) == KINDS[os.path.splitext(name)[1]]


def test_frame_counts_cv2_cannot_report():
    """A raw Annex B stream (the raw demuxer's duration is unknown: cv2
    reports NOPTS over its 1200000 Hz time base x 25) and a Matroska file
    without `Duration`: cv2's count is a large negative number; the port
    reports the packets it reads."""
    man = committed()
    for name in cf.NO_DURATION:
        assert man[name]["frame_count"] < -10 ** 12
        assert video.VideoReader(os.path.join(cf.DIR, name)).frame_count == len(man[name]["packets"])


def test_raw_streams_are_found_by_content(tmp_path):
    """cv2 opens an Annex B stream by FFmpeg's probe of its bytes, whatever
    its name; the port does too."""
    for name in ("a_h264.h264", "b_hevc.hevc"):
        path = str(tmp_path / (name + ".bin"))
        shutil.copy(os.path.join(cf.DIR, name), path)
        assert_equal_cv2(path, frame_count=16)


def test_cut_short_matroska_reads_as_far_as_cv2():
    man = committed()["d_cut_short.mkv"]
    assert len(man["frames"]) < man["frame_count"] == 16       # Duration says 16
    r = video.VideoReader(os.path.join(cf.DIR, "d_cut_short.mkv"))
    assert len(list(r)) == len(man["frames"])


def test_split_and_joined_pes_give_the_parsers_packets():
    """Access unit 5 spans two PES, 8 and 9 share one: cv2's packets are
    FFmpeg's parser's cut of the elementary stream, not the PES."""
    man = committed()
    for key in ("packets", "frames"):       # its elementary stream is the raw file's bytes
        assert man["e_split_pes.ts"][key] == man["a_h264.h264"][key]
    path = os.path.join(cf.DIR, "e_split_pes.ts")
    with open(path, "rb") as f:
        d = mpegts.demux(f, os.path.getsize(path), (188, 0))
        starts = set(d.source(f).pes_es)
    spans = [k for k, s in enumerate(d.samples) if any(s.offset < e < s.offset + s.size
                                                       for e in starts)]
    begun = [k for k, s in enumerate(d.samples) if s.offset in starts]
    assert len(d.samples) == 16 and spans == [5] and 9 not in begun and 8 in begun


@pytest.mark.parametrize("name,codec", [("a_h264.h264", "h264"), ("b_hevc.hevc", "hevc"),
                                        ("c_mp4v_cv2.ts", "mp4v")])
def test_parser_cuts_do_not_depend_on_the_pieces_fed(name, codec):
    """FFmpeg's parser cuts the same packets however the stream arrives (a
    TS hands it 184-byte payloads): the cuts of the whole stream equal
    those of the stream fed in pieces of 1 to 997 bytes."""
    data = open(os.path.join(cf.DIR, name), "rb").read()
    if codec == "mp4v":                    # its elementary stream, out of the TS
        r = video.VideoReader(os.path.join(cf.DIR, name))
        data = b"".join(r.packets())
    whole = esparse.Splitter(codec).feed(data, final=True)
    for step in (1, 7, 184, 997):
        sp, cuts = esparse.Splitter(codec), []
        for i in range(0, len(data), step):
            cuts += sp.feed(data[i:i + step])
        cuts += sp.feed(b"", final=True)
        assert cuts == whole, step


def test_opendml_frame_count_is_the_stream_header_length(tmp_path):
    """cv2 counts an OpenDML file's frames by `strh`'s dwLength
    (`nb_frames`), not by `dmlh`'s total or `avih`'s first-RIFF count."""
    data = bytearray(open(os.path.join(cf.DIR, "f_odml.avi"), "rb").read())
    i = data.find(b"dmlh")
    data[i + 8:i + 12] = struct.pack("<I", 99)
    j = data.find(b"strh") + 8
    for length in (16, 50):
        data[j + 32:j + 36] = struct.pack("<I", length)
        path = str(tmp_path / f"odml{length}.avi")
        open(path, "wb").write(bytes(data))
        assert_equal_cv2(path)
        assert video.VideoReader(path).frame_count == length


# --------------------------------------------------------------------------- #
# layouts written at test time
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def x264_stream():
    if not hf.available():
        pytest.skip("no system libavcodec 59 with libx264")
    return cf.h264_stream(8)


def _padded(stream):
    """The stream with a filler NAL unit in each access unit so that every
    length-prefixed frame has one size (for fixed lacing)."""
    size = max(len(hf.length_prefixed(p.data)) for p in stream.packets) + 8
    packets = []
    for p in stream.packets:
        room = size - len(hf.length_prefixed(p.data)) - 4
        filler = b"\x0c" + b"\xff" * (room - 2) + b"\x80"
        packets.append(hf.Packet(p.data + b"\x00\x00\x00\x01" + filler, p.pts, p.dts, p.key))
    return hf.Stream(packets, stream.extradata, stream.rate, stream.size)


def _annexb_stream(stream):
    packets = list(stream.packets)
    packets[0] = hf.Packet(stream.extradata + packets[0].data, packets[0].pts, packets[0].dts,
                           packets[0].key)
    return hf.Stream(packets, b"", stream.rate, stream.size)


def _packets_of(path):
    r = video.VideoReader(path)
    return r, list(r.packets())


@pytest.mark.parametrize("case", ["fixed_lacing", "zlib", "vfw_h264", "mjpeg", "mp4v_sp",
                                  "ts_204", "ts_resync", "odml_no_indx"])
def test_layouts_equal_cv2(x264_stream, tmp_path, case):
    s = x264_stream
    path = str(tmp_path / (case + (".avi" if case.startswith("odml") else
                                   ".ts" if case.startswith("ts") else ".mkv")))
    if case == "fixed_lacing":
        cf.write_mkv(path, _padded(s), lacing="fixed", per_block=3)
    elif case == "zlib":
        cf.write_mkv(path, s, zlib_frames=True)
    elif case == "vfw_h264":
        bih = struct.pack("<IiiHH4sIiiII", 40, 128, 96, 1, 24, b"H264", 128 * 96 * 3, 0, 0, 0, 0)
        cf.write_mkv(path, _annexb_stream(s), codec="raw", codec_id="V_MS/VFW/FOURCC", private=bih)
    elif case == "mjpeg":
        r, packets = _packets_of(os.path.join(VIDEO_DIR, "mjpg_160x120.avi"))
        st = hf.Stream([hf.Packet(p, k, k, True) for k, p in enumerate(packets)], b"",
                       Fraction(30), (160, 120))
        cf.write_mkv(path, st, codec="raw", codec_id="V_MJPEG", private=b"")
    elif case == "mp4v_sp":
        r, packets = _packets_of(os.path.join(cf.DIR, "c_mp4v_cv2.mkv"))
        st = hf.Stream([hf.Packet(p, k, k, k == 0) for k, p in enumerate(packets)], b"",
                       Fraction(2997, 100), (128, 96))
        cf.write_mkv(path, st, codec="raw", codec_id="V_MPEG4/ISO/SP", private=r.track.extradata)
    elif case == "ts_204":
        data = open(os.path.join(cf.DIR, "a_h264.ts"), "rb").read()
        open(path, "wb").write(b"".join(data[i:i + 188] + bytes(16) for i in range(0, len(data), 188)))
    elif case == "ts_resync":
        data = open(os.path.join(cf.DIR, "a_h264.ts"), "rb").read()
        cut = 188 * 20
        open(path, "wb").write(data[:cut] + b"\x47\x00\x12" * 7 + data[cut:])
    else:
        cf.write_odml_avi(path, s, per_riff=3, super_index=False)
    assert_equal_cv2(path)


# --------------------------------------------------------------------------- #
# what is refused
# --------------------------------------------------------------------------- #

def _rewrite(tmp_path, name, old, new, out):
    data = open(os.path.join(cf.DIR, name), "rb").read()
    assert data.count(old) >= 1
    path = tmp_path / out
    path.write_bytes(data.replace(old, new, 1))
    return str(path)


def _ts_type(tmp_path, kind: int):
    data = bytearray(open(os.path.join(cf.DIR, "a_h264.ts"), "rb").read())
    pmt = data.find(b"\x1b\xe1\x00")
    start = pmt - 12
    data[pmt] = kind
    end = start + 3 + ((data[start + 1] & 0x0F) << 8 | data[start + 2])
    data[end - 4:end] = struct.pack(">I", mpegts.crc32(bytes(data[start:end - 4])))
    path = tmp_path / "x.ts"
    path.write_bytes(bytes(data))
    return str(path)


CODEC_ID = b"\x86\x8fV_MPEG4/ISO/AVC"


@pytest.mark.parametrize("case,match", [
    ("V_VP9", r"VP9 \('V_VP9'\) in Matroska"), ("V_AV1", r"AV1 \('V_AV1'\)"),
    ("V_MPEG2", r"MPEG-2 video \('V_MPEG2'\)"), ("V_THEORA", "Theora"),
    ("V_FOO", r"the Matroska codec 'V_FOO'"), ("bzlib", "compressed with bzlib"),
    ("encrypted_mkv", "encrypted Matroska"), ("ts_vc1", r"VC-1 \(stream type 0xEA\)"),
    ("senc", r"encrypted fragmented MP4 \('senc'\)"), ("encv", "encrypted video"),
])
def test_refused_raise_naming_it(tmp_path, case, match):
    if case.startswith("V_"):
        path = _rewrite(tmp_path, "a_h264.mkv", CODEC_ID,
                        b"\x86\x8f" + case.encode().ljust(15, b"\x00"), "x.mkv")
    elif case == "bzlib":
        path = _rewrite(tmp_path, "d_stripped.mkv", b"\x42\x54\x81\x03", b"\x42\x54\x81\x01", "x.mkv")
    elif case == "encrypted_mkv":
        path = _rewrite(tmp_path, "d_stripped.mkv", b"\x50\x33\x81\x00", b"\x50\x33\x81\x01", "x.mkv")
    elif case == "ts_vc1":
        path = _ts_type(tmp_path, 0xEA)
    elif case == "senc":
        path = _rewrite(tmp_path, "a_h264_frag.mp4", b"tfdt", b"senc", "x.mp4")
    else:
        entry = b"\x00" * 6 + b"\x00\x01"                # the sample entry's first fields
        path = _rewrite(tmp_path, "a_h264_frag.mp4", b"avc1" + entry, b"encv" + entry, "x.mp4")
    with pytest.raises(video.UnsupportedVideo, match=match):
        video.VideoReader(path)


# --------------------------------------------------------------------------- #
# the .mkv writer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("fps,n", [(29.97, 9), (30000 / 1001, 7), (25.0, 5)])
def test_mkv_writer_reads_back_as_cv2s_own(tmp_path, fps, n):
    """cv2 reads the port's `.mkv` at the fps and frame count it gives its
    own `.mkv` from cv2.VideoWriter(path, "mp4v", fps): DefaultDuration
    from cv2's rate, Duration in ms; its frames equal the port's."""
    frames = [scene(t, 96, 128) for t in range(n)]
    port, own = str(tmp_path / "port.mkv"), str(tmp_path / "own.mkv")
    with video.VideoWriter(port, fps, (128, 96)) as w:
        for f in frames:
            w.write(f)
    vw = cv2.VideoWriter(own, cv2.VideoWriter_fourcc(*"mp4v"), fps, (128, 96))
    for f in frames:
        vw.write(f)
    vw.release()
    a, b = cv2_read(port), cv2_read(own)
    assert a[:3] == b[:3] and len(a[4]) == n
    assert_equal_cv2(port)


# --------------------------------------------------------------------------- #
# the tracker
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A seeded edge_n at 64 px, written by the port (no JAX)."""
    from yololite_tpu_torch.config.config import read_yaml
    from yololite_tpu_torch.convert import to_flax
    from yololite_tpu_torch.models.detector import build_model_from_config
    from yololite_tpu_torch.train.checkpoint import build_meta, save_checkpoint
    cfg = read_yaml(os.path.join(ROOT, "configs", "models", "edge_n.yaml"))
    cfg["model"] = dict(cfg["model"], num_classes=3)
    cfg["training"] = {"img_size": 64}
    torch.manual_seed(0)
    model = build_model_from_config(cfg).eval()
    path = str(tmp_path_factory.mktemp("containers") / "edge_n.ckpt")
    return save_checkpoint(path, *to_flax(model),
                           build_meta(cfg, {}, "AP", ["c0", "c1", "c2"],
                                      model.get_num_anchors_per_level()))


def test_tracker_on_mkv_equals_the_mp4_of_its_stream(port_ckpt, tmp_path, capsys):
    """`tracker --video a_h264.mkv --out x.mkv` and `--video a_h264_frag.mp4`
    (the same x264 stream): the same tracks; cv2 reads the `.mkv` written
    at the source's 25 fps, every frame."""
    from yololite_tpu_torch.tools import tracker as tracker_tool
    torch.set_num_threads(1)
    argv = ["--weights", port_ckpt, "--device", "cpu", "--conf", "0.01", "--min_hits", "1"]
    out = str(tmp_path / "out.mkv")
    a = tracker_tool.main(argv + ["--video", os.path.join(cf.DIR, "a_h264.mkv"), "--out", out])
    assert capsys.readouterr().out.splitlines()[-1].startswith("Processed 16 frames @ ")
    b = tracker_tool.main(argv + ["--video", os.path.join(cf.DIR, "a_h264_frag.mp4")])
    assert len(a) == len(b) == 16 and sum(map(len, a)) > 0
    assert [[(t["track_id"], t["cls"], t["bbox"].tolist(), t["score"]) for t in fr] for fr in a] \
        == [[(t["track_id"], t["cls"], t["bbox"].tolist(), t["score"]) for t in fr] for fr in b]
    fps, count, size, _, frames = cv2_read(out)
    assert (fps, count, size, len(frames)) == (25.0, 16, (128, 96), 16)


# --------------------------------------------------------------------------- #
# malformed input, in a subprocess
# --------------------------------------------------------------------------- #

FUZZ = r"""
import os, random, sys, tempfile
from yololite_tpu_torch.data import video

rng = random.Random(int(sys.argv[1]))
n = int(sys.argv[2])
src = sys.argv[3]
names = ["a_h264.mkv", "b_hevc.mkv", "d_laced_xiph.mkv", "d_laced_ebml.mkv", "d_stripped.mkv",
         "d_unknown_size.mkv", "c_mp4v_cv2.mkv", "a_h264.ts", "b_hevc.m2ts", "e_split_pes.ts",
         "c_mp4v_cv2.ts", "a_h264_frag.mp4", "a_h264_fragmoof.mp4", "a_h264_hybrid.mp4",
         "b_hevc_frag.mp4", "f_odml.avi", "a_h264.h264", "b_hevc.hevc"]
files = {k: open(os.path.join(src, k), "rb").read() for k in names}
tmp = tempfile.mkdtemp()
codes = {}
for case in range(n):
    name = rng.choice(names)
    data = bytearray(files[name])
    kind = rng.choice(["head", "bytes", "cut", "insert", "sizes"])
    if kind == "head":
        for _ in range(rng.randint(1, 6)):
            k = rng.randrange(min(len(data), 1024))
            data[k] ^= 1 << rng.randrange(8)
    elif kind == "bytes":
        for _ in range(rng.randint(1, 12)):
            data[rng.randrange(len(data))] = rng.randrange(256)
    elif kind == "cut":
        data = data[:rng.randrange(len(data))]
    elif kind == "insert":
        k = rng.randrange(len(data))
        data[k:k] = bytes(rng.randrange(256) for _ in range(rng.randint(1, 400)))
    else:
        for _ in range(rng.randint(1, 4)):      # an EBML size, a TS header byte, a box count
            k = rng.randrange(len(data))
            data[k] = rng.choice([0x01, 0x08, 0x10, 0x40, 0x47, 0x80, 0xFF])
    path = os.path.join(tmp, "f" + os.path.splitext(name)[1])
    open(path, "wb").write(bytes(data))
    try:
        r = video.VideoReader(path)
        list(r.packets())
        list(r)
        key = "read"
    except (ValueError, video.UnsupportedVideo) as e:
        key = type(e).__name__
    codes[key] = codes.get(key, 0) + 1
print("cases", n, sorted(codes.items()))
"""


def test_malformed_containers_end_with_a_code_in_a_subprocess():
    """Mutated, cut and padded Matroska, TS, fragmented MP4, OpenDML AVI and
    raw Annex B files: each reads or raises `ValueError`/`UnsupportedVideo`;
    none crashes or hangs the process."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", FUZZ, "2023", "240", cf.DIR],
                          capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("cases 240"), proc.stdout


# (fixture, box, offset after the box's type, bytes written there, what opening gives)
BOUNDED = {
    "trun_no_fields": ("a_h264_frag.mp4", b"trun", 1, b"\x00\x00\x05\xff\xff\xff\xff",
                       "'trun' lists"),
    "trun_empty_samples": ("a_h264_frag.mp4", b"trun", 1, b"\x00\x00\x05", "'trun' lists"),
    "stts_count": ("a_h264_hybrid.mp4", b"stts", 8, b"\xff\xff\xff\xff", None),
    "ctts_count": ("a_h264_hybrid.mp4", b"ctts", 8, b"\xff\xff\xff\xff", None),
    "stsz_constant": ("a_h264_hybrid.mp4", b"stsz", 4, b"\x00\x00\x00\x01\xff\xff\xff\xff",
                      None),
    "avi_without_strf": ("f_odml.avi", b"strf", -4, b"strX", "BITMAPINFOHEADER"),
}


@pytest.mark.parametrize("case", sorted(BOUNDED))
def test_counts_past_the_file_are_bounded(tmp_path, case):
    """Counts from the file of 2^32 - 1 samples (a `trun` without per-sample
    fields, an `stts` or `ctts` entry, a constant-size `stsz`), a `trun` of
    empty samples and an AVI stream without its `strf`: opening raises
    `ValueError` at once, or lists no more samples than the file holds,
    instead of looping over or allocating what the count says."""
    name, box, at, data, match = BOUNDED[case]
    raw = bytearray(open(os.path.join(cf.DIR, name), "rb").read())
    i = raw.find(box) + 4 + at
    raw[i:i + len(data)] = data
    if case == "trun_empty_samples":
        j = raw.find(b"tfhd")
        raw[j + 24:j + 28] = bytes(4)                       # tfhd's default sample size
    path = tmp_path / ("x" + os.path.splitext(name)[1])
    path.write_bytes(bytes(raw))
    if match:
        with pytest.raises(ValueError, match=match):
            video.VideoReader(str(path))
    else:
        assert len(video.VideoReader(str(path)).track.samples) <= len(raw)


def test_zlib_frame_inflates_no_further_than_ffmpegs_buffer(tmp_path):
    """A zlib-compressed Matroska frame of 40 MB (40 KB deflated) does not
    end within FFmpeg's buffer (three times the frame's size, grown
    threefold to 10 MB or more): the stream stops before it, with the
    frames ahead of it read."""
    r, packets = _packets_of(os.path.join(cf.DIR, "c_mp4v_cv2.mkv"))
    bomb = bytes(40 << 20)
    st = hf.Stream([hf.Packet(p, k, k, k == 0) for k, p in enumerate(packets[:3] + [bomb])],
                   b"", Fraction(2997, 100), (128, 96))
    path = str(tmp_path / "bomb.mkv")
    cf.write_mkv(path, st, codec="raw", codec_id="V_MPEG4/ISO/SP", private=r.track.extradata,
                 zlib_frames=True)
    reader = video.VideoReader(path)
    assert list(reader.packets()) == packets[:3]
    assert "does not end within" in reader.stop_reason
