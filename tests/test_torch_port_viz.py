"""Drawing (`yololite_tpu_torch/utils/viz.py` on `data/imgops.py`) against
the JAX package's `utils/viz.py` and the installed cv2 (OpenCV 5.0), and
every port entry point that draws.

Everything drawn is compared before encoding, pixel for pixel: JAX's
canvases are captured where its code calls `cv2.imwrite` (the JAX module's
`cv2` is swapped for a recording proxy in the test only), the port's where
it calls `imwrite_bgr`. The files themselves are held to the JPEG bounds of
test_torch_port_imwrite.py, PNG exactly.

  - `put_text` / `text_size` equal cv2.putText / cv2.getTextSize
    (FONT_HERSHEY_SIMPLEX) for every printable ASCII character at the two
    (scale, thickness) pairs the drawing uses, and on random strings,
    origins (partly outside the image), colours and backgrounds;
  - `rectangle` equals cv2.rectangle at thickness -1 to 5 on random boxes,
    partly or wholly outside the image and degenerate;
  - `draw_detections`, `visualize_batch` and `save_val_debug` equal JAX's;
  - the callers draw exactly what JAX's drawing code gives for the port's
    own detections (the boxes of the two packages differ within fp32
    rounding, so each side draws its own): `YoloLite.predict(draw=,
    save_dir=)` on a JPEG, a PNG and arrays, the infer CLI's
    `*_pred.jpg`, the tracker's `--out` as an .avi (mp4v, as the JAX
    tool's writer: read back by cv2 equal to the port's decoder, luma at
    40 dB PSNR or more) and as an image sequence, and the training loop's
    sanity and val-debug images.
"""

import os
import random

import cv2
import numpy as np
import pytest
import torch

from yololite_tpu.utils import viz as jax_viz

from chip_smoke import make_clip, make_synth_set
from tests.test_torch_port_imwrite import assert_jpeg_like_cv2
from tests.test_torch_port_predictor import ckpt  # noqa: F401 fixture
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data import imwrite
from yololite_tpu_torch.data.video import VideoReader
from yololite_tpu_torch.tools import infer as infer_tool
from yololite_tpu_torch.tools import tracker as tracker_tool
from yololite_tpu_torch.train import loop as train_loop
from yololite_tpu_torch.utils import viz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACE = cv2.FONT_HERSHEY_SIMPLEX
TEXT_SIZES = [(0.5, 1), (0.8, 2)]
CHARS = [chr(i) for i in range(32, 127)]
NAMES = ["a", "b", "c"]            # the `ckpt` fixture's class names


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_written(monkeypatch):
    """The BGR arrays JAX's viz module hands cv2.imwrite, by file name."""
    seen = {}

    class Cv2:
        def __getattr__(self, name):
            return getattr(cv2, name)

        @staticmethod
        def imwrite(path, img):
            seen[os.path.basename(path)] = img.copy()
            return True
    monkeypatch.setattr(jax_viz, "cv2", Cv2())
    return seen


@pytest.fixture
def port_written(monkeypatch):
    """The BGR arrays the port writes through `imwrite_bgr`, by file name
    (the files are written too)."""
    seen = {}
    write = imwrite.imwrite_bgr

    def capture(path, img):
        seen[os.path.basename(path)] = np.array(img, copy=True)
        write(path, img)
    for mod in (imwrite, viz, infer_tool, tracker_tool):
        monkeypatch.setattr(mod, "imwrite_bgr", capture)
    return seen


# --------------------------------------------------------------------------- #
# Primitives against cv2
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("scale,thickness", TEXT_SIZES)
def test_every_character_matches_cv2(scale, thickness):
    rng = np.random.RandomState(int(scale * 10))
    for c in CHARS:
        assert imgops.text_size(c, scale, thickness) == \
            cv2.getTextSize(c, FACE, scale, thickness)
        bg = rng.randint(0, 256, (40, 40, 3)).astype(np.uint8)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        org = (int(rng.randint(-8, 36)), int(rng.randint(-4, 50)))
        want = bg.copy()
        cv2.putText(want, c, org, FACE, scale, color, thickness)
        np.testing.assert_array_equal(imgops.put_text(bg.copy(), c, org, scale, color,
                                                      thickness), want, err_msg=repr(c))


@pytest.mark.parametrize("scale,thickness", TEXT_SIZES)
@pytest.mark.parametrize("channels", [1, 3])
def test_random_strings_match_cv2(scale, thickness, channels):
    rng = random.Random(channels)
    nrng = np.random.RandomState(channels)
    for _ in range(150):
        text = "".join(rng.choice(CHARS) for _ in range(rng.randint(0, 16)))
        h, w = rng.randint(3, 60), rng.randint(3, 120)
        bg = nrng.randint(0, 256, (h, w, 3)[:2 + (channels == 3)]).astype(np.uint8)
        color = tuple(rng.randint(0, 255) for _ in range(3))
        org = (rng.randint(-40, w + 5), rng.randint(-10, h + 25))
        want = bg.copy()
        cv2.putText(want, text, org, FACE, scale, color, thickness)
        np.testing.assert_array_equal(imgops.put_text(bg.copy(), text, org, scale, color,
                                                      thickness), want, err_msg=repr(text))
        assert imgops.text_size(text, scale, thickness) == \
            cv2.getTextSize(text, FACE, scale, thickness)


def test_text_outside_the_table_raises():
    with pytest.raises(ValueError, match="FONT_HERSHEY_SIMPLEX"):
        imgops.text_size("x", 1.0, 1)


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3, 4, 5])
def test_rectangle_matches_cv2(thickness):
    rng = random.Random(thickness)
    for k in range(600):
        h, w = rng.randint(1, 40), rng.randint(1, 40)
        p1 = (rng.randint(-10, w + 10), rng.randint(-10, h + 10))
        p2 = (rng.randint(-10, w + 10), rng.randint(-10, h + 10))
        if k % 5 == 0:          # degenerate: a point, a line
            p2 = (p1[0] + rng.randint(-2, 2), p1[1] + rng.randint(-2, 2))
        color = tuple(rng.randint(0, 255) for _ in range(3))
        bg = np.random.RandomState(k).randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = bg.copy()
        cv2.rectangle(want, p1, p2, color, thickness)
        np.testing.assert_array_equal(imgops.rectangle(bg.copy(), p1, p2, color, thickness),
                                      want, err_msg=f"{p1} {p2} {(h, w)}")


# --------------------------------------------------------------------------- #
# utils/viz.py against JAX's
# --------------------------------------------------------------------------- #

def _boxes(rng, n, h, w, case):
    if case == "edges":         # across every edge, and wholly outside
        x = rng.uniform(-60, w + 60, (n, 2))
        y = rng.uniform(-60, h + 60, (n, 2))
    elif case == "top":         # labels near y = 0
        x = rng.uniform(0, w, (n, 2))
        y = np.stack([rng.uniform(-6, 18, n), rng.uniform(18, h, n)], 1)
    else:
        x = rng.uniform(-10, w + 10, (n, 2))
        y = rng.uniform(-10, h + 10, (n, 2))
    x.sort(1)
    y.sort(1)
    return np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1)


CASES = {  # name: (boxes case, class id bound, names, with scores)
    "edges": ("edges", 3, ["person", "car", "dog"], True),
    "top": ("top", 3, ["person", "car", "dog"], True),
    "beyond_palette": ("any", 60, ["a", "b"], True),
    "names_none": ("any", 25, None, True),
    "no_scores": ("any", 5, ["x", "y", "z", "w", "v"], False),
    "empty": ("any", 3, ["a"], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_draw_detections_matches_jax(case):
    box_case, n_cls, names, with_scores = CASES[case]
    rng = np.random.RandomState(len(case))
    for _ in range(12):
        h, w = rng.randint(20, 160), rng.randint(20, 200)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        n = 0 if case == "empty" else rng.randint(1, 9)
        boxes = _boxes(rng, n, h, w, box_case)
        scores = rng.rand(n) if with_scores else None
        classes = rng.randint(0, n_cls, n)
        want = jax_viz.draw_detections(img, boxes, scores, classes, names)
        got = viz.draw_detections(img, boxes, scores, classes, names)
        np.testing.assert_array_equal(got, want)
        assert not np.shares_memory(got, img)
    assert viz.class_color(41) == jax_viz.class_color(41)


def _batch(rng, b, h=48, w=64, m=5, n_cls=4):
    boxes = np.sort(rng.uniform(-5, max(h, w) + 5, (b, m, 2, 2)), axis=2).reshape(b, m, 4)
    return {"image": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
            "boxes": boxes[..., [0, 2, 1, 3]].astype(np.float32),
            "labels": rng.randint(0, n_cls, (b, m)).astype(np.int32),
            "mask": rng.rand(b, m) < 0.7}


@pytest.mark.parametrize("b", [1, 3, 5, 10])
def test_visualize_batch_matches_jax(tmp_path, jax_written, port_written, b):
    batch = _batch(np.random.RandomState(b), b)
    jax_viz.visualize_batch(batch, str(tmp_path / "jax" / "sanity_check.jpg"), ["p", "q"])
    viz.visualize_batch(batch, str(tmp_path / "port" / "sanity_check.jpg"), ["p", "q"])
    want = jax_written["sanity_check.jpg"]
    np.testing.assert_array_equal(port_written["sanity_check.jpg"], want)
    assert want.shape == (48 * ((min(b, 8) + 3) // 4), 64 * min(4, b), 3)
    assert_jpeg_like_cv2(str(tmp_path / "port" / "sanity_check.jpg"), want, tmp_path)


@pytest.mark.parametrize("conf_th", [0.35, 0.3])
def test_save_val_debug_matches_jax(tmp_path, jax_written, port_written, conf_th):
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    boxes = np.sort(rng.uniform(-5, 70, (3, 6, 2, 2)), axis=2).reshape(3, 6, 4)
    dets = {"boxes": boxes[..., [0, 2, 1, 3]], "scores": rng.rand(3, 6),
            "classes": rng.randint(0, 3, (3, 6)), "valid": rng.rand(3, 6) < 0.8}
    jax_viz.save_val_debug(images, dets, str(tmp_path / "jax"), conf_th=conf_th,
                           names=NAMES)
    viz.save_val_debug(images, dets, str(tmp_path / "port"), conf_th=conf_th, names=NAMES)
    assert sorted(jax_written) == sorted(port_written) == ["last_b0.jpg", "last_b1.jpg"]
    for name, want in jax_written.items():
        np.testing.assert_array_equal(port_written[name], want)
        assert_jpeg_like_cv2(str(tmp_path / "port" / name), want, tmp_path)


# --------------------------------------------------------------------------- #
# The callers
# --------------------------------------------------------------------------- #

def _frame(seed=3, h=64, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("source", ["jpg", "png", "arrays"])
def test_predict_draws_and_saves_like_jax(ckpt, tmp_path, port_written, source):  # noqa: F811
    out = str(tmp_path / "out")
    if source == "arrays":
        frames = [_frame(3), _frame(4)]
        results = YoloLite(ckpt, device="cpu").predict(frames, conf=0.001, draw=True,
                                                       save_dir=out)
        files = ["pred_0.jpg", "pred_1.jpg"]
    else:
        path = str(tmp_path / f"frame.{source}")
        cv2.imwrite(path, _frame(3))
        frames = [cv2.imread(path)]
        results = YoloLite(ckpt, device="cpu").predict(path, conf=0.001, draw=True,
                                                       save_dir=out)
        files = [f"frame.{source}"]
    assert sorted(os.listdir(out)) == files
    for r, frame, name in zip(results, frames, files):
        assert len(r["boxes"]) > 0
        want = jax_viz.draw_detections(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), r["boxes"],
                                       r["scores"], r["classes"], NAMES)
        np.testing.assert_array_equal(r["plot"], want)
        np.testing.assert_array_equal(port_written[name], want[..., ::-1])
        if name.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(os.path.join(out, name)),
                                          want[..., ::-1])
        else:
            assert_jpeg_like_cv2(os.path.join(out, name), want[..., ::-1], tmp_path)
    plain = YoloLite(ckpt, device="cpu").predict(frames[0], conf=0.001)[0]
    assert "plot" not in plain


def test_infer_writes_the_drawn_detections(ckpt, tmp_path, port_written):  # noqa: F811
    src = tmp_path / "in"
    src.mkdir()
    for i in range(2):
        cv2.imwrite(str(src / f"{i}.png"), _frame(10 + i, 48, 64))
    got = infer_tool.main(["--weights", ckpt, "--img", str(src), "--conf", "0.001",
                           "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert len(got) == 2
    for path, r in got.items():
        stem = os.path.splitext(os.path.basename(path))[0]
        want = jax_viz.draw_detections(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB),
                                       r["boxes"], r["scores"], r["classes"], NAMES)
        np.testing.assert_array_equal(port_written[f"{stem}_pred.jpg"], want[..., ::-1])
        assert_jpeg_like_cv2(str(tmp_path / "out" / f"{stem}_pred.jpg"), want[..., ::-1],
                             tmp_path)


def _jax_tracker_overlay(frame, tracks, fps):
    """JAX tools/tracker.py's drawing, with cv2, on a copy of the frame."""
    frame = frame.copy()
    for t in tracks:
        x1, y1, x2, y2 = [int(v) for v in t["bbox"]]
        color = jax_viz.class_color(t["cls"])
        cv2.rectangle(frame, (x1, y1), (x2, y2), color, 2)
        cv2.putText(frame, f"#{t['track_id']} c{t['cls']} {t['score']:.2f}",
                    (x1, max(12, y1 - 6)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    cv2.putText(frame, f"FPS {fps:.1f}", (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (0, 255, 0), 2)
    return frame


@pytest.mark.parametrize("out", ["clip.avi", "drawn/%04d.jpg", "drawn/f%03d.png"])
def test_tracker_out_draws_like_jax(ckpt, tmp_path, monkeypatch, capsys, out):  # noqa: F811
    frames = make_clip(12, h=48, w=64, seed=3)
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(seq / ("%04d.png" % i)), f)
    fps_seen, written = [], []
    draw, open_writer = tracker_tool.draw_tracks, tracker_tool.open_writer

    def record_draw(frame, tracks, fps):
        fps_seen.append(fps)
        draw(frame, tracks, fps)

    def record_writer(path, size, fps):
        w = open_writer(path, size, fps)
        write = w.write
        w.write = lambda frame: (written.append(frame.copy()), write(frame))
        return w
    monkeypatch.setattr(tracker_tool, "draw_tracks", record_draw)
    monkeypatch.setattr(tracker_tool, "open_writer", record_writer)
    target = str(tmp_path / out)
    tracks = tracker_tool.main(["--weights", ckpt, "--video", str(seq / "%04d.png"),
                                "--device", "cpu", "--conf", "0.001", "--min_hits", "1",
                                "--out", target])
    assert capsys.readouterr().out.splitlines()[-1].endswith(f" FPS -> {target}")
    assert len(tracks) == len(written) == 12 and sum(map(len, tracks)) > 0
    assert fps_seen[:9] == [0.0] * 9 and fps_seen[9] > 0
    for k, (f, ts, fps) in enumerate(zip(frames, tracks, fps_seen)):
        np.testing.assert_array_equal(written[k], _jax_tracker_overlay(f, ts, fps))
    if out.endswith(".avi"):       # mp4v (FMP4), as the JAX tool's cv2.VideoWriter
        cap = cv2.VideoCapture(target)
        assert cap.get(cv2.CAP_PROP_FPS) == tracker_tool.SEQUENCE_FPS == 25.0
        ycap = cv2.VideoCapture(target, cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])
        for want, port in zip(written, VideoReader(target)):
            ok, got = cap.read()
            assert ok
            np.testing.assert_array_equal(port, got)
            y = ycap.read()[1][:want.shape[0]].astype(np.float64)
            w = want.astype(np.int32)
            w_luma = ((66 * w[..., 2] + 129 * w[..., 1] + 25 * w[..., 0] + 128) >> 8) + 16
            assert 10 * np.log10(255.0 ** 2 / np.mean((y - w_luma) ** 2)) >= 40.0
        assert not cap.read()[0]
    else:           # numbered from 1, as cv2's image-sequence writer numbers
        for k, want in enumerate(written, 1):
            path = target % k
            if path.endswith(".png"):
                np.testing.assert_array_equal(cv2.imread(path), want)
            else:
                assert_jpeg_like_cv2(path, want, tmp_path)
        assert not os.path.exists(target % 0) and not os.path.exists(target % 13)


def test_tracker_refuses_what_it_cannot_write(ckpt, tmp_path):  # noqa: F811
    seq = tmp_path / "seq"
    seq.mkdir()
    cv2.imwrite(str(seq / "0000.png"), _frame(1, 48, 64))
    argv = ["--weights", ckpt, "--video", str(seq / "%04d.png"), "--device", "cpu"]
    for out in ("o.mkv", "out_dir"):
        with pytest.raises(NotImplementedError, match="other containers are not written"):
            tracker_tool.main(argv + ["--out", str(tmp_path / out)])
    with pytest.raises(NotImplementedError, match="--show"):
        tracker_tool.main(argv + ["--show"])
    assert sorted(os.listdir(tmp_path)) == ["seq"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synth_set(str(tmp_path_factory.mktemp("set")), n_train=8, n_val=6,
                          w=80, h=60)


LOOP = dict(batch_size=4, img_size=64, augment=False, amp=False, workers=0,
            pretrained_backbone=os.path.join(ROOT, "weights", "mnv4_050_cls20.ckpt"))


def test_loop_writes_sanity_and_val_debug_images(data, tmp_path, monkeypatch,
                                                 jax_written, port_written):
    """Six epochs: the sanity image of the first batch at the start and the
    val-debug images of epoch 6 (none before), each equal to JAX's drawing
    of the same batch and detections."""
    calls = {"sanity": [], "debug": []}
    vis, dbg = train_loop.visualize_batch, train_loop.save_val_debug

    def sanity(batch, path, names):
        calls["sanity"].append((batch, path, names))
        vis(batch, path, names)

    def debug(images, dets, out_dir, **kw):
        calls["debug"].append((np.array(images, copy=True), dets, out_dir, kw))
        dbg(images, dets, out_dir, **kw)
    monkeypatch.setattr(train_loop, "visualize_batch", sanity)
    monkeypatch.setattr(train_loop, "save_val_debug", debug)
    res = YoloLite("edge_n", device="cpu").train(data=data, epochs=6,
                                                 run_dir=str(tmp_path / "runs"), **LOOP)
    log_dir = res["log_dir"]
    assert len(calls["sanity"]) == 1 and len(calls["debug"]) == 1
    batch, path, names = calls["sanity"][0]
    assert path == os.path.join(log_dir, "sanity_check.jpg") and names == ["c0", "c1", "c2"]
    port = {k: v for k, v in port_written.items()}
    jax_viz.visualize_batch(batch, str(tmp_path / "jax.jpg"), names)
    np.testing.assert_array_equal(port["sanity_check.jpg"], jax_written["jax.jpg"])
    images, dets, out_dir, kw = calls["debug"][0]
    assert out_dir == log_dir and kw == {"conf_th": 0.3, "names": names}
    jax_viz.save_val_debug(images, dets, str(tmp_path / "jax_dbg"), **kw)
    for name in ("last_b0.jpg", "last_b1.jpg"):
        np.testing.assert_array_equal(port[name], jax_written[name])
        assert_jpeg_like_cv2(os.path.join(log_dir, name), port[name], tmp_path)
    assert_jpeg_like_cv2(os.path.join(log_dir, "sanity_check.jpg"), port["sanity_check.jpg"],
                         tmp_path)


def test_loop_prints_a_failed_sanity_image(data, tmp_path, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("no canvas")
    monkeypatch.setattr(train_loop, "visualize_batch", broken)
    res = YoloLite("edge_n", device="cpu").train(data=data, epochs=1,
                                                 run_dir=str(tmp_path / "runs"), **LOOP)
    assert "[sanity_check] skipped: no canvas" in capsys.readouterr().out.splitlines()
    assert not os.path.exists(os.path.join(res["log_dir"], "sanity_check.jpg"))
    assert os.path.exists(os.path.join(res["log_dir"], "metrics.csv"))
