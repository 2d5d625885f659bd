"""PyTorch port, the slice as a whole: Predictor and YoloLite against the JAX
Predictor on one checkpoint.

Both read a checkpoint written by `save_checkpoint` + `build_meta` for a
seeded edge_n at img 64. Frames are already 64x64, so the letterbox is the
identity and both sides see the same pixels. conf 0.001 keeps the JAX side on
its exact (unroll=0) suppression. Valid detections match one to one: same
class, box within 1e-3 px, score within 1e-5 (fp32 forward rounding; see
test_torch_port_models.py), equal count.
"""

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yololite_tpu.api import YoloLite as JaxYoloLite
from yololite_tpu.deploy.predictor import Predictor as JaxPredictor
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint

from tests.test_torch_port_imwrite import assert_jpeg_like_cv2
from tests.test_torch_port_models import edge_cfg, jax_edge
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.data.png import UnsupportedImage
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.ops import cuda_nms

IMG = 64


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    _, params, bs = jax_edge(IMG)
    meta = build_meta(edge_cfg(IMG), {}, "map", ["a", "b", "c"], (1, 1, 1))
    return save_checkpoint(str(tmp_path_factory.mktemp("ck") / "edge_n.ckpt"),
                           params, bs, meta)


def _frames(n=2, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(IMG, IMG, 3) * 255).astype(np.uint8) for _ in range(n)]


def _assert_matched(got, want):
    gb, gs, gc = got
    wb, ws, wc = (np.asarray(x) for x in want)
    assert len(gb) == len(wb) > 0
    unmatched = list(range(len(wb)))
    for b, s, c in zip(gb, gs, gc):
        hit = [j for j in unmatched if wc[j] == c
               and np.abs(wb[j] - b).max() <= 1e-3 and abs(ws[j] - s) <= 1e-5]
        assert hit, f"no JAX detection matches class {c} box {b} score {s}"
        unmatched.remove(hit[0])


def test_predictor_matches_jax(ckpt):
    port = Predictor(ckpt, device="cpu", dtype=torch.float32)
    ref = JaxPredictor(ckpt, dtype=jnp.float32)
    for frame in _frames():
        got = port.infer_image(frame, conf=0.001, iou=0.45)
        want = ref.infer_image(frame, conf=0.001, iou=0.45)
        _assert_matched(got, want)
    assert cuda_nms.LAUNCHES == 0


def test_batch_and_stream_agree_with_single(ckpt):
    port = Predictor(ckpt, device="cpu", dtype=torch.float32)
    frames = _frames(3, seed=1)
    single = [port.infer_image(f, conf=0.01) for f in frames]
    batched = port.infer_batch(frames, conf=0.01)
    canvases = np.stack([np.ascontiguousarray(f[..., ::-1]) for f in frames])
    streamed = [r for out in port.infer_batched_stream(
        [canvases, canvases[:2]], conf=0.01, prepared=True, depth=1) for r in out]
    assert len(batched) == 3 and len(streamed) == 5
    for i, (b, s, c) in enumerate(single):
        # streamed[3:] is the second batch, canvases[:2]
        for r in [batched[i], streamed[i]] + ([streamed[3 + i]] if i < 2 else []):
            np.testing.assert_allclose(r["boxes"], b, atol=1e-3)
            np.testing.assert_allclose(r["scores"], s, atol=1e-5)
            np.testing.assert_array_equal(r["classes"], c)
    assert "total_ms" in batched[0]["speed"]


def test_api_predict_and_unported_entry_points(ckpt, tmp_path, monkeypatch):
    model = YoloLite(ckpt, device="cpu")
    frames = _frames(2, seed=2)
    res = model.predict(frames, conf=0.01)
    assert len(res) == 2 and res[0]["boxes"].shape[1] == 4
    assert res[0]["masks"] is None and "total_ms" in res[0]["speed"]
    np.save(tmp_path / "f.npy", frames[0])
    one = model.predict(str(tmp_path / "f.npy"), conf=0.01)[0]
    np.testing.assert_allclose(one["boxes"], res[0]["boxes"], atol=1e-3)
    cv2.imwrite(str(tmp_path / "f.tif"), frames[0])          # TIFF is read as cv2 reads it
    tif = model.predict(str(tmp_path / "f.tif"), conf=0.01)[0]
    np.testing.assert_array_equal(tif["boxes"], one["boxes"])
    cv2.imwrite(str(tmp_path / "f.gif"), frames[0])           # GIF is not decoded
    with pytest.raises(UnsupportedImage, match="GIF"):
        model.predict(str(tmp_path / "f.gif"))
    from yololite_tpu_torch.deploy.export import export_tflite, load_exported
    call, meta = load_exported(export_tflite(ckpt, out_dir=str(tmp_path / "tflite")))
    out = call(np.stack(frames)[:1])               # TFLite export runs on the host
    assert meta["runtime"] == "tflite" and meta["img_size"] == IMG
    assert set(out) == {"boxes_xyxy", "cls_logits", "obj_logits"}
    assert np.isfinite(out["boxes_xyxy"]).all() and out["boxes_xyxy"].shape[0] == 1
    # training, validation and both mesh axes are ported: train(spatial_parallel=2)
    # (with or without the recipe's augmentation) spawns a 1 x 2 mesh, rank r
    # at (data index, spatial index) = divmod(r, 2); the spawn is recorded
    # here, not run (test_torch_port_spatial.py trains one)
    from chip_smoke import make_synth_set
    from yololite_tpu_torch.parallel.dist import DataParallel
    from yololite_tpu_torch.train import loop
    data = make_synth_set(str(tmp_path / "set"), n_train=2, n_val=1, w=32, h=24)
    spawned = []

    def record(config, device, n):
        sp = int(config["training"]["spatial_parallel"])
        spawned.append((device, n, [(d.data_index, d.spatial_index) for d in
                                    (DataParallel(n, r, r, n, sp) for r in range(n))]))
        return {}

    monkeypatch.setattr(loop, "_spawn", record)
    for augment in (True, False):
        model.train(data=data, epochs=1, batch_size=2, run_dir=str(tmp_path / "runs"),
                    augment=augment, spatial_parallel=2)
        assert spawned.pop() == ("cpu", 2, [(0, 0), (0, 1)])


def _fp32(model, ckpt):
    """The API object with an fp32 Predictor (its default is bf16, as JAX's)."""
    model._predictor = (Predictor(ckpt, device="cpu", dtype=torch.float32)
                        if isinstance(model, YoloLite) else JaxPredictor(ckpt, dtype=jnp.float32))
    return model


def test_predict_reads_a_png_path_like_jax(ckpt, tmp_path):
    """A PNG path is decoded (as BGR, as cv2.imread hands it on) and gives
    JAX's detections for the same file."""
    frame = _frames(1, seed=3)[0]
    path = str(tmp_path / "frame.png")
    cv2.imwrite(path, frame)
    got = _fp32(YoloLite(ckpt, device="cpu"), ckpt).predict(path, conf=0.001)[0]
    want = _fp32(JaxYoloLite(ckpt), ckpt).predict(path, conf=0.001)[0]
    assert got["source"] == want["source"] == path
    _assert_matched((got["boxes"], got["scores"], got["classes"]),
                    (want["boxes"], want["scores"], want["classes"]))


def test_predict_on_a_folder_like_jax(ckpt, tmp_path):
    """A folder gives one result per image, in JAX's order, for PNG and for
    JPEG folders alike."""
    frames = _frames(3, seed=4)
    png_dir, jpg_dir = tmp_path / "png", tmp_path / "jpg"
    png_dir.mkdir()
    jpg_dir.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(png_dir / f"{i}.png"), f)
        cv2.imwrite(str(jpg_dir / f"{i}.jpg"), f)
    got = _fp32(YoloLite(ckpt, device="cpu"), ckpt).predict(str(png_dir), conf=0.001)
    want = _fp32(JaxYoloLite(ckpt), ckpt).predict(str(png_dir), conf=0.001)
    assert [r["source"] for r in got] == [r["source"] for r in want] == \
        [str(png_dir / f"{i}.png") for i in range(3)]
    for g, w in zip(got, want):
        _assert_matched((g["boxes"], g["scores"], g["classes"]),
                        (w["boxes"], w["scores"], w["classes"]))
    got = _fp32(YoloLite(ckpt, device="cpu"), ckpt).predict(str(jpg_dir), conf=0.001)
    want = _fp32(JaxYoloLite(ckpt), ckpt).predict(str(jpg_dir), conf=0.001)
    assert [r["source"] for r in got] == [r["source"] for r in want] == \
        [str(jpg_dir / f"{i}.jpg") for i in range(3)]
    for g, w in zip(got, want):
        _assert_matched((g["boxes"], g["scores"], g["classes"]),
                        (w["boxes"], w["scores"], w["classes"]))


def test_predict_reads_a_jpeg_path_like_jax(ckpt, tmp_path):
    """A JPEG path is decoded by the port's codec (cv2.imread's pixels) and
    gives JAX's detections for the same file."""
    frame = _frames(1, seed=5)[0]
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, frame, [cv2.IMWRITE_JPEG_QUALITY, 90])
    got = _fp32(YoloLite(ckpt, device="cpu"), ckpt).predict(path, conf=0.001)[0]
    want = _fp32(JaxYoloLite(ckpt), ckpt).predict(path, conf=0.001)[0]
    assert got["source"] == want["source"] == path
    _assert_matched((got["boxes"], got["scores"], got["classes"]),
                    (want["boxes"], want["scores"], want["classes"]))


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_predict_on_a_damaged_file_raises_file_not_found_like_jax(ckpt, tmp_path, ext):
    """Where cv2.imread gives None, JAX's predict raises FileNotFoundError
    naming the path; the port does the same for every format."""
    path = str(tmp_path / f"bad{ext}")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40 if ext == ".png" else b"\xff\xd8\xff\xd9")
    for model in (YoloLite(ckpt, device="cpu"), JaxYoloLite(ckpt)):
        with pytest.raises(FileNotFoundError, match="bad"):
            model.predict(path)


@pytest.mark.parametrize("kw", [{"draw": True}, {"save_dir": "out"}], ids=["draw", "save_dir"])
def test_predict_drawing_raises_naming_its_item(ckpt, kw, tmp_path):
    """draw= and save_dir= draw the port's detections as JAX's
    draw_detections draws them (the "plot", RGB; save_dir writes
    pred_0.jpg for an array); a source whose extension has no writer
    raises naming the extension."""
    from yololite_tpu.utils.viz import draw_detections as jax_draw
    if "save_dir" in kw:
        kw = {"save_dir": str(tmp_path / kw["save_dir"])}
    frame = _frames(1)[0]
    r = YoloLite(ckpt, device="cpu").predict(frame, conf=0.001, **kw)[0]
    want = jax_draw(frame[..., ::-1], r["boxes"], r["scores"], r["classes"], ["a", "b", "c"])
    np.testing.assert_array_equal(r["plot"], want)
    if "save_dir" in kw:
        assert_jpeg_like_cv2(str(tmp_path / "out" / "pred_0.jpg"), want[..., ::-1], tmp_path)
        npy = tmp_path / "frame.npy"
        np.save(npy, frame)
        with pytest.raises(ValueError, match=".npy"):
            YoloLite(ckpt, device="cpu").predict(str(npy), **kw)
