"""The offline weather tool (`yololite_tpu_torch/data/weather.py`,
`tools/augment_weather.py`) against the JAX package's, with the installed
cv2 behind JAX's.

  - rain and snow equal JAX's output exactly, one seed, several sizes;
  - fog within 1 level, on at most FOG_SHARE of the values (measured:
    1.4e-5 at 480x640): the port's INTER_CUBIC upsampling is within 2 ulp
    of cv2's (its float sums run in another order), and the 31x31 box blur
    and the blend after it then flip a rounding here and there; sun flare
    and shadow (the augmentation presets' effects) within 1 level too;
  - the primitives behind them: `box_blur2_u8` and `box_blur_f32` equal
    cv2.blur, `resize_cubic_f32` within 2 ulp of cv2.resize;
  - augment_yolo / augment_coco and the CLI: the same files, label files
    and annotation json as JAX's from one seed; each image's canvas (JAX's
    captured where it calls cv2.imwrite) equal to JAX's (rain, snow) or
    within 1 level (fog, flare, shadow), and each file within the JPEG
    bounds of test_torch_port_imwrite.py against cv2's q95 file of it.
"""

import json
import os
import runpy
import sys

import cv2
import numpy as np
import pytest

from yololite_tpu.data import weather as jax_weather

from tests.test_torch_port_imwrite import assert_jpeg_like_cv2
from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data import weather
from yololite_tpu_torch.tools import augment_weather as augment_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(480, 640), (37, 53), (8, 8), (100, 33), (2, 5)]
FOG_SHARE = 1e-3
EXACT = ("rain", "snow")


def image(shape, seed=1):
    return np.random.RandomState(seed).randint(0, 256, shape + (3,)).astype(np.uint8)


@pytest.mark.parametrize("effect", weather.EFFECTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_effect_matches_jax(effect, shape):
    img = image(shape)
    for seed in (0, 5):
        want = jax_weather.apply_weather(img, effect, np.random.RandomState(seed))
        got = weather.apply_weather(img, effect, np.random.RandomState(seed))
        assert got.dtype == np.uint8 and got.shape == want.shape
        if effect in EXACT:
            np.testing.assert_array_equal(got, want)
        else:
            diff = np.abs(got.astype(int) - want)
            assert diff.max() <= 1
            if effect == "fog":
                assert (diff > 0).mean() <= FOG_SHARE


@pytest.mark.parametrize("shape", [(7, 9), (1, 5), (5, 1), (1, 1), (31, 17), (480, 640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3])
def test_blur_2x2_equals_cv2(shape, channels):
    rng = np.random.RandomState(shape[0])
    src = rng.randint(0, 256, shape + ((channels,) if channels == 3 else ())).astype(np.uint8)
    np.testing.assert_array_equal(imgops.box_blur2_u8(src), cv2.blur(src, (2, 2)))


@pytest.mark.parametrize("shape", [(480, 640), (100, 70), (15, 40), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fog_field_primitives_against_cv2(shape):
    h, w = shape
    small = np.random.RandomState(w).rand(max(2, h // 32), max(2, w // 32)).astype(np.float32)
    want = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    got = imgops.resize_cubic_f32(small, w, h)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(1)))
    np.testing.assert_array_equal(imgops.box_blur_f32(want, 31), cv2.blur(want, (31, 31)))


def _dataset(root, n=4, w=64, h=48):
    """A YOLO layout of PNG images with labels (one image without a label,
    one damaged file, one file that is not an image) and its COCO json."""
    img_dir, lbl_dir = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    coco = {"images": [], "annotations": [], "categories": [{"id": 0, "name": "a"}]}
    for i in range(n):
        name = f"{i:03d}.png"
        cv2.imwrite(os.path.join(img_dir, name), image((h, w), seed=i))
        coco["images"].append({"id": i + 1, "file_name": name, "width": w, "height": h})
        if i != 2:
            with open(os.path.join(lbl_dir, f"{i:03d}.txt"), "w") as f:
                f.write(f"0 0.5 0.5 0.{i + 1} 0.25\n")
            coco["annotations"].append({"id": 10 + i, "image_id": i + 1, "category_id": 0,
                                        "bbox": [4, 4, 10 + i, 8], "area": 8 * (10 + i),
                                        "iscrowd": 0})
    with open(os.path.join(img_dir, "zz_broken.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xd9")
    with open(os.path.join(img_dir, "notes.txt"), "w") as f:
        f.write("not an image\n")
    coco["images"].append({"id": 99, "file_name": "zz_broken.jpg", "width": w, "height": h})
    ann = os.path.join(root, "annotations.json")
    with open(ann, "w") as f:
        json.dump(coco, f)
    return img_dir, lbl_dir, ann


@pytest.fixture
def jax_canvases(monkeypatch):
    """The arrays JAX's weather module hands cv2.imwrite, by file name."""
    seen = {}

    class Cv2:
        def __getattr__(self, name):
            return getattr(cv2, name)

        @staticmethod
        def imwrite(path, img):
            seen[os.path.basename(path)] = img.copy()
            return cv2.imwrite(path, img)
    monkeypatch.setattr(jax_weather, "cv2", Cv2())
    return seen


def _compare_outputs(port_dir, jax_dir, canvases, tmp_path, got_canvases):
    names = sorted(os.listdir(os.path.join(jax_dir, "images")))
    assert sorted(os.listdir(os.path.join(port_dir, "images"))) == names
    assert len(names) > 0 and set(names) == set(canvases) == set(got_canvases)
    for name in names:
        effect = name.rsplit("_", 1)[1][:-5]
        diff = np.abs(got_canvases[name].astype(int) - canvases[name])
        assert diff.max() <= (0 if effect in EXACT else 1), name
        assert_jpeg_like_cv2(os.path.join(port_dir, "images", name), got_canvases[name],
                             tmp_path)


@pytest.fixture
def port_canvases(monkeypatch):
    """The arrays the port's weather module writes, by file name."""
    seen = {}
    write = weather.imwrite_bgr

    def capture(path, img):
        seen[os.path.basename(path)] = img.copy()
        write(path, img)
    monkeypatch.setattr(weather, "imwrite_bgr", capture)
    return seen


@pytest.mark.parametrize("effects", [None, ["rain", "snow", "fog"]], ids=["all", "three"])
def test_augment_yolo_matches_jax(tmp_path, jax_canvases, port_canvases, effects):
    img_dir, lbl_dir, _ = _dataset(str(tmp_path / "ds"))
    n_jax = jax_weather.augment_yolo(img_dir, lbl_dir, str(tmp_path / "jax"), effects, 3, 7)
    n = weather.augment_yolo(img_dir, lbl_dir, str(tmp_path / "port"), effects, 3, 7)
    assert n == n_jax == 12
    _compare_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), jax_canvases, tmp_path,
                     port_canvases)
    labels = sorted(os.listdir(tmp_path / "jax" / "labels"))
    assert sorted(os.listdir(tmp_path / "port" / "labels")) == labels and len(labels) == 9
    for name in labels:
        assert (tmp_path / "port" / "labels" / name).read_text() == \
            (tmp_path / "jax" / "labels" / name).read_text()


def test_augment_coco_matches_jax(tmp_path, jax_canvases, port_canvases):
    img_dir, _, ann = _dataset(str(tmp_path / "ds"))
    n_jax = jax_weather.augment_coco(img_dir, ann, str(tmp_path / "jax"), None, 2, 3)
    n = weather.augment_coco(img_dir, ann, str(tmp_path / "port"), None, 2, 3)
    assert n == n_jax == 8
    _compare_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), jax_canvases, tmp_path,
                     port_canvases)
    with open(tmp_path / "jax" / "annotations.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "annotations.json") as f:
        got = json.load(f)
    assert got == want and len(got["images"]) == 5 + 8


@pytest.mark.parametrize("layout", ["yolo", "coco"])
def test_cli_matches_jax(tmp_path, monkeypatch, capsys, jax_canvases, port_canvases, layout):
    img_dir, lbl_dir, ann = _dataset(str(tmp_path / "ds"), n=2)
    argv = ["--images", img_dir, "--effects", "rain", "fog", "--per_image", "2", "--seed",
            "11"] + (["--coco_json", ann] if layout == "coco" else [])
    monkeypatch.setattr(sys, "argv", ["tools/augment_weather.py", *argv, "--out",
                                      str(tmp_path / "jax")])
    runpy.run_path(os.path.join(ROOT, "tools", "augment_weather.py"), run_name="__main__")
    want_out = capsys.readouterr().out
    n = augment_tool.main(argv + ["--out", str(tmp_path / "port")])
    got_out = capsys.readouterr().out
    assert n == 4
    assert got_out == want_out.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    _compare_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), jax_canvases, tmp_path,
                     port_canvases)
    if layout == "yolo":        # --labels defaults to the images' sibling labels/
        assert sorted(os.listdir(tmp_path / "port" / "labels")) == \
            sorted(os.listdir(tmp_path / "jax" / "labels"))
