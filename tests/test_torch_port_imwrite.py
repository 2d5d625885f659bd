"""The port's image writers (`yololite_tpu_torch/data/imwrite.py`) against
the installed cv2 (OpenCV 5.0, libjpeg-turbo).

  - PNG and BMP: `cv2.imread` and the port's decoder give back exactly the
    array written, odd sizes included;
  - JPEG (baseline 4:2:0, quality 95, cv2.imwrite's default): the file
    decodes with cv2.imread and the port's decoder to the same pixels; its
    PSNR against the canvas is within JPEG_PSNR_DB of cv2.imwrite's own
    file of the same canvas, and its size within JPEG_SIZE_REL of it (the
    encoder's float DCT against libjpeg's integer one, and its chroma
    averaging, move both a little);
  - the Motion-JPEG AVI writer: cv2.VideoCapture reads every frame back
    (OpenCV's own MJPEG reader: each frame equal to the decoded JPEG) at
    the rate written.
"""

import os

import cv2
import numpy as np
import pytest

from yololite_tpu_torch.data import imwrite
from yololite_tpu_torch.data.codecs import imread_bgr

JPEG_PSNR_DB = 0.5
JPEG_SIZE_REL = 0.10
SHAPES = [(1, 1), (7, 5), (37, 53), (64, 64), (120, 161)]


def canvas(h, w, seed=0):
    """A frame-like BGR image: a gradient with noise and flat boxes with
    drawn text, so that every frequency band carries energy."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 127 / max(h + w - 2, 1)], -1)
    img = np.clip(img + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)
    for _ in range(3):
        x1, y1 = rng.randint(0, w), rng.randint(0, h)
        img[y1:y1 + rng.randint(1, h + 1), x1:x1 + rng.randint(1, w + 1)] = rng.randint(
            0, 256, 3)
    cv2.putText(img, "c1:0.93", (w // 8, h // 2), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (255, 255, 255), 1)
    return img


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def assert_jpeg_like_cv2(path: str, img_bgr: np.ndarray, tmp_path) -> None:
    """The port's JPEG file at `path` against cv2.imwrite's q95 file of the
    same BGR canvas: decodes alike in cv2 and the port, PSNR within
    JPEG_PSNR_DB, size within JPEG_SIZE_REL."""
    got = cv2.imread(path)
    np.testing.assert_array_equal(imread_bgr(path), got)
    ref_path = str(tmp_path / "cv2_q95.jpg")
    assert cv2.imwrite(ref_path, img_bgr)
    want = cv2.imread(ref_path)
    assert got.shape == want.shape == img_bgr.shape
    assert abs(psnr(got, img_bgr) - psnr(want, img_bgr)) <= JPEG_PSNR_DB
    size, ref = os.path.getsize(path), os.path.getsize(ref_path)
    assert abs(size - ref) <= JPEG_SIZE_REL * ref, (size, ref)


@pytest.mark.parametrize("ext", [".png", ".bmp"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_and_bmp_round_trip_exactly(tmp_path, ext, shape):
    img = canvas(*shape, seed=shape[0])
    path = str(tmp_path / f"x{ext}")
    imwrite.imwrite_bgr(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    np.testing.assert_array_equal(imread_bgr(path), img)


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".JPG"])
@pytest.mark.parametrize("shape", [(7, 5), (37, 53), (64, 64), (120, 161), (480, 640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_within_cv2_q95(tmp_path, ext, shape):
    img = canvas(*shape, seed=shape[1])
    path = str(tmp_path / f"x{ext}")
    imwrite.imwrite_bgr(path, img)
    assert_jpeg_like_cv2(path, img, tmp_path)


@pytest.mark.parametrize("name", ["x.jp2", "x.gif", "x.webp", "noext"])
def test_other_extensions_raise_naming_them(tmp_path, name):
    ext = os.path.splitext(name)[1]
    with pytest.raises(ValueError, match=repr(ext) if ext else "without an extension"):
        imwrite.imwrite_bgr(str(tmp_path / name), canvas(8, 8))
    assert not (tmp_path / name).exists()


@pytest.mark.parametrize("img", [np.zeros((8, 8), np.uint8), np.zeros((8, 8, 4), np.uint8),
                                 np.zeros((8, 8, 3), np.float32)],
                         ids=["gray", "bgra", "float32"])
def test_only_bgr_uint8_is_written(tmp_path, img):
    with pytest.raises(ValueError, match="BGR uint8"):
        imwrite.imwrite_bgr(str(tmp_path / "x.png"), img)


def test_avi_reads_back_in_cv2(tmp_path):
    frames = [canvas(48, 64, seed=k) for k in range(5)]
    path = str(tmp_path / "clip.avi")
    writer = imwrite.AviWriter(path, 25.0, (64, 48))
    for f in frames:
        writer.write(f)
    writer.close()
    cap = cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FPS) == 25.0
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 5
    got = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        got.append(f)
    assert len(got) == 5
    for g, f in zip(got, frames):
        want = cv2.imdecode(np.frombuffer(imwrite.encode_jpeg(f[..., ::-1]), np.uint8), 1)
        np.testing.assert_array_equal(g, want)
    ff = cv2.VideoCapture(path, cv2.CAP_FFMPEG)   # the default reader opens it too
    assert ff.isOpened() and ff.read()[0]
    with pytest.raises(ValueError, match="differs"):
        imwrite.AviWriter(str(tmp_path / "x.avi"), 25.0, (64, 48)).write(canvas(10, 10))
