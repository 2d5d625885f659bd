"""The port's host image codecs (`data/codecs.py`, `csrc/imgcodec.cpp`)
against `cv2.imread`, and the data pipeline on JPEG splits against the JAX
package (CPU; the codec is built here with the host C++ compiler).

Every pixel comparison with cv2 is exact (`assert_array_equal`): the codec
reproduces libjpeg-turbo's integer arithmetic, OpenCV's BMP reader and
libpng's sample conversion, so there is no tolerance to state. Where cv2
gives None the port raises ValueError. Dataset samples on a JPEG split:
`load_image` and unaugmented `get` exact; augmented `get` within the
tolerance that tests/test_torch_port_data.py states for square samples (1
level: the warps), for the reason given there.
"""

import hashlib
import itertools
import json
import os
import shutil
import struct
import threading
import zlib

import cv2
import numpy as np
import pytest

from yololite_tpu.data.dataset import YoloDataset as JaxYoloDataset

from chip_smoke import make_seg_set, make_synth_set, write_jpeg
from codec_fixtures import DIR as FIXTURE_DIR
from codec_fixtures import fixture_image, manifest, palette_png, with_exif_orientation
from test_torch_port_data import _assert_sample, _same_rng
from test_torch_port_seg_data import _assert_seg_sample
from yololite_tpu_torch.csrc import build as kbuild
from yololite_tpu_torch.data import codecs
from yololite_tpu_torch.data.codecs import UnsupportedImage, decode_jpeg, imread_bgr
from yololite_tpu_torch.data.dataset import YoloDataset

SAMPLING = {s: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{s}")
            for s in ("444", "422", "420", "411", "440")}
SIZES = ((1, 1), (8, 8), (17, 33), (35, 67), (67, 35))


def _same_as_cv2(path):
    """The port's read of `path` equals cv2.imread's, or both fail (None in
    cv2, ValueError in the port)."""
    want = cv2.imread(path)
    if want is None:
        with pytest.raises(ValueError) as e:
            imread_bgr(path)
        assert not isinstance(e.value, UnsupportedImage)
        return None
    got = imread_bgr(path)
    np.testing.assert_array_equal(got, want, err_msg=os.path.basename(path))
    return got


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# --------------------------------------------------------------------------- #
# JPEG
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("quality,sampling,progressive",
                         list(itertools.product((5, 50, 75, 95, 100), SAMPLING, (0, 1))))
def test_jpeg_grid_equals_cv2(tmp_path, quality, sampling, progressive):
    for h, w in SIZES:
        img = fixture_image(h, w, seed=quality + h)
        path = str(tmp_path / f"{h}x{w}.jpg")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                       cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
        assert _same_as_cv2(path) is not None


JPEG_CASES = {
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "optimized_progressive": [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "restart_1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
    "restart_7": [cv2.IMWRITE_JPEG_RST_INTERVAL, 7],
    "restart_1_progressive": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "restart_7_progressive": [cv2.IMWRITE_JPEG_RST_INTERVAL, 7, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "luma_chroma_apart": [cv2.IMWRITE_JPEG_LUMA_QUALITY, 90, cv2.IMWRITE_JPEG_CHROMA_QUALITY, 15],
    "luma_chroma_apart_444": [cv2.IMWRITE_JPEG_LUMA_QUALITY, 20, cv2.IMWRITE_JPEG_CHROMA_QUALITY,
                              95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]],
    "gray": None,
    "gray_progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_cases_equal_cv2(tmp_path, case):
    params = JPEG_CASES[case] or []
    for h, w in ((35, 67), (67, 35), (131, 97)):
        img = fixture_image(h, w, seed=h)
        if case.startswith("gray"):
            img = img[..., 0]
        path = str(tmp_path / f"{h}x{w}.jpg")
        assert cv2.imwrite(path, img, params)
        got = _same_as_cv2(path)
        assert got.shape == (h, w, 3)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_equals_cv2(tmp_path, orientation):
    """cv2.imread applies the EXIF orientation of a JPEG's APP1 segment (both
    byte orders) and of a PNG's eXIf chunk: 5-8 swap the sides (37x53 ->
    53x37)."""
    ok, buf = cv2.imencode(".jpg", fixture_image(37, 53, seed=2))
    for little in (True, False):
        path = _write(tmp_path, f"o{orientation}{little}.jpg",
                      with_exif_orientation(buf.tobytes(), orientation, little))
        got = _same_as_cv2(path)
        assert got.shape == ((53, 37, 3) if orientation >= 5 else (37, 53, 3))
    # a PNG's eXIf chunk (TIFF data, before IDAT) turns it the same way
    png = cv2.imencode(".png", fixture_image(37, 53, seed=2))[1].tobytes()
    tiff = with_exif_orientation(b"\xff\xd8", orientation)[12:]
    at = png.index(b"IDAT") - 4
    got = _same_as_cv2(_write(tmp_path, "o.png", png[:at] + _png_chunk(b"eXIf", tiff) + png[at:]))
    assert got.shape == ((53, 37, 3) if orientation >= 5 else (37, 53, 3))


def test_damaged_jpeg_as_cv2(tmp_path):
    """Truncated at many points (baseline and progressive, with and without
    restarts): cv2 gives None when the headers are cut, else a partial image
    (gray where data ran out, block smoothing on an incomplete progressive
    image), which the port reproduces; garbage and an empty SOI/EOI file give
    None. Also single damaged bytes inside the entropy data."""
    img = fixture_image(35, 67, seed=3)
    nones = partial = 0
    for prog, rst in ((0, 0), (0, 3), (1, 0), (1, 3)):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                             cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                                             cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        data = buf.tobytes()
        for frac in np.linspace(0.05, 0.995, 24):
            got = _same_as_cv2(_write(tmp_path, "t.jpg", data[:int(len(data) * frac)]))
            nones, partial = nones + (got is None), partial + (got is not None)
        rng = np.random.RandomState(prog * 10 + rst)
        for _ in range(6):
            blob = bytearray(data)
            blob[rng.randint(len(data) // 2, len(data) - 2)] = rng.randint(256)
            _same_as_cv2(_write(tmp_path, "f.jpg", bytes(blob)))
    assert nones and partial
    for blob in (b"\xff\xd8\xff\xd9", b"\xff\xd8\xff" + np.random.RandomState(1).bytes(600),
                 np.random.RandomState(0).bytes(600), b""):
        assert _same_as_cv2(_write(tmp_path, "g.jpg", blob)) is None


def _sof_variant(marker: int, precision: int = 8, ncomp: int = 3) -> bytes:
    """A baseline file's headers with its SOF0 replaced."""
    ok, buf = cv2.imencode(".jpg", fixture_image(16, 16))
    data = buf.tobytes()
    i = data.index(b"\xff\xc0")
    length = struct.unpack(">H", data[i + 2:i + 4])[0]
    comps = b"".join(bytes([c + 1, 0x11, 0]) for c in range(ncomp))
    sof = struct.pack(">BBHBHHB", 0xFF, marker, 8 + 3 * ncomp, precision, 16, 16, ncomp) + comps
    return data[:i] + sof + data[i + 2 + length:]


@pytest.mark.parametrize("variant,match", [
    (dict(marker=0xC9), "arithmetic"), (dict(marker=0xCA), "arithmetic"),
    (dict(marker=0xC3), "lossless"), (dict(marker=0xC5), "hierarchical"),
    (dict(marker=0xC1, precision=12), "12-bit"), (dict(marker=0xC0, ncomp=4), "CMYK"),
])
def test_unsupported_jpeg_variants_raise(variant, match):
    with pytest.raises(UnsupportedImage, match=match):
        decode_jpeg(_sof_variant(**variant))


def test_smoke_run_jpeg_writer_is_read_as_cv2_reads_it(tmp_path):
    """chip_smoke.write_jpeg (baseline 4:2:0, standard tables): cv2 and the
    port decode it to the same pixels, close to what was written."""
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:61, 0:83]
    rgb = np.stack([x * 3, y * 4, (x + y) * 2], -1).astype(np.uint8)
    rgb[20:40, 10:50] = (220, 30, 30)
    path = str(tmp_path / "w.jpg")
    write_jpeg(path, rgb)
    got = _same_as_cv2(path)
    assert np.abs(got[..., ::-1].astype(int) - rgb).mean() < 3
    noise = (rng.rand(37, 53, 3) * 255).astype(np.uint8)
    write_jpeg(path, noise, quality=50)
    assert _same_as_cv2(path).shape == (37, 53, 3)


# --------------------------------------------------------------------------- #
# BMP and PNG
# --------------------------------------------------------------------------- #
def _bmp(pixels: bytes, w: int, h: int, bpp: int, top_down=False, compression=0,
         palette=b"", header=40, masks=b""):
    """A BMP with a BITMAPINFOHEADER (or a longer one), rows padded to 4."""
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bpp, compression,
                       len(pixels), 2835, 2835, len(palette) // 4, 0)
    info += b"\x00" * (header - 40) + masks
    off = 14 + len(info) + len(palette)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + palette + pixels


def _rows(arr: np.ndarray, top_down: bool) -> bytes:
    rows = [arr[y].tobytes() for y in (range(len(arr)) if top_down else range(len(arr))[::-1])]
    return b"".join(r + b"\x00" * (-len(r) % 4) for r in rows)


def test_bmp_equals_cv2(tmp_path):
    img = fixture_image(13, 7, seed=1)
    for name, params, src in (("24", [], img), ("8", [], img[..., 1]),
                              ("32_bitfields", [cv2.IMWRITE_BMP_COMPRESSION,
                                                cv2.IMWRITE_BMP_COMPRESSION_BITFIELDS],
                               np.dstack([img, img[..., :1]]))):
        path = str(tmp_path / f"{name}.bmp")
        assert cv2.imwrite(path, src, params)
        _same_as_cv2(path)
    bgra = np.dstack([img, np.full(img.shape[:2], 7, np.uint8)])
    rng = np.random.RandomState(2)
    pal = rng.randint(0, 256, 1024).astype(np.uint8).tobytes()
    idx = rng.randint(0, 256, (9, 11)).astype(np.uint8)
    for name, blob in (
            ("top_down_24", _bmp(_rows(img, True), 7, 13, 24, top_down=True)),
            ("bottom_up_24", _bmp(_rows(img, False), 7, 13, 24)),
            ("32_rgb", _bmp(_rows(bgra, False), 7, 13, 32)),
            ("32_bitfields_masks_ignored", _bmp(_rows(bgra, True), 7, 13, 32, True, 3,
                                                masks=struct.pack("<III", 0xFF, 0xFF00, 0xFF0000))),
            ("v5_header", _bmp(_rows(bgra, False), 7, 13, 32, compression=3, header=124)),
            ("palette", _bmp(_rows(idx, False), 11, 9, 8, palette=pal)),
            ("palette_top_down", _bmp(_rows(idx, True), 11, 9, 8, True, palette=pal)),
            ("palette_short", _bmp(_rows(idx, False), 11, 9, 8, palette=pal[:40]))):
        assert _same_as_cv2(_write(tmp_path, f"{name}.bmp", blob)) is not None, name
    full = _bmp(_rows(img, False), 7, 13, 24)
    for cut in (1, 3, 40, len(full) // 2, len(full) - 20):
        assert _same_as_cv2(_write(tmp_path, "cut.bmp", full[:-cut])) is None


@pytest.mark.parametrize("bpp,compression,match", [
    (1, 0, "1-bit"), (4, 0, "4-bit"), (16, 0, "16-bit"), (16, 3, "16-bit"),
    (8, 1, "RLE"), (4, 2, "RLE")])
def test_unsupported_bmp_variants_raise(bpp, compression, match):
    w, h = 4, 2
    pixels = b"\x00" * (h * (((w * bpp + 7) // 8 + 3) & ~3))
    masks = struct.pack("<III", 0xF800, 0x7E0, 0x1F) if compression == 3 else b""
    blob = _bmp(pixels, w, h, bpp, compression=compression,
                palette=b"\x00" * (4 << bpp) if bpp <= 8 else b"", masks=masks)
    with pytest.raises(UnsupportedImage, match=match):
        codecs.decode_bmp(blob)


def _png_chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png(raw: bytes, w, h, depth, ctype, interlace=0, extra=b""):
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                                   ctype, 0, 0, interlace))
            + extra + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


def _adam7(img: np.ndarray) -> bytes:
    """Adam7 passes of an 8-bit image, each row with filter Sub or None."""
    out = []
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        ch = 1 if sub.ndim == 2 else sub.shape[2]
        for r, row in enumerate(sub.reshape(sub.shape[0], -1).astype(np.int16)):
            if r % 2:
                left = np.concatenate([np.zeros(ch, np.int16), row[:-ch]])
                out.append(b"\x01" + ((row - left) & 255).astype(np.uint8).tobytes())
            else:
                out.append(b"\x00" + row.astype(np.uint8).tobytes())
    return b"".join(out)


def test_png_variants_equal_cv2(tmp_path):
    """Palette (1-8 bits, with and without tRNS), gray of 1-16 bits, 16-bit
    RGB and RGBA (cv2 keeps the high byte), gray+alpha at 8 and 16 bits and
    Adam7 interlacing, as cv2.imread reads them."""
    rng = np.random.RandomState(5)
    blobs = {"palette_cv2_fixture": palette_png()}
    w, h = 13, 5
    for depth in (1, 2, 4, 8):
        raw = b"".join(b"\x00" + rng.randint(0, 256, (w * depth + 7) // 8).astype(np.uint8)
                       .tobytes() for _ in range(h))
        plte = _png_chunk(b"PLTE", rng.randint(0, 256, 3 << depth).astype(np.uint8).tobytes())
        blobs[f"palette{depth}"] = _png(raw, w, h, depth, 3, extra=plte)
        blobs[f"palette{depth}_trns"] = _png(raw, w, h, depth, 3,
                                             extra=plte + _png_chunk(b"tRNS", b"\x10\x80"))
        blobs[f"gray{depth}"] = _png(raw, w, h, depth, 0)
    a16 = rng.randint(0, 65536, (6, 7, 3)).astype(np.uint16)
    for name, arr in (("rgb16", a16), ("gray16", a16[..., 0]),
                      ("rgba16", np.dstack([a16, a16[..., :1]]))):
        blobs[name] = cv2.imencode(".png", arr)[1].tobytes()
    ga = rng.randint(0, 256, (6, 7, 4)).astype(np.uint8)
    blobs["gray_alpha8"] = _png(b"".join(b"\x00" + ga[y, :, :2].tobytes() for y in range(6)),
                                7, 6, 8, 4)
    blobs["gray_alpha16"] = _png(b"".join(b"\x02" + ga[y].tobytes() for y in range(6)),
                                 7, 6, 16, 4)
    for hh, ww in ((1, 1), (5, 3), (17, 13), (9, 33)):
        x = rng.randint(0, 256, (hh, ww, 3)).astype(np.uint8)
        blobs[f"adam7_rgb_{hh}x{ww}"] = _png(_adam7(x), ww, hh, 8, 2, interlace=1)
        blobs[f"adam7_gray_{hh}x{ww}"] = _png(_adam7(x[..., 0]), ww, hh, 8, 0, interlace=1)
    for name, blob in blobs.items():
        assert _same_as_cv2(_write(tmp_path, f"{name}.png", blob)) is not None, name
    good = cv2.imencode(".png", fixture_image(9, 11))[1].tobytes()
    crc = bytearray(good)
    crc[40] ^= 1                                  # inside IDAT: a CRC error
    for blob in (good[:-1], good[:-20], good[:len(good) // 2], bytes(crc)):
        assert _same_as_cv2(_write(tmp_path, "bad.png", blob)) is None


@pytest.mark.parametrize("w,h", [(1_000_001, 1), (1, 1_000_001), (40_000, 40_000)])
def test_png_larger_than_cv2_reads_raises_before_allocating(tmp_path, w, h):
    """A side over libpng's 10^6 (cv2 gives None) or more than 2^30 pixels
    (cv2's size assertion) raises ValueError from the header, as the JPEG
    and BMP readers do, before any buffer of that size is made."""
    blob = _png(b"\x00" * 64, w, h, 8, 2)
    path = _write(tmp_path, "big.png", blob)
    if w * h > 1 << 30:
        with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE_PIXELS"):
            cv2.imread(path)
    else:
        assert cv2.imread(path) is None
    with pytest.raises(ValueError, match="out of range"):
        imread_bgr(path)


def test_other_formats_raise_unsupported_or_fail_as_cv2(tmp_path):
    path = str(tmp_path / "a.tif")
    assert cv2.imwrite(path, fixture_image(8, 8))
    with pytest.raises(UnsupportedImage, match="TIFF"):
        imread_bgr(path)
    with pytest.raises(ValueError):
        imread_bgr(str(tmp_path / "missing.jpg"))


# --------------------------------------------------------------------------- #
# Fixtures, threads, the build
# --------------------------------------------------------------------------- #
def test_fixture_manifest_is_cv2s_and_the_port_matches_it():
    """The committed manifest is what cv2.imread gives for the committed
    files (regenerated here); the port's decode of each has that SHA-256."""
    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        committed = json.load(f)
    assert committed == manifest()
    assert len(committed) >= 12
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n)) for n in os.listdir(FIXTURE_DIR))
    assert total <= 256 * 1024
    for name, entry in committed.items():
        got = imread_bgr(os.path.join(FIXTURE_DIR, name))
        assert list(got.shape) == entry["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], name


def test_threads_decode_the_same_pixels():
    """The decoders hold no shared state: 8 threads give the serial result."""
    names = sorted(n for n in os.listdir(FIXTURE_DIR) if n != "manifest.json")
    paths = [os.path.join(FIXTURE_DIR, n) for n in names] * 4
    serial = [imread_bgr(p) for p in paths]
    out = [None] * len(paths)

    def work(k):
        for i in range(k, len(paths), 8):
            out[i] = imread_bgr(paths[i])
    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(serial, out):
        np.testing.assert_array_equal(a, b)


def _no_codec_library(tmp_path, monkeypatch):
    """An empty build cache, no codec loaded, and no compiler to be found."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(kbuild, "_LIBS", {})
    monkeypatch.setattr(codecs, "_LIB", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", str(tmp_path))


def test_no_compiler_raises_naming_it(tmp_path, monkeypatch):
    """No fallback: without a host compiler the first read raises and names
    the compiler; nothing decodes the pixels another way."""
    _no_codec_library(tmp_path, monkeypatch)
    with pytest.raises(kbuild.BuildError, match="compiler"):
        imread_bgr(os.path.join(FIXTURE_DIR, "baseline_420.jpg"))


def test_a_built_library_that_does_not_load_raises(tmp_path, monkeypatch):
    """A library in the cache that this machine cannot load (built on
    another host, say) raises BuildError naming it, not a damaged-file
    ValueError or OSError."""
    _no_codec_library(tmp_path, monkeypatch)
    path = kbuild.library_path("imgcodec")
    path.parent.mkdir(parents=True)
    path.write_bytes(b"not a shared library")
    with pytest.raises(kbuild.BuildError, match="does not load"):
        imread_bgr(os.path.join(FIXTURE_DIR, "baseline_420.jpg"))


@pytest.mark.parametrize("task", ["detect", "segment"])
def test_a_dataset_without_a_compiler_raises_and_never_goes_black(jpeg_set, tmp_path,
                                                                  monkeypatch, task):
    """A damaged file becomes a black sample, a missing toolchain does not:
    the constructor of a JPEG split raises naming the compiler, and so does
    a sample of a split made before the compiler went away."""
    imgs, labels = _split(jpeg_set)
    kw = dict(img_size=64, is_train=True, augment=False, max_boxes=16, task=task)
    ds = YoloDataset(imgs, labels, **kw)
    _no_codec_library(tmp_path, monkeypatch)
    with pytest.raises(kbuild.BuildError, match="compiler"):
        YoloDataset(imgs, labels, **kw)
    with pytest.raises(kbuild.BuildError, match="compiler"):
        ds.get(0, np.random.RandomState(0))


def test_host_library_is_built_from_the_source_under_its_hash():
    codecs.library()
    path = kbuild.library_path("imgcodec")
    assert path.exists() and path.parent == kbuild.BUILD_DIR
    assert path.name.startswith("imgcodec-")


# --------------------------------------------------------------------------- #
# The data pipeline on JPEG splits, against the JAX package
# --------------------------------------------------------------------------- #
def _jpeg_copy(src_root: str, dst_root: str) -> None:
    """Every image of a set re-encoded by cv2.imwrite as .jpg (q 90), labels
    copied."""
    for split in ("train", "valid"):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(dst_root, split, sub), exist_ok=True)
        for name in sorted(os.listdir(os.path.join(src_root, split, "images"))):
            img = cv2.imread(os.path.join(src_root, split, "images", name))
            stem = os.path.splitext(name)[0]
            cv2.imwrite(os.path.join(dst_root, split, "images", stem + ".jpg"), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
            shutil.copy(os.path.join(src_root, split, "labels", stem + ".txt"),
                        os.path.join(dst_root, split, "labels", stem + ".txt"))


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpegset")
    make_synth_set(str(root / "png"), n_train=8, n_val=2, w=64, h=64)
    _jpeg_copy(str(root / "png"), str(root / "jpg"))
    return str(root / "jpg")


def _split(root, split="train"):
    return os.path.join(root, split, "images"), os.path.join(root, split, "labels")


def test_jpeg_dataset_samples_match_jax(jpeg_set):
    """64x64 images at img_size 64 (no resize): load_image and get without
    augmentation exactly; get with the recipe's augmentation (mosaic and
    cutmix on some draws) within 1 level, as the data tests hold square
    PNG samples, the RandomState left in the same state."""
    imgs, labels = _split(jpeg_set)
    plain = dict(img_size=64, is_train=True, augment=False, max_boxes=16)
    jds, pds = JaxYoloDataset(imgs, labels, **plain), YoloDataset(imgs, labels, **plain)
    for i in range(len(pds)):
        np.testing.assert_array_equal(pds.load_image(i), jds.load_image(i))
        j, p = jds.get(i, np.random.RandomState(i)), pds.get(i, np.random.RandomState(i))
        _assert_sample(p, j, 0, 0.0)
    for kw in ({}, dict(mosaic_p=0.5, cutmix_p=0.5)):
        args = dict(img_size=64, is_train=True, augment=True, max_boxes=24, **kw)
        jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)
        for seed in range(6):
            rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
            j, p = jds.get(seed % len(jds), rj), pds.get(seed % len(pds), rp)
            _same_rng(rj, rp)
            _assert_sample(p, j, 1, 0.0)


def test_jpeg_seg_dataset_samples_match_jax(tmp_path):
    """The segmentation dataset on a JPEG copy of a 64x64 polygon set:
    validation samples (masks and RLEs) exact, as on PNG."""
    make_seg_set(str(tmp_path / "png"), n_train=4, n_val=2, w=64, h=64)
    _jpeg_copy(str(tmp_path / "png"), str(tmp_path / "jpg"))
    imgs, labels = _split(str(tmp_path / "jpg"), "valid")
    kw = dict(img_size=64, is_train=False, augment=False, max_boxes=8, task="segment")
    jds, pds = JaxYoloDataset(imgs, labels, **kw), YoloDataset(imgs, labels, **kw)
    for i in range(len(pds)):
        _assert_seg_sample(pds.get(i), jds.get(i), 0, 0.0)


def test_coco_json_set_of_jpegs_trains(tmp_path):
    """A COCO-json set whose file_names are JPEGs: converted labels, samples
    equal to JAX's (within the letterbox's 1 level, 80x60 -> 64), and one
    epoch through YoloLite.train."""
    from test_torch_port_coco_ingest import make_coco_set
    from yololite_tpu_torch.api import YoloLite
    from yololite_tpu_torch.config import load_configs

    data = make_coco_set(str(tmp_path), n=6)
    for split in ("train", "val"):
        img_dir = tmp_path / "images" / split
        for png in sorted(img_dir.glob("*.png")):
            cv2.imwrite(str(png.with_suffix(".jpg")), cv2.imread(str(png)))
            png.unlink()
        ann = tmp_path / "annotations" / f"instances_{split}.json"
        coco = json.loads(ann.read_text())
        for im in coco["images"]:
            im["file_name"] = im["file_name"].replace(".png", ".jpg")
        ann.write_text(json.dumps(coco))
    ds = load_configs(None, None, data, make_run_dir=False)["dataset"]
    kw = dict(img_size=64, is_train=False, augment=False, max_boxes=8)
    pds = YoloDataset(ds["train_images"], ds["train_labels"], **kw)
    jds = JaxYoloDataset(ds["train_images"], ds["train_labels"], **kw)
    assert pds.img_files[0].endswith(".jpg")
    for i in range(len(pds)):
        _assert_sample(pds.get(i), jds.get(i), 1, 0.0)
    res = YoloLite("edge_n", device="cpu").train(
        data=data, epochs=1, batch_size=4, img_size=64, run_dir=str(tmp_path / "runs"),
        workers=2, amp=False)
    assert np.isfinite(res["history"]["step_loss"]).all()
