"""TIFF, WebP and CMYK JPEG decoding (`data/codecs.py`, `csrc/imgcodec.cpp`,
`csrc/webpcodec.cpp`) against `cv2.imread` (OpenCV 5.0 with libtiff 4.7
and libwebp here), and the readers built on them against the JAX package
(CPU; the codecs are built here with the host C++ compiler).

Every pixel comparison with cv2 is exact (`assert_array_equal`): the TIFF
decoder reproduces libtiff's RGBA conversions, the WebP decoder libwebp's
integer arithmetic, so there is no tolerance to state. Where cv2 gives None
the port raises ValueError (never UnsupportedImage); a variant the port
leaves out raises UnsupportedImage naming it. Dataset samples on a TIFF
split: unaugmented `get` exact; augmented `get` within the 1 level that
tests/test_torch_port_data.py states for square samples (the warps), the
RandomState left in the same state. The pretraining reader's batches within
the 1 level of tests/test_torch_port_pretrain.py (cv2.resize's bilinear).
"""

import importlib.util
import io
import itertools
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from yololite_tpu.data.dataset import YoloDataset as JaxYoloDataset
from yololite_tpu.data import weather as jax_weather

from chip_smoke import make_synth_set
from codec_fixtures import (assemble_tiff, encode_webp, fixture_image, libwebp, lzw_encode,
                            pil_bytes, write_tiff, ycbcr_jpeg_tiff)
from test_torch_port_data import _assert_sample, _same_rng
from tests.test_torch_port_weather import (  # noqa: F401  (fixtures)
    _compare_outputs, jax_canvases, port_canvases)
from yololite_tpu_torch.data import codecs, imwrite, weather
from yololite_tpu_torch.data.codecs import UnsupportedImage, imread_bgr
from yololite_tpu_torch.data.dataset import YoloDataset
from yololite_tpu_torch.tools import pretrain_backbone as pb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 21, 35
RNG = np.random.RandomState(11)
RGB8 = RNG.randint(0, 256, (H, W, 3)).astype(np.uint8)
RGB16 = RNG.randint(0, 65536, (H, W, 3)).astype(np.uint16)
NO_LIBWEBP = libwebp() is None


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _same_as_cv2(tmp_path, data, name="x.tif"):
    """The port's read equals cv2.imread's; both fail where cv2 gives None
    (ValueError in the port, not UnsupportedImage). Returns cv2's image."""
    path = _write(tmp_path, name, data)
    want = cv2.imread(path)
    if want is None:
        with pytest.raises(ValueError) as e:
            imread_bgr(path)
        assert not isinstance(e.value, UnsupportedImage), e.value
        return None
    np.testing.assert_array_equal(imread_bgr(path), want, err_msg=name)
    return want


def _none_in_cv2(tmp_path, data, name="x.tif"):
    path = _write(tmp_path, name, data)
    assert cv2.imread(path) is None
    with pytest.raises(ValueError) as e:
        imread_bgr(path)
    assert not isinstance(e.value, UnsupportedImage), e.value


def _left_out(tmp_path, data, match, name="x.tif"):
    """cv2 reads the file; the port names the variant it leaves out."""
    path = _write(tmp_path, name, data)
    assert cv2.imread(path) is not None
    with pytest.raises(UnsupportedImage, match=match):
        imread_bgr(path)


# --------------------------------------------------------------------------- #
# TIFF
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compression,predictor,planar",
                         list(itertools.product((1, 5, 8, 32773, 32946), (1, 2), (1, 2))))
def test_tiff_layout_grid_equals_cv2(tmp_path, compression, predictor, planar):
    """8 and 16-bit RGB in both byte orders, classic and BigTIFF, strips and
    tiles (an edge tile part empty). Predictor 2 is read by LZW and Deflate
    and ignored by the raw and PackBits codecs, as libtiff ignores it."""
    for (bps, img), order, big, tile in itertools.product(
            ((8, RGB8), (16, RGB16)), "<>", (False, True), (None, (16, 16))):
        data = write_tiff(img, bps=bps, compression=compression, predictor=predictor,
                          planar=planar, order=order, bigtiff=big, tile=tile,
                          rows_per_strip=None if tile else 4)
        assert _same_as_cv2(tmp_path, data) is not None


def _gray(bps, seed):
    v = np.random.RandomState(seed).randint(0, 1 << bps, (H, W))
    return v.astype(np.uint16 if bps > 8 else np.uint8)


def _reverse(data: bytes) -> bytes:
    return data.translate(bytes(int(f"{i:08b}"[::-1], 2) for i in range(256)))


def _damage(chunks, how):
    """The second chunk cut to half its bytes or with a byte flipped."""
    chunks = list(chunks)
    b = chunks[1]
    chunks[1] = b[:len(b) // 2] if how == "cut" else (
        b[:len(b) // 2] + bytes([b[len(b) // 2] ^ 0xA5]) + b[len(b) // 2 + 1:])
    return chunks


def _patch_entry(data: bytes, tag: int, index: int, value: int) -> bytes:
    """A little-endian classic TIFF with value `index` of LONG array `tag`
    (held outside its directory entry) replaced."""
    out = bytearray(data)
    ifd = struct.unpack("<I", out[4:8])[0]
    for e in range(struct.unpack("<H", out[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * e
        if struct.unpack("<H", out[at:at + 2])[0] == tag:
            where = struct.unpack("<I", out[at + 8:at + 12])[0]
            struct.pack_into("<I", out, where + 4 * index, value)
            return bytes(out)
    raise KeyError(tag)


def _cmap(bits, big, seed):
    return (3, [int(v) for v in np.random.RandomState(seed).randint(0, 65536 if big else 256,
                                                                       3 << bits)])


TIFF_CASES = {
    **{f"gray{b}_ph{ph}_c{c}_p{p}": (lambda b=b, ph=ph, c=c, p=p: write_tiff(
        _gray(b, b), bps=b, photometric=ph, compression=c, predictor=p, rows_per_strip=5))
       for b in (1, 8, 16) for ph in (0, 1) for c in (1, 5, 32773) for p in (1, 2)
       if not (b == 1 and p == 2)},
    **{f"gray_alpha{b}_es{es}": (lambda b=b, es=es: write_tiff(
        np.dstack([_gray(b, 1), _gray(b, 2)]), bps=b, photometric=1, compression=5,
        predictor=2, extra={338: (3, [es])}))
       for b in (8, 16) for es in (0, 1, 2)},
    "gray_three_samples": lambda: write_tiff(RGB8, photometric=1),
    **{f"rgba{b}_es{es}_p{p}_pl{pl}": (lambda b=b, es=es, p=p, pl=pl: write_tiff(
        np.dstack([RGB16 if b == 16 else RGB8, _gray(b, 3)]), bps=b, compression=5,
        predictor=p, planar=pl, extra={} if es is None else {338: (3, [es])}))
       for b in (8, 16) for es in (None, 0, 1, 2) for p in (1, 2) for pl in (1, 2)},
    **{f"palette{b}_cmap{16 if big else 8}": (lambda b=b, big=big: write_tiff(
        _gray(b, 4), bps=b, photometric=3, compression=5, extra={320: _cmap(b, big, 5)}))
       for b in (1, 4, 8) for big in (False, True)},
    **{f"cmyk_pl{pl}_ink{ink}": (lambda pl=pl, ink=ink: write_tiff(
        np.dstack([RGB8, _gray(8, 6)]), photometric=5, planar=pl, compression=8,
        extra={} if ink is None else {332: (3, [ink])}))
       for pl in (1, 2) for ink in (None, 1)},
    **{f"orientation{o}_{'tiles' if t else 'strips'}": (lambda o=o, t=t: write_tiff(
        RGB8, tile=t, rows_per_strip=4, extra={274: (3, [o])}))
       for o in (0, 1, 2, 3, 4, 9) for t in (None, (16, 16), (32, 16))},
    "signed_8bit": lambda: write_tiff(RGB8, extra={339: (3, [2, 2, 2])}),
    "signed_16bit": lambda: write_tiff(RGB16, bps=16, extra={339: (3, [2, 2, 2])}),
    "fillorder2_deflate": lambda: write_tiff(RGB8, compression=8, extra={266: (3, [2])},
                                             chunk_hook=lambda raw: [_reverse(b) for b in raw]),
    "pil_jpeg_rgb": lambda: pil_bytes(Image.fromarray(RGB8), "TIFF", compression="jpeg"),
    "pil_jpeg_ycbcr": lambda: pil_bytes(Image.fromarray(RGB8).convert("YCbCr"), "TIFF",
                                        compression="jpeg"),
    "pil_jpeg_gray": lambda: pil_bytes(Image.fromarray(RGB8[..., 0]), "TIFF",
                                       compression="jpeg"),
    "jpeg_ycbcr_420_strips": lambda: ycbcr_jpeg_tiff(RGB8, 8),
    "pil_multipage": lambda: pil_bytes(Image.fromarray(RGB8), "TIFF", save_all=True,
                                       append_images=[Image.fromarray(255 - RGB8)]),
    **{f"cv2_c{c}_{kind}": (lambda c=c, img=img: cv2.imencode(
        ".tif", img, [cv2.IMWRITE_TIFF_COMPRESSION, c])[1].tobytes())
       for c in (1, 5, 7, 8, 32773, 32946)
       for kind, img in (("bgr", RGB8), ("gray", RGB8[..., 0]), ("bgr16", RGB16))
       if not (c == 7 and kind == "bgr16")},          # cv2 writes no 16-bit JPEG
    "palette_without_colormap": lambda: write_tiff(_gray(8, 8), photometric=3),
    "palette_colormap_too_short": lambda: write_tiff(_gray(8, 8), photometric=3,
                                                     extra={320: (3, [0] * 48)}),
    "fillorder2_not_reversed": lambda: write_tiff(RGB8, compression=8, extra={266: (3, [2])}),
    "cv2_bgra": lambda: cv2.imencode(".tif", np.dstack([RGB8, RGB8[..., :1]]))[1].tobytes(),
}


DAMAGED_STRIPS = {
    f"{how}_c{c}_{bps}bit{o}_p{p}_pl{pl}": (how, c, bps, o, p, pl)
    for how in ("cut", "flip") for c in (1, 5, 8, 32773) for bps in (8, 16) for o in "<>"
    for p in (1, 2) for pl in (1, 2)
    if not (c in (1, 32773) and p == 2) and not (c == 1 and how == "flip")}


@pytest.mark.parametrize("case", sorted(DAMAGED_STRIPS))
def test_tiff_damaged_strip_as_cv2(tmp_path, case):
    """The second of five strips cut short or with a byte flipped: cv2's
    libtiff reads with stop_on_error off, so a strip that fails to decode
    keeps what came before the fault (no predictor, no byte swap), the rest
    zero; uncompressed strips of unequal byte counts are re-estimated as
    libtiff does (and then fail as there)."""
    how, c, bps, order, p, pl = DAMAGED_STRIPS[case]
    _same_as_cv2(tmp_path, write_tiff(RGB16 if bps == 16 else RGB8, bps=bps, compression=c,
                                      predictor=p, planar=pl, order=order, rows_per_strip=5,
                                      chunk_hook=lambda raw: _damage(raw, how)))


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_samples_equal_cv2(tmp_path, case):
    """Gray, gray + alpha, RGB(A) with each ExtraSamples, palettes with 8 and
    16-bit colormaps, CMYK, each orientation cv2 reads, signed samples (read
    as their bits), fill order 2, JPEG (RGB, YCbCr, gray; with JPEGTables or
    whole JFIF strips), the first page of two, and what cv2.imwrite writes."""
    assert _same_as_cv2(tmp_path, TIFF_CASES[case]()) is not None


def test_tiff_conversions_over_all_values(tmp_path):
    """Every 16-bit value through RGB (rounded to 8 bits), unassociated alpha
    (premultiplied) and MinIsWhite gray; every 8-bit pair through CMYK."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    rgb = np.dstack([v, v[::-1], v.T])
    _same_as_cv2(tmp_path, write_tiff(rgb, bps=16, compression=8))
    _same_as_cv2(tmp_path, write_tiff(np.dstack([rgb, v.T[::-1]]), bps=16, compression=8,
                                      extra={338: (3, [2])}))
    _same_as_cv2(tmp_path, write_tiff(v, bps=16, photometric=0, compression=8))
    a, b = np.meshgrid(np.arange(256), np.arange(256))
    _same_as_cv2(tmp_path, write_tiff(np.dstack([a, b, a, b]).astype(np.uint8), photometric=5,
                                      compression=8))


TIFF_NONE = {
    **{f"orientation{o}": (lambda o=o: write_tiff(RGB8, extra={274: (3, [o])}))
       for o in (5, 6, 7, 8)},
    **{f"gray{b}bit": (lambda b=b: write_tiff(_gray(b, 7), bps=b)) for b in (2, 4, 10, 12, 14)},
    "rgb12": lambda: write_tiff(RGB16 >> 4, bps=12),
    "uint32": lambda: write_tiff(RGB8.astype(np.uint32) * 70000, bps=32),
    "float32": lambda: write_tiff(RGB8.astype(np.float32) / 255, bps=32,
                                  extra={339: (3, [3, 3, 3])}),
    "float_format_8bit": lambda: write_tiff(RGB8, extra={339: (3, [3, 3, 3])}),
    "cmyk_inkset2": lambda: write_tiff(np.dstack([RGB8, RGB8[..., :1]]), photometric=5,
                                       extra={332: (3, [2])}),
    "cmyk16": lambda: write_tiff(np.dstack([RGB16, RGB16[..., :1]]), bps=16, photometric=5),
    "cmyk_three_samples": lambda: write_tiff(RGB8, photometric=5),
    "rgb_two_samples": lambda: write_tiff(RGB8[..., :2], photometric=2),
    "rgb_five_samples": lambda: write_tiff(np.dstack([RGB8, RGB8[..., :2]])),
    "rgb_4bit": lambda: write_tiff(RGB8 >> 4, bps=4),
    "bilevel_two_samples": lambda: write_tiff(RGB8[..., :2] & 1, bps=1, photometric=1),
    "predictor3": lambda: write_tiff(RGB8, compression=5, extra={317: (3, [3])}),
    "predictor2_bilevel": lambda: write_tiff(RGB8[..., 0] & 1, bps=1, compression=5,
                                             extra={317: (3, [2])}),
    **{f"compression{c}_not_configured": (lambda c=c: write_tiff(RGB8, extra={259: (3, [c])}))
       for c in (34661, 34887, 34925, 50000, 50001)},
    "palette4_without_colormap": lambda: write_tiff(_gray(4, 8), bps=4, photometric=3),
    "no_photometric": lambda: assemble_tiff(
        {256: (4, [W]), 257: (4, [H]), 258: (3, [8, 8, 8]), 277: (3, [3]), 278: (4, [H])},
        [RGB8.tobytes()]),
    "lzw_directory_cut": lambda: write_tiff(RGB8, compression=5)[:-200],
    "first_strip_outside_the_file": lambda: _patch_entry(
        write_tiff(RGB8, rows_per_strip=5), 273, 0, 10 ** 6),
    "strip_byte_count_zero": lambda: _patch_entry(write_tiff(RGB8, rows_per_strip=5), 279, 2, 0),
    "strip_past_the_end": lambda: write_tiff(RGB8)[:300] + b"\0" * 8,
    "header_only": lambda: b"II*\x00\x08\x00\x00\x00",
    "directory_out_of_file": lambda: b"II*\x00\xff\xff\x00\x00" + b"\0" * 40,
    "zero_width": lambda: write_tiff(RGB8, extra={256: (4, [0])}),
}


@pytest.mark.parametrize("case", sorted(TIFF_NONE))
def test_tiff_none_in_cv2_raises_value_error(tmp_path, case):
    """Orientation 5-8 (a transposed read fails cv2's own check), depths
    and sample formats cv2's reader refuses, codecs its libtiff was built
    without, and damaged or truncated files."""
    _none_in_cv2(tmp_path, TIFF_NONE[case]())


def _ccitt():
    return pil_bytes(Image.fromarray(RGB8[..., 0] > 128), "TIFF", compression="group4")


TIFF_LEFT_OUT = {
    "ccitt_group4": (_ccitt, "CCITT"),
    "ccitt_group3": (lambda: pil_bytes(Image.fromarray(RGB8[..., 0] > 128), "TIFF",
                                       compression="group3"), "CCITT"),
    "ycbcr_lzw": (lambda: pil_bytes(Image.fromarray(RGB8).convert("YCbCr"), "TIFF",
                                    compression="tiff_lzw"), "YCbCr"),
    "jpeg_cmyk": (lambda: pil_bytes(Image.fromarray(np.dstack([RGB8, RGB8[..., :1]]), "CMYK"),
                                    "TIFF", compression="jpeg"), "JPEG TIFF of photometric 5"),
    "jpeg_rgba": (lambda: cv2.imencode(".tif", np.dstack([RGB8, RGB8[..., :1]]),
                                       [cv2.IMWRITE_TIFF_COMPRESSION, 7])[1].tobytes(),
                  "4 samples"),
    "unknown_compression": (lambda: write_tiff(RGB8, extra={259: (3, [99])}), "compression 99"),
    "palette_two_samples": (lambda: write_tiff(
        np.dstack([_gray(8, 9), _gray(8, 9)]), photometric=3,
        extra={320: _cmap(8, True, 9)}), "palette TIFF with 2 samples"),
}


@pytest.mark.parametrize("case", sorted(TIFF_LEFT_OUT))
def test_tiff_left_out_variants_raise_unsupported(tmp_path, case):
    build, match = TIFF_LEFT_OUT[case]
    _left_out(tmp_path, build(), match)


def test_lzw_old_style_is_named(tmp_path):
    data = write_tiff(RGB8, compression=5)
    at = data.index(lzw_encode(RGB8.tobytes())[:4])
    bad = data[:at] + b"\x00\x01" + data[at + 2:]
    with pytest.raises(UnsupportedImage, match="old-style"):
        codecs.decode_tiff(bad)


# --------------------------------------------------------------------------- #
# WebP
# --------------------------------------------------------------------------- #
def _rgb(h, w, seed=0):
    return np.ascontiguousarray(fixture_image(h, w, seed)[..., ::-1])


@pytest.mark.parametrize("quality", [0, 10, 50, 75, 90, 100])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (17, 23), (45, 61), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_webp_lossy_equals_cv2(tmp_path, quality, shape):
    _same_as_cv2(tmp_path, pil_bytes(Image.fromarray(_rgb(*shape, quality)), "WEBP",
                                     quality=quality), "x.webp")


def test_webp_lossy_frame_equals_cv2(tmp_path):
    frame = cv2.imread(os.path.join(ROOT, "tests", "data", "codecs", "progressive_640x480.jpg"))
    for q in (30, 75, 95):
        ok, buf = cv2.imencode(".webp", frame, [cv2.IMWRITE_WEBP_QUALITY, q])
        assert _same_as_cv2(tmp_path, buf.tobytes(), "f.webp").shape == (480, 640, 3)


@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (45, 61), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_webp_lossless_equals_cv2(tmp_path, method, shape):
    """Every transform, the colour cache and meta prefix codes occur over
    these (the encoder picks them by content and method)."""
    img = _rgb(*shape, method)
    _same_as_cv2(tmp_path, pil_bytes(Image.fromarray(img), "WEBP", lossless=True,
                                     method=method), "x.webp")
    few = (img // 64 * 64).astype(np.uint8)                # a palette of <= 64 colours
    _same_as_cv2(tmp_path, pil_bytes(Image.fromarray(few), "WEBP", lossless=True,
                                     method=method), "p.webp")


@pytest.mark.parametrize("kw", [dict(lossless=True), dict(quality=80),
                                dict(quality=20, alpha_quality=30), dict(quality=90, exact=True),
                                dict(lossless=True, exact=True)], ids=str)
def test_webp_alpha_equals_cv2(tmp_path, kw):
    """cv2 reads a file with alpha as BGRA and drops the alpha: the colour
    is the plain decode; the ALPH chunk is decoded all the same."""
    for shape in ((1, 1), (17, 23), (45, 61)):
        a = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
        a[:, :shape[1] // 2] = 255
        rgba = np.dstack([_rgb(*shape), a])
        _same_as_cv2(tmp_path, pil_bytes(Image.fromarray(rgba), "WEBP", **kw), "a.webp")


WEBP_SETTINGS = {
    **{f"filter{t}_strength{s}_sharp{sh}": dict(quality=60, filter_type=t, filter_strength=s,
                                                filter_sharpness=sh)
       for t in (0, 1) for s in (0, 30, 100) for sh in (0, 7)},
    **{f"partitions{p}_segments{s}": dict(quality=45, partitions=p, segments=s,
                                          sns_strength=80)
       for p in (0, 1, 2, 3) for s in (1, 4)},
    "sharp_yuv": dict(quality=80, use_sharp_yuv=1),
    "autofilter_m6": dict(quality=70, method=6, autofilter=1),
    "near_lossless": dict(lossless=1, near_lossless=60),
    **{f"alpha_c{c}_f{f}": dict(quality=70, alpha_compression=c, alpha_filtering=f,
                                alpha_quality=50) for c in (0, 1) for f in (0, 1, 2)},
}


@pytest.mark.skipif(NO_LIBWEBP, reason="PIL's bundled libwebp is not found")
@pytest.mark.parametrize("case", sorted(WEBP_SETTINGS))
def test_webp_encoder_settings_equal_cv2(tmp_path, case):
    """Settings PIL does not expose, through libwebp's advanced API: the
    simple loop filter, sharpness, 1-8 token partitions, segments, raw and
    filtered alpha planes."""
    kw = WEBP_SETTINGS[case]
    img = _rgb(37, 53, 7)
    if "alpha_compression" in kw:
        img = np.dstack([img, np.random.RandomState(2).randint(0, 256, (37, 53), np.uint8)])
    _same_as_cv2(tmp_path, encode_webp(img, **kw), "s.webp")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_webp_exif_orientation_equals_cv2(tmp_path, orientation):
    """cv2.imread applies a WebP's EXIF orientation, all eight."""
    from codec_fixtures import webp_with_exif
    for kw in (dict(lossless=True), dict(quality=70)):
        got = _same_as_cv2(tmp_path, webp_with_exif(_rgb(30, 41), orientation, **kw), "e.webp")
        assert got.shape == ((41, 30, 3) if orientation >= 5 else (30, 41, 3))


def test_webp_damaged_as_cv2(tmp_path):
    img = _rgb(30, 41)
    for kw in (dict(quality=70), dict(lossless=True)):
        data = pil_bytes(Image.fromarray(img), "WEBP", **kw)
        for cut in (20, 31, 40, len(data) // 2, len(data) - 3, len(data) - 1):
            _none_in_cv2(tmp_path, data[:cut], "t.webp")
        for pos in (30, 60, len(data) // 2):
            bad = bytearray(data)
            bad[pos] ^= 0x55
            _same_as_cv2(tmp_path, bytes(bad), "f.webp")
    _none_in_cv2(tmp_path, b"RIFF\x24\x00\x00\x00WEBPVP8X" + b"\x00" * 24, "v.webp")


def test_animated_webp_raises_unsupported(tmp_path):
    img = _rgb(30, 41)
    data = pil_bytes(Image.fromarray(img), "WEBP", save_all=True, duration=100,
                     append_images=[Image.fromarray(255 - img)])
    _left_out(tmp_path, data, "animated", "anim.webp")


# --------------------------------------------------------------------------- #
# CMYK JPEG
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("quality,subsampling,progressive",
                         [(50, 0, False), (90, 1, False), (100, 2, False), (75, 2, True)])
def test_cmyk_jpeg_equals_cv2(tmp_path, quality, subsampling, progressive):
    """Adobe-inverted CMYK as PIL writes it, converted as OpenCV converts
    libjpeg's CMYK output; the same without its Adobe marker."""
    for shape in ((1, 1), (17, 23), (64, 48)):
        cmyk = np.random.RandomState(shape[0]).randint(0, 256, shape + (4,)).astype(np.uint8)
        data = pil_bytes(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=quality,
                         subsampling=subsampling, progressive=progressive)
        _same_as_cv2(tmp_path, data, "c.jpg")
        at = data.index(b"\xff\xee")
        plain = data[:at] + data[at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]:]
        _same_as_cv2(tmp_path, plain, "n.jpg")


def test_ycck_jpeg_raises_unsupported(tmp_path):
    cmyk = np.random.RandomState(0).randint(0, 256, (16, 16, 4)).astype(np.uint8)
    data = pil_bytes(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=90)
    at = data.index(b"Adobe") + 11
    _left_out(tmp_path, data[:at] + b"\x02" + data[at + 1:], "YCCK", "y.jpg")


# --------------------------------------------------------------------------- #
# Formats cv2 reads by content that the port does not decode
# --------------------------------------------------------------------------- #
def _cv2_encoded(ext, img):
    return lambda: cv2.imencode(ext, img)[1].tobytes()


SIGNATURES = {
    "gif": (_cv2_encoded(".gif", RGB8), "GIF"),
    "pgm": (_cv2_encoded(".pgm", RGB8[..., 0]), "PNM"),
    "ppm": (_cv2_encoded(".ppm", RGB8), "PNM"),
    "pbm": (_cv2_encoded(".pbm", RGB8[..., 0]), "PNM"),
    "pam": (_cv2_encoded(".pam", RGB8), "PNM"),
    "pnm_ascii": (lambda: b"P1\n3 2\n0 1 0\n1 0 1\n", "PNM"),
    "pfm": (_cv2_encoded(".pfm", RGB8.astype(np.float32) / 255), "PFM"),
    "sun_raster": (_cv2_encoded(".sr", RGB8), "Sun raster"),
    "radiance": (_cv2_encoded(".hdr", RGB8.astype(np.float32) / 255), "Radiance HDR"),
    "radiance_rgbe": (lambda: b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 1\n\x80\x80\x80\x80",
                      "Radiance HDR"),
    "j2k": (lambda: pil_bytes(Image.fromarray(RGB8), "JPEG2000", no_jp2=True), "JPEG 2000"),
    "jp2": (lambda: pil_bytes(Image.fromarray(RGB8), "JPEG2000"), "JPEG 2000"),
    "avif": (_cv2_encoded(".avif", RGB8), "AVIF"),
}


@pytest.mark.parametrize("case", sorted(SIGNATURES))
def test_every_format_cv2_reads_is_named(tmp_path, case):
    """Under a .jpg name, as scraped sets hold them: cv2 decodes by content,
    the port names the format (UnsupportedImage), never a damaged file."""
    build, match = SIGNATURES[case]
    _left_out(tmp_path, build(), match, "disguised.jpg")


def test_openexr_is_named_though_this_cv2_lacks_it(tmp_path):
    path = _write(tmp_path, "x.exr", b"\x76\x2f\x31\x01\x02\x00\x00\x00" + b"\0" * 40)
    with pytest.raises(UnsupportedImage, match="OpenEXR"):
        imread_bgr(path)


# --------------------------------------------------------------------------- #
# The readers built on the codecs, against the JAX package
# --------------------------------------------------------------------------- #
def _labels(tmp_path, n):
    lab = tmp_path / "labels"
    lab.mkdir()
    for i in range(n):
        (lab / f"{i:04d}.txt").write_text("0 0.5 0.5 0.4 0.3\n1 0.3 0.6 0.2 0.2\n")
    return str(lab)


def test_disguised_webp_trains_as_the_image_and_gif_is_named(tmp_path):
    """A WebP saved under a .jpg name (common in scraped sets) is a sample
    equal to JAX's, whose cv2.imread decodes it by content; it was a black
    sample without targets when the port's sniff knew no WebP. A GIF under
    a .jpg name raises UnsupportedImage naming it rather than going black."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    (img_dir / "0000.jpg").write_bytes(pil_bytes(Image.fromarray(_rgb(48, 64, 1)), "WEBP",
                                                 quality=80))
    (img_dir / "0001.jpg").write_bytes(cv2.imencode(".gif", fixture_image(48, 64, 2))[1].tobytes())
    labels = _labels(tmp_path, 2)
    kw = dict(img_size=64, is_train=False, augment=False, max_boxes=8)
    pds, jds = YoloDataset(str(img_dir), labels, **kw), JaxYoloDataset(str(img_dir), labels, **kw)
    p, j = pds.get(0), jds.get(0)
    assert p["image"].any() and p["mask"].sum() == 2
    _assert_sample(p, j, 0, 0.0)
    assert jds.get(1)["image"].any()                  # cv2 reads the GIF
    with pytest.raises(UnsupportedImage, match="GIF"):
        pds.get(1)


def _tiff_copy(src_root: str, dst_root: str) -> None:
    """Every image of a set rewritten by the port's TIFF writer, labels
    copied."""
    for split in ("train", "valid"):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(dst_root, split, sub), exist_ok=True)
        for name in sorted(os.listdir(os.path.join(src_root, split, "images"))):
            stem = os.path.splitext(name)[0]
            img = imread_bgr(os.path.join(src_root, split, "images", name))
            imwrite.imwrite_bgr(os.path.join(dst_root, split, "images", stem + ".tif"), img)
            with open(os.path.join(src_root, split, "labels", stem + ".txt")) as f:
                text = f.read()
            with open(os.path.join(dst_root, split, "labels", stem + ".txt"), "w") as f:
                f.write(text)


def test_tiff_split_samples_match_jax(tmp_path):
    """A TIFF split builds (the constructor used to refuse it) and gives
    JAX's samples: load_image and unaugmented get exactly, augmented get
    (mosaic and cutmix on some draws) within 1 level."""
    make_synth_set(str(tmp_path / "png"), n_train=6, n_val=2, w=64, h=64)
    _tiff_copy(str(tmp_path / "png"), str(tmp_path / "tif"))
    imgs = str(tmp_path / "tif" / "train" / "images")
    labels = str(tmp_path / "tif" / "train" / "labels")
    assert sorted(os.listdir(imgs))[0].endswith(".tif")
    plain = dict(img_size=64, is_train=True, augment=False, max_boxes=16)
    jds, pds = JaxYoloDataset(imgs, labels, **plain), YoloDataset(imgs, labels, **plain)
    for i in range(len(pds)):
        np.testing.assert_array_equal(pds.load_image(i), jds.load_image(i))
        _assert_sample(pds.get(i, np.random.RandomState(i)), jds.get(i, np.random.RandomState(i)),
                       0, 0.0)
    args = dict(img_size=64, is_train=True, augment=True, max_boxes=24, mosaic_p=0.5,
                cutmix_p=0.5)
    jds, pds = JaxYoloDataset(imgs, labels, **args), YoloDataset(imgs, labels, **args)
    for seed in range(6):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        j, p = jds.get(seed % len(jds), rj), pds.get(seed % len(pds), rp)
        _same_rng(rj, rp)
        _assert_sample(p, j, 1, 0.0)


def _jax_pretrain():
    spec = importlib.util.spec_from_file_location(
        "jax_pretrain_backbone", os.path.join(ROOT, "tools", "pretrain_backbone.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("train", [True, False])
def test_pretrain_reader_on_webp_and_cmyk_equals_jax(tmp_path, train):
    """An imagefolder of lossy and lossless WebPs and CMYK JPEGs: the same
    listing and labels as JAX's, the batches within 1 level (the resize),
    the RandomState in the same state."""
    jpb = _jax_pretrain()
    for c in range(2):
        d = tmp_path / f"class_{c}"
        d.mkdir()
        img = _rgb(40 + 8 * c, 56, c)
        (d / "a.webp").write_bytes(pil_bytes(Image.fromarray(img), "WEBP", quality=70))
        (d / "b.webp").write_bytes(pil_bytes(Image.fromarray(img), "WEBP", lossless=True))
        cmyk = np.dstack([255 - img, img[..., :1] // 3]).astype(np.uint8)
        (d / "c.jpg").write_bytes(pil_bytes(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=85))
    samples, classes = pb.list_imagefolder(str(tmp_path))
    assert (samples, classes) == jpb.list_imagefolder(str(tmp_path)) and len(samples) == 6
    idxs = list(range(len(samples))) * 2
    r_port, r_jax = np.random.RandomState(3), np.random.RandomState(3)
    got, got_l = pb.make_batch(samples, idxs, 32, r_port, train=train)
    want, want_l = jpb.make_batch(samples, idxs, 32, r_jax, train=train)
    np.testing.assert_array_equal(got_l, want_l)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert all(got[i].any() for i in range(len(idxs)))
    _same_rng(r_port, r_jax)


def test_augment_coco_on_a_tiff_split_matches_jax(tmp_path, jax_canvases, port_canvases):
    """A COCO split whose file_names are TIFFs: the port reads them, as
    JAX's cv2.imread does, and writes the same canvases and annotations."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    coco = {"images": [], "annotations": [], "categories": [{"id": 0, "name": "a"}]}
    for i in range(3):
        name = f"{i:03d}.tif"
        cv2.imwrite(str(img_dir / name), fixture_image(24 + 8 * i, 40, i),
                    [cv2.IMWRITE_TIFF_COMPRESSION, (5, 8, 1)[i]])
        coco["images"].append({"id": i + 1, "file_name": name, "width": 40, "height": 24 + 8 * i})
        coco["annotations"].append({"id": 10 + i, "image_id": i + 1, "category_id": 0,
                                    "bbox": [4, 4, 10, 8], "area": 80, "iscrowd": 0})
    ann = tmp_path / "annotations.json"
    import json
    ann.write_text(json.dumps(coco))
    n_jax = jax_weather.augment_coco(str(img_dir), str(ann), str(tmp_path / "jax"), None, 2, 3)
    n = weather.augment_coco(str(img_dir), str(ann), str(tmp_path / "port"), None, 2, 3)
    assert n == n_jax == 6
    _compare_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), jax_canvases, tmp_path,
                     port_canvases)
    with open(tmp_path / "jax" / "annotations.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "annotations.json") as f:
        assert json.load(f) == want


# --------------------------------------------------------------------------- #
# The TIFF writer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(1, 1), (8, 8), (37, 53), (480, 640), (7, 3000), (300, 301)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiff_writer_reads_back_and_has_cv2s_layout(tmp_path, shape):
    """The file reads back to the canvas through cv2 and through the port,
    and holds cv2.imwrite's layout: LZW, Predictor 2, chunky RGB, its rows
    per strip (a noisy canvas overflows the 12-bit table: Clear codes)."""
    img = np.random.RandomState(shape[1]).randint(0, 256, shape + (3,)).astype(np.uint8)
    img[: shape[0] // 2] //= 16
    for ext in (".tif", ".tiff"):
        path = str(tmp_path / f"x{ext}")
        imwrite.imwrite_bgr(path, img)
        np.testing.assert_array_equal(cv2.imread(path), img)
        np.testing.assert_array_equal(imread_bgr(path), img)
    mine = Image.open(path).tag_v2
    theirs = Image.open(io.BytesIO(cv2.imencode(".tif", img)[1].tobytes())).tag_v2
    for tag in (258, 259, 262, 277, 278, 284, 317, 339):
        assert mine[tag] == theirs[tag], tag
