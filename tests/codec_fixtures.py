"""Writes the committed codec fixtures under tests/data/codecs/ and their
manifest, the SHA-256 and shape of each file's `cv2.imread` output.

    python tests/codec_fixtures.py

The files are small JPEGs written by `cv2.imwrite` (baseline in each
sampling, progressive, restart markers, optimized tables, luma and chroma
quality apart, EXIF orientation 6, gray), one progressive JPEG at 640x480
(which `chip_smoke.py` also times), one 24-bit BMP, one palette PNG,
CMYK JPEGs (PIL), TIFFs (cv2's compressions; tiles, planar data, MM order,
BigTIFF, palettes, bilevel, 16-bit, CMYK, unassociated alpha, orientation
and fill order by `write_tiff` below, which PIL did not write validly for
tiles, planar 2 or MM; JPEG YCbCr by PIL) and WebPs (lossy, lossless,
alpha, EXIF orientation by PIL; the simple loop filter, four token
partitions and four segments through libwebp's advanced API, `encode_webp`;
a lossy and a lossless one at 640x480 for the card's timing).
`chip_smoke.py` decodes each with the port's codec on the card's machine,
which has no cv2, and holds the output to the manifest;
`tests/test_torch_port_codecs.py` regenerates the manifest from the
committed files so it cannot drift.
"""

import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import zlib

import cv2
import numpy as np
import PIL
from PIL import Image

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "codecs")


def fixture_image(h: int = 45, w: int = 61, seed: int = 0) -> np.ndarray:
    """Seeded noise on a smooth gradient (BGR), so clamping is exercised."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    grad = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                     (x + y) * 255 / max(h + w - 2, 1)], -1)
    return np.clip(grad + rng.randint(-90, 90, (h, w, 3)), 0, 255).astype(np.uint8)


def frame_image(h: int = 480, w: int = 640, seed: int = 0) -> np.ndarray:
    """A frame-sized image (BGR): a gradient with mild noise and a few flat
    rectangles."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / (w - 1), y * 255 / (h - 1), (x + y) * 255 / (h + w - 2)], -1)
    img = np.clip(img + rng.randint(-16, 17, (h, w, 3)), 0, 255).astype(np.uint8)
    for _ in range(6):
        x1, y1 = rng.randint(0, w - 140), rng.randint(0, h - 100)
        img[y1:y1 + rng.randint(20, 100), x1:x1 + rng.randint(20, 140)] = rng.randint(0, 256, 3)
    return img


def with_exif_orientation(jpeg: bytes, orientation: int, little_endian: bool = True) -> bytes:
    """The JPEG with an APP1 EXIF segment (one IFD0 entry, tag 0x0112)
    inserted after SOI."""
    e = "<" if little_endian else ">"
    tiff = ((b"II*\x00" if little_endian else b"MM\x00*") + struct.pack(e + "I", 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHI", 0x0112, 3, 1)
            + struct.pack(e + "H", orientation) + b"\x00\x00" + b"\x00\x00\x00\x00")
    payload = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + jpeg[2:]


def palette_png(h: int = 23, w: int = 31, seed: int = 1) -> bytes:
    """An 8-bit palette PNG with a tRNS chunk (written here: cv2 writes no
    palette PNG of a colour image)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, 16, (h, w)).astype(np.uint8)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
    raw = b"".join(b"\x00" + idx[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", rng.randint(0, 256, 48).astype(np.uint8).tobytes())
            + chunk(b"tRNS", bytes(range(0, 256, 32)))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


# --------------------------------------------------------------------------- #
# TIFF: a writer for layouts PIL and cv2 do not write
# --------------------------------------------------------------------------- #
def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes from 9 to 12 bits (early change), a Clear
    first and whenever the table fills, EOI last."""
    out, acc, nacc, width = bytearray(), 0, 0, 9

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
    table, free, w = {bytes([i]): i for i in range(256)}, 258, b""
    emit(256)
    for b in data:
        wk = w + bytes([b])
        if wk in table:
            w = wk
            continue
        emit(table[w])
        table[wk] = free
        free += 1
        if free > (1 << width) - 1 and width < 12:
            width += 1
        if free >= 4094:
            emit(256)
            table, free, width = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([b])
    if w:
        emit(table[w])
        free += 1
        if free > (1 << width) - 1 and width < 12:
            width += 1
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _pack_rows(a: np.ndarray, bps: int, order: str) -> bytes:
    """[rows, samples] -> bytes, sub-byte and odd depths MSB-first, each row
    padded to a byte."""
    if bps == 8:
        return a.astype(np.uint8).tobytes()
    if bps in (16, 32):
        kind = "f" if a.dtype.kind == "f" else "u"
        return a.astype(f"{order}{kind}{bps // 8}").tobytes()
    rows = []
    for r in a:
        bits = np.unpackbits(r.astype(">u2").view(np.uint8).reshape(-1, 2), axis=1)
        rows.append(np.packbits(bits[:, 16 - bps:].reshape(-1)).tobytes())
    return b"".join(rows)


_TIFF_FMT = {1: "B", 2: "B", 3: "H", 4: "I", 16: "Q"}


def write_tiff(img, bps=8, photometric=None, compression=1, predictor=1, planar=1,
               rows_per_strip=None, tile=None, order="<", bigtiff=False, extra=None,
               pages=1, chunk_hook=None) -> bytes:
    """A TIFF of sample values `img` ([H, W] or [H, W, C], in file order:
    RGB, CMYK, ...): strips or (tw, th) tiles, II ("<") or MM (">"),
    classic or BigTIFF, compression 1/5/8/32773/32946, Predictor 2, planar
    1/2; `extra` adds or overrides tags as {tag: (type, [values])}; `pages`
    repeats the directory over the same strips; `chunk_hook` may change the
    encoded chunks (to damage one) before they are laid out."""
    img = np.asarray(img)
    img = img[..., None] if img.ndim == 2 else img
    h, w, spp = img.shape
    planes = [img] if planar == 1 else [img[..., c:c + 1] for c in range(spp)]
    chunks = []
    for p in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), img.dtype)
                    src = p[ty:ty + th, tx:tx + tw]
                    t[:src.shape[0], :src.shape[1]] = src
                    chunks.append(t)
        else:
            rps = rows_per_strip or h
            chunks += [p[y:y + rps] for y in range(0, h, rps)]
    raw = []
    for c in chunks:
        a = c.reshape(c.shape[0], -1).astype(np.int64)
        if predictor == 2:
            a[:, c.shape[2]:] -= a[:, :-c.shape[2]].copy()
            a &= (1 << bps) - 1
        b = _pack_rows(a if img.dtype.kind != "f" else c.reshape(c.shape[0], -1), bps, order)
        b = {5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
             32773: packbits_encode}.get(compression, lambda x: x)(b)
        raw.append(b)
    raw = chunk_hook(raw) if chunk_hook else raw
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric if photometric is not None else (1 if spp < 3 else 2)]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        tags[278] = (4, [rows_per_strip or h])
    tags.update(extra or {})
    return assemble_tiff(tags, raw, tiled=bool(tile), order=order, bigtiff=bigtiff, pages=pages)


def assemble_tiff(tags, chunks, tiled=False, order="<", bigtiff=False, pages=1) -> bytes:
    """The file: a header, the chunks, then each page's directory (its arrays
    before it) with the chunks' offsets and byte counts."""
    e, inline = order, (8 if bigtiff else 4)
    out = bytearray((b"II" if e == "<" else b"MM")
                    + (struct.pack(e + "HHHQ", 43, 8, 0, 0) if bigtiff
                       else struct.pack(e + "HI", 42, 0)))
    offsets = []
    for b in chunks:
        offsets.append(len(out))
        out += b + b"\0" * (len(b) & 1)
    prev = 8 if bigtiff else 4
    for _ in range(pages):
        t = dict(tags)
        t[324 if tiled else 273] = (16 if bigtiff else 4, offsets)
        t[325 if tiled else 279] = (16 if bigtiff else 4, [len(b) for b in chunks])
        entries = []
        for k, (typ, vals) in sorted(t.items()):
            data = (bytes(vals) if typ == 7 else struct.pack(e + _TIFF_FMT[typ] * len(vals), *vals))
            if len(data) > inline:
                at = len(out)
                out += data + b"\0" * (len(data) & 1)
                data = struct.pack(e + ("Q" if bigtiff else "I"), at)
            entries.append(struct.pack(e + ("HHQ" if bigtiff else "HHI"), k, typ, len(vals))
                           + data.ljust(inline, b"\0"))
        struct.pack_into(e + ("Q" if bigtiff else "I"), out, prev, len(out))
        out += struct.pack(e + ("Q" if bigtiff else "H"), len(entries)) + b"".join(entries)
        prev = len(out)
        out += b"\0" * inline
    return bytes(out)


def _tiff(img, *params) -> bytes:
    ok, buf = cv2.imencode(".tif", img, list(params))
    assert ok
    return buf.tobytes()


def pil_bytes(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def ycbcr_jpeg_tiff(rgb: np.ndarray, rows_per_strip: int = 16) -> bytes:
    """A YCbCr 4:2:0 JPEG TIFF whose strips are whole JFIF files of
    cv2.imencode (no JPEGTables)."""
    h, w, _ = rgb.shape
    strips = [cv2.imencode(".jpg", np.ascontiguousarray(rgb[y:y + rows_per_strip, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
              for y in range(0, h, rows_per_strip)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [1]), 278: (4, [rows_per_strip]), 530: (3, [2, 2])}
    return assemble_tiff(tags, strips)


# --------------------------------------------------------------------------- #
# WebP through libwebp's advanced API (PIL's bundled libwebp), for encoder
# settings PIL does not expose
# --------------------------------------------------------------------------- #
_WEBP_CONFIG = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                "segments", "sns_strength", "filter_strength", "filter_sharpness",
                "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                "alpha_quality", "pass", "show_compressed", "preprocessing", "partitions",
                "partition_limit", "emulate_jpeg_size", "thread_level", "low_memory",
                "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin", "qmax"]
_WEBP_ABI = 0x0210


def libwebp():
    """PIL's bundled libwebp (or None where it is not found)."""
    from PIL import _webp  # noqa: F401  (loads libwebp's own dependencies first)
    root = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = sorted(glob.glob(os.path.join(root, "libwebp-*.so*")))
    return ctypes.CDLL(found[0]) if found else None


def encode_webp(rgb: np.ndarray, **settings) -> bytes:
    """RGB or RGBA uint8 -> a WebP file, WebPConfig fields set by name."""
    lib = libwebp()
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), _WEBP_ABI)
    for k, v in settings.items():
        i = _WEBP_CONFIG.index(k)
        if k in ("quality", "target_PSNR"):
            ctypes.cast(ctypes.byref(cfg, 4 * i), ctypes.POINTER(ctypes.c_float))[0] = v
        else:
            cfg[i] = int(v)
    assert lib.WebPValidateConfig(cfg)
    pic = (ctypes.c_uint8 * 1024)()
    assert lib.WebPPictureInitInternal(pic, _WEBP_ABI)
    ints = ctypes.cast(pic, ctypes.POINTER(ctypes.c_int32))
    ints[0] = 1 if settings.get("lossless") else 0          # use_argb
    ints[2], ints[3] = rgb.shape[1], rgb.shape[0]
    rgb = np.ascontiguousarray(rgb)
    imp = lib.WebPPictureImportRGBA if rgb.shape[2] == 4 else lib.WebPPictureImportRGB
    assert imp(pic, rgb.ctypes.data_as(ctypes.c_void_p), rgb.shape[1] * rgb.shape[2])
    writer = (ctypes.c_uint8 * 64)()
    lib.WebPMemoryWriterInit(writer)
    ptrs = ctypes.cast(pic, ctypes.POINTER(ctypes.c_void_p))
    ptrs[12] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value    # writer
    ptrs[13] = ctypes.addressof(writer)                                    # custom_ptr
    assert lib.WebPEncode(cfg, pic)
    mem = ctypes.cast(writer, ctypes.POINTER(ctypes.c_void_p))[0]
    size = ctypes.cast(writer, ctypes.POINTER(ctypes.c_size_t))[1]
    out = ctypes.string_at(mem, size)
    lib.WebPMemoryWriterClear(writer)
    lib.WebPPictureFree(pic)
    return out


def webp_with_exif(rgb: np.ndarray, orientation: int, **kw) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    return pil_bytes(Image.fromarray(rgb), "WEBP", exif=exif.tobytes(), **kw)


def smooth_frame(h: int = 480, w: int = 640) -> np.ndarray:
    """frame_image without its noise (BGR): gradients and flat rectangles."""
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / (w - 1), y * 255 / (h - 1), (x + y) * 255 / (h + w - 2)],
                   -1).astype(np.uint8)
    for _ in range(6):
        x1, y1 = rng.randint(0, w - 140), rng.randint(0, h - 100)
        img[y1:y1 + rng.randint(20, 100), x1:x1 + rng.randint(20, 140)] = rng.randint(0, 256, 3)
    return img


def _jpeg(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def fixtures():
    """name -> file bytes."""
    img = fixture_image()
    q, s = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    out = {}
    for name in ("444", "422", "420", "411", "440"):
        out[f"baseline_{name}.jpg"] = _jpeg(img, q, 90, s,
                                            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}"))
    out["progressive_420.jpg"] = _jpeg(img, q, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    out["progressive_444.jpg"] = _jpeg(img, q, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, s,
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    out["progressive_640x480.jpg"] = _jpeg(frame_image(), q, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    out["restart_7.jpg"] = _jpeg(img, q, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 7)
    out["optimized.jpg"] = _jpeg(img, q, 60, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    out["luma90_chroma20.jpg"] = _jpeg(img, cv2.IMWRITE_JPEG_LUMA_QUALITY, 90,
                                       cv2.IMWRITE_JPEG_CHROMA_QUALITY, 20)
    out["exif_6.jpg"] = with_exif_orientation(_jpeg(img, q, 90), 6)
    out["gray.jpg"] = _jpeg(img[..., 1], q, 85)
    ok, bmp = cv2.imencode(".bmp", img)
    out["rgb24.bmp"] = bmp.tobytes()
    out["palette.png"] = palette_png()
    out.update(tiff_fixtures())
    out.update(webp_fixtures())
    small = fixture_image(24, 31, seed=3)
    cmyk = np.dstack([small, small[..., 1:2] // 2]).astype(np.uint8)
    out["cmyk.jpg"] = pil_bytes(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=90)
    out["cmyk_progressive_420.jpg"] = pil_bytes(Image.fromarray(cmyk, "CMYK"), "JPEG",
                                                quality=80, progressive=True, subsampling=2)
    return out


def tiff_fixtures():
    """name -> TIFF bytes, each at most 32x24."""
    img = fixture_image(24, 31, seed=1)                 # BGR
    rgb = np.ascontiguousarray(img[..., ::-1])
    rng = np.random.RandomState(2)
    c = cv2.IMWRITE_TIFF_COMPRESSION
    out = {"tiff_cv2_lzw_predictor.tif": _tiff(img),
           "tiff_cv2_deflate.tif": _tiff(img, c, 8),
           "tiff_cv2_packbits.tif": _tiff(img, c, 32773),
           "tiff_cv2_jpeg.tif": _tiff(img, c, 7),
           "tiff_cv2_gray.tif": _tiff(img[..., 1]),
           "tiff_cv2_rgb16.tif": _tiff(img.astype(np.uint16) * 257 + rng.randint(0, 257, img.shape).astype(np.uint16))}
    r16 = rng.randint(0, 65536, (24, 31, 3)).astype(np.uint16)
    out["tiff_tiled_mm_bigtiff_deflate.tif"] = write_tiff(
        rgb, compression=8, predictor=2, tile=(16, 16), order=">", bigtiff=True)
    out["tiff_planar_rgb16_lzw_mm.tif"] = write_tiff(
        r16, bps=16, compression=5, predictor=2, planar=2, rows_per_strip=7, order=">")
    idx4 = rng.randint(0, 16, (24, 31)).astype(np.uint8)
    out["tiff_palette4.tif"] = write_tiff(
        idx4, bps=4, photometric=3, compression=32773,
        extra={320: (3, [int(v) for v in rng.randint(0, 256, 48)])})
    idx8 = rng.randint(0, 256, (24, 31)).astype(np.uint8)
    out["tiff_palette8_cmap16.tif"] = write_tiff(
        idx8, photometric=3, compression=5, extra={320: (3, [int(v) for v in rng.randint(0, 65536, 768)])})
    out["tiff_bilevel_miniswhite.tif"] = write_tiff(
        (img[..., 0] > 128).astype(np.uint8), bps=1, photometric=0, compression=32773)
    out["tiff_gray16_miniswhite.tif"] = write_tiff(r16[..., 0], bps=16, photometric=0,
                                                   compression=8, predictor=2)
    cmyk = np.dstack([rgb, rgb[..., :1] // 3]).astype(np.uint8)
    out["tiff_cmyk_planar.tif"] = write_tiff(cmyk, photometric=5, planar=2, compression=5,
                                             extra={332: (3, [1])})
    rgba = np.dstack([rgb, rng.randint(0, 256, (24, 31), np.uint8)])
    out["tiff_rgba_unassociated.tif"] = write_tiff(rgba, compression=5, predictor=2,
                                                   extra={338: (3, [2])})
    out["tiff_orientation3_tiled.tif"] = write_tiff(rgb, tile=(16, 16), extra={274: (3, [3])})
    out["tiff_fillorder2_lzw.tif"] = assemble_tiff(
        {256: (4, [31]), 257: (4, [24]), 258: (3, [8, 8, 8]), 259: (3, [5]), 262: (3, [2]),
         266: (3, [2]), 277: (3, [3]), 278: (4, [24]), 284: (3, [1])},
        [lzw_encode(rgb.tobytes()).translate(bytes(int(f"{i:08b}"[::-1], 2) for i in range(256)))])
    out["tiff_pil_jpeg_ycbcr.tif"] = pil_bytes(Image.fromarray(rgb).convert("YCbCr"), "TIFF",
                                               compression="jpeg")
    out["tiff_jpeg_ycbcr420.tif"] = ycbcr_jpeg_tiff(rgb, 8)
    out["tiff_multipage.tif"] = pil_bytes(Image.fromarray(rgb), "TIFF", compression="tiff_lzw",
                                          save_all=True,
                                          append_images=[Image.fromarray(255 - rgb)])
    return out


def webp_fixtures():
    """name -> WebP bytes: small ones, and a lossy and a lossless frame at
    640x480 for the card's timing."""
    rgb = np.ascontiguousarray(fixture_image(24, 31, seed=4)[..., ::-1])
    alpha = np.random.RandomState(5).randint(0, 256, (24, 31)).astype(np.uint8)
    out = {"webp_lossy_q10.webp": pil_bytes(Image.fromarray(rgb), "WEBP", quality=10),
           "webp_lossy_q90.webp": pil_bytes(Image.fromarray(rgb), "WEBP", quality=90),
           "webp_lossy_1x1.webp": pil_bytes(Image.fromarray(rgb[:1, :1]), "WEBP", quality=75),
           "webp_lossy_odd_17x5.webp": pil_bytes(Image.fromarray(rgb[:5, :17]), "WEBP", quality=50),
           "webp_lossless.webp": pil_bytes(Image.fromarray(rgb), "WEBP", lossless=True),
           "webp_lossy_alpha.webp": pil_bytes(Image.fromarray(np.dstack([rgb, alpha])), "WEBP",
                                              quality=70),
           "webp_lossless_alpha.webp": pil_bytes(Image.fromarray(np.dstack([rgb, alpha])),
                                                 "WEBP", lossless=True),
           "webp_exif6.webp": webp_with_exif(rgb, 6, quality=80),
           "webp_simple_filter.webp": encode_webp(rgb, quality=60, filter_type=0,
                                                  filter_strength=80, filter_sharpness=3),
           "webp_partitions4_segments4.webp": encode_webp(rgb, quality=40, partitions=2,
                                                          segments=4, sns_strength=100)}
    frame = frame_image()
    out["webp_lossy_640x480.webp"] = cv2.imencode(".webp", frame,
                                                  [cv2.IMWRITE_WEBP_QUALITY, 75])[1].tobytes()
    out["webp_lossless_640x480.webp"] = cv2.imencode(".webp", smooth_frame(),
                                                     [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()
    return out


def manifest_entry(path: str) -> dict:
    img = cv2.imread(path)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def manifest(directory: str = DIR) -> dict:
    return {name: manifest_entry(os.path.join(directory, name))
            for name in sorted(os.listdir(directory)) if name != "manifest.json"}


def main():
    os.makedirs(DIR, exist_ok=True)
    for name, data in fixtures().items():
        with open(os.path.join(DIR, name), "wb") as f:
            f.write(data)
    with open(os.path.join(DIR, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
