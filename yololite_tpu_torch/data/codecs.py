"""Image codecs: read JPEG, BMP, PNG, TIFF and WebP files as `cv2.imread`
reads them.

The decoders are host C++ (`csrc/imgcodec.cpp`; WebP in `csrc/webpcodec.cpp`),
built with the host C++ compiler at first use (`csrc/build.py`) and called
through ctypes, which drops the GIL for the call, so loader threads decode
in parallel. Each decoder gives the pixels of `cv2.imread(path)`
(IMREAD_COLOR) bit for bit:

  - JPEG (baseline, extended and progressive Huffman; 1, 3 or 4 (CMYK)
    components; any sampling whose ratios are integral; restart intervals)
    with libjpeg-turbo's ISLOW IDCT, fancy upsampling and YCbCr tables, the
    Adobe transform flag, OpenCV's CMYK->BGR and the EXIF orientation;
  - BMP 24-bit, 8-bit palette and 32-bit (BI_RGB and BI_BITFIELDS), rows
    bottom-up or top-down;
  - PNG of every colour type, bit depth 1-16, plain or Adam7 interlaced:
    the chunks are parsed here, with the CRC of each critical chunk checked
    as libpng checks it, the IDAT stream is inflated by the standard
    library's zlib (which drops the GIL too), and the unfilter and libpng's
    sample conversion run in C++; the orientation of an eXIf chunk is
    applied;
  - TIFF (the first image): II/MM, classic or BigTIFF, strips or tiles,
    planar or chunky, uncompressed, LZW, PackBits, Deflate (inflated here
    by zlib) or JPEG; gray, RGB(A), palette and CMYK samples of the depths
    cv2 reads, converted as libtiff's RGBA reader converts them, and
    Orientation 1-4;
  - WebP: lossy (VP8) and lossless (VP8L), with or without alpha, as
    libwebp's WebPDecodeBGR gives them, the EXIF orientation applied.

`jpeg_planes` gives a Motion-JPEG video frame's Y/Cb/Cr planes as FFmpeg's
mjpeg decoder does (its IDCT, no upsampling), which `data/video.py`
converts to BGR as cv2.VideoCapture does: not `imread`'s pixels.

A file cv2 would give `None` for (damaged, truncated before any image data,
not an image, a TIFF with Orientation 5-8 or 32-bit samples) raises
`ValueError`; a variant this package does not decode (arithmetic-coded,
lossless, hierarchical, 12-bit or YCCK JPEG, 1/4/16-bit or RLE BMP, CCITT,
old-style JPEG or raw YCbCr TIFF, animated WebP) and the formats cv2 reads
that it does not (`UNDECODED`: GIF, JPEG 2000, PNM, ...) raise
`UnsupportedImage` naming them. The format is taken from the file's
content, as cv2 takes it, never from its extension. There is no other
decoder to give way to: without a host compiler the first read raises,
naming the compiler.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_LIB = None
_WEBP_LIB = None
_MSG_LEN = 256
_MAX_PIXELS = 1 << 30             # cv2's CV_IO_MAX_IMAGE_PIXELS

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")
_PNG_MAX_SIDE = 1_000_000         # libpng's default user limit on width and height


class UnsupportedImage(NotImplementedError):
    """An image format or variant this package does not decode."""


def library() -> ctypes.CDLL:
    """The built `imgcodec` library with its C functions typed."""
    global _LIB
    if _LIB is None:
        from yololite_tpu_torch.csrc.build import load
        lib = load("imgcodec")
        buf, ptr, i32, i64 = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        for kind in ("jpeg", "bmp"):
            getattr(lib, f"yl_{kind}_header").argtypes = [buf, i64, ptr, buf, ctypes.c_int]
            getattr(lib, f"yl_{kind}_decode").argtypes = [buf, i64, ptr, i64, buf, ctypes.c_int]
        lib.yl_jpeg_planes_header.argtypes = [buf, i64, ptr, buf, ctypes.c_int]
        lib.yl_jpeg_planes.argtypes = [buf, i64, ptr, i64, buf, ctypes.c_int]
        lib.yl_exif_orientation.argtypes = [buf, i64]
        lib.yl_tiff_header.argtypes = [buf, i64, ptr, buf, ctypes.c_int]
        lib.yl_tiff_chunks.argtypes = [buf, i64, ptr, ptr, ptr, buf, ctypes.c_int]
        lib.yl_tiff_decode.argtypes = [buf, i64, buf, ptr, ptr, ptr, i64, buf, ctypes.c_int]
        lib.yl_lzw_encode.argtypes = [buf, i64, ptr, i64]
        lib.yl_lzw_encode.restype = i64
        lib.yl_png_unfilter.argtypes = [buf, i64, i32, i32, i32, i32, i32, buf, buf, ptr, i32,
                                        buf, ctypes.c_int]
        for fn in (lib.yl_jpeg_header, lib.yl_jpeg_decode, lib.yl_jpeg_planes_header,
                   lib.yl_jpeg_planes, lib.yl_bmp_header,
                   lib.yl_bmp_decode, lib.yl_exif_orientation, lib.yl_png_unfilter,
                   lib.yl_tiff_header, lib.yl_tiff_chunks, lib.yl_tiff_decode):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def webp_library() -> ctypes.CDLL:
    """The built `webpcodec` library with its C functions typed."""
    global _WEBP_LIB
    if _WEBP_LIB is None:
        from yololite_tpu_torch.csrc.build import load
        lib = load("webpcodec")
        buf, ptr, i64 = ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64
        lib.yl_webp_header.argtypes = [buf, i64, ptr, buf, ctypes.c_int]
        lib.yl_webp_decode.argtypes = [buf, i64, ptr, i64, buf, ctypes.c_int]
        lib.yl_webp_header.restype = lib.yl_webp_decode.restype = ctypes.c_int
        _WEBP_LIB = lib
    return _WEBP_LIB


def libraries() -> None:
    """Builds both codec libraries (in parallel, where neither is built yet)
    and loads them, so a missing compiler raises here and not in a read."""
    from yololite_tpu_torch.csrc.build import build
    build(["imgcodec", "webpcodec"])
    library()
    webp_library()


def _check(code: int, msg, what: str) -> None:
    if code == 0:
        return
    text = f"{what}: {msg.value.decode(errors='replace')}"
    if code == 2:
        raise UnsupportedImage(text)
    raise ValueError(text)


def _decode(kind: str, data: bytes) -> np.ndarray:
    lib, msg = library(), ctypes.create_string_buffer(_MSG_LEN)
    data = bytes(data)
    hwo = np.zeros(3, np.int32)               # height, width, EXIF orientation
    _check(getattr(lib, f"yl_{kind}_header")(data, len(data), hwo.ctypes.data, msg, _MSG_LEN),
           msg, kind.upper())
    out = np.empty((int(hwo[0]), int(hwo[1]), 3), np.uint8)
    _check(getattr(lib, f"yl_{kind}_decode")(data, len(data), out.ctypes.data, out.size,
                                             msg, _MSG_LEN), msg, kind.upper())
    return orient(out, int(hwo[2]))


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> BGR uint8 [H, W, 3], EXIF orientation applied."""
    return _decode("jpeg", data)


def jpeg_planes(data: bytes):
    """A Motion-JPEG frame's planes as FFmpeg's mjpeg decoder gives them:
    Y [H, W], Cb and Cr [h, (W + 1) // 2] (h = (H + 1) // 2 for 4:2:0, H for
    4:2:2), each block through FFmpeg's simple IDCT, no upsampling. Other
    layouts raise `UnsupportedImage`, a damaged frame `ValueError`."""
    lib, msg = library(), ctypes.create_string_buffer(_MSG_LEN)
    data = bytes(data)
    info = np.zeros(3, np.int32)
    _check(lib.yl_jpeg_planes_header(data, len(data), info.ctypes.data, msg, _MSG_LEN),
           msg, "Motion-JPEG")
    h, w, ch = (int(v) for v in info)
    cw = (w + 1) // 2
    out = np.empty(w * h + 2 * cw * ch, np.uint8)
    _check(lib.yl_jpeg_planes(data, len(data), out.ctypes.data, out.size, msg, _MSG_LEN),
           msg, "Motion-JPEG")
    y = out[:w * h].reshape(h, w)
    u = out[w * h:w * h + cw * ch].reshape(ch, cw)
    v = out[w * h + cw * ch:].reshape(ch, cw)
    return y, u, v


def _riff_chunks(data: bytes):
    """(fourcc, payload) of each chunk of a RIFF WebP file after "WEBP"."""
    pos = 12
    while pos + 8 <= len(data):
        kind, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)


def webp_exif(data: bytes) -> bytes:
    """The EXIF chunk of a WebP file from its TIFF header on, or b"" (the
    data cv2.imread reads the orientation from)."""
    for kind, body in _riff_chunks(data):
        if kind == b"EXIF":
            return body[6:] if body.startswith(b"Exif\x00\x00") else body
    return b""


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes (lossy, lossless, with or without alpha) -> BGR uint8
    [H, W, 3], the EXIF orientation applied."""
    lib, msg = webp_library(), ctypes.create_string_buffer(_MSG_LEN)
    data = bytes(data)
    hw = np.zeros(2, np.int32)
    _check(lib.yl_webp_header(data, len(data), hw.ctypes.data, msg, _MSG_LEN), msg, "WebP")
    out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
    _check(lib.yl_webp_decode(data, len(data), out.ctypes.data, out.size, msg, _MSG_LEN),
           msg, "WebP")
    return orient(out, exif_orientation(webp_exif(data)))


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> BGR uint8 [H, W, 3]."""
    return _decode("bmp", data)


_BIT_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
_TIFF_DEFLATE = (8, 32946)


def _inflate(raw: bytes, size: int):
    """Up to `size` bytes of a zlib stream and whether it inflated whole, as
    libtiff's ZIPDecode: on a fault, what was inflated before it."""
    try:
        out = zlib.decompressobj().decompress(raw, size)
        return out, len(out) == size
    except zlib.error:
        d, parts = zlib.decompressobj(), []
        for i in range(len(raw)):
            try:
                parts.append(d.decompress(raw[i:i + 1], size - sum(map(len, parts))))
            except zlib.error:
                break
        return b"".join(parts), False


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes (the first image) -> BGR uint8 [H, W, 3], orientation
    applied. Deflate chunks are inflated here by zlib, the rest in C++."""
    lib, msg = library(), ctypes.create_string_buffer(_MSG_LEN)
    data = bytes(data)
    info = np.zeros(6, np.int64)        # height, width, orientation, compression, chunks, fill order
    _check(lib.yl_tiff_header(data, len(data), info.ctypes.data, msg, _MSG_LEN), msg, "TIFF")
    h, w, _, compression, n, fillorder = (int(v) for v in info)
    inflated, bounds, whole = None, np.zeros(n + 1, np.int64), np.zeros(n, np.uint8)
    if compression in _TIFF_DEFLATE:
        offs, counts, sizes = (np.zeros(n, np.int64) for _ in range(3))
        _check(lib.yl_tiff_chunks(data, len(data), offs.ctypes.data, counts.ctypes.data,
                                  sizes.ctypes.data, msg, _MSG_LEN), msg, "TIFF")
        parts = []
        for i, (off, count, size) in enumerate(zip(offs.tolist(), counts.tolist(),
                                                    sizes.tolist())):
            raw = data[off:off + count] if 0 <= off <= len(data) else b""
            if fillorder == 2:
                raw = raw.translate(_BIT_REVERSED)
            part, whole[i] = _inflate(raw, size)
            parts.append(part)
        inflated = b"".join(parts)
        bounds[1:] = np.cumsum([len(p) for p in parts])
    out = np.empty((h, w, 3), np.uint8)
    _check(lib.yl_tiff_decode(data, len(data), inflated, bounds.ctypes.data, whole.ctypes.data,
                              out.ctypes.data, out.size, msg, _MSG_LEN), msg, "TIFF")
    return out


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            if kind in _PNG_CRITICAL:
                raise ValueError(f"PNG {kind.decode(errors='replace')} chunk CRC error")
            pos += 12 + n
            continue                    # an ancillary chunk with a bad CRC is dropped
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray), [H, W, 3] (RGB, or a palette
    without tRNS) or [H, W, 4] (RGBA; gray+alpha as gray, gray, gray, alpha;
    a palette with tRNS alpha). Samples are 8-bit as libpng gives them under
    cv2's transforms: 16-bit keeps its high byte, gray of 1/2/4 bits is
    scaled to 8."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat, palette, trns = None, [], None, None
    for kind, body in _png_chunks(data):
        if header is None and kind != b"IHDR":
            raise ValueError("PNG does not start with IHDR")
        if kind == b"IHDR":
            if header is not None or len(body) != 13:
                raise ValueError("bad PNG IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, method, filt, interlace = header
    if not (0 < w <= _PNG_MAX_SIDE and 0 < h <= _PNG_MAX_SIDE) or w * h > _MAX_PIXELS:
        raise ValueError(f"PNG size {w}x{h} out of range")
    if depth not in _PNG_DEPTHS.get(ctype, ()) or method or filt or interlace > 1:
        raise ValueError(f"bad PNG header: bit depth {depth}, colour type {ctype}, "
                         f"methods {method}/{filt}, interlace {interlace}")
    if ctype == 3 and (not palette or len(palette) % 3):
        raise ValueError("PNG palette image without a valid PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    out_ch = (4 if trns else 3) if ctype == 3 else {0: 1, 2: 3, 4: 4, 6: 4}[ctype]
    lib, msg = library(), ctypes.create_string_buffer(_MSG_LEN)
    out = np.empty((h, w, out_ch), np.uint8)
    trns = trns if ctype == 3 and trns else b""
    _check(lib.yl_png_unfilter(raw, len(raw), w, h, depth, ctype, interlace,
                               (palette or b"").ljust(768, b"\0")[:768],
                               trns.ljust(256, b"\xff")[:256],
                               out.ctypes.data, out_ch, msg, _MSG_LEN), msg, "PNG")
    return out[..., 0] if out_ch == 1 else out


def png_exif(data: bytes) -> bytes:
    """The eXIf chunk before the first IDAT (the EXIF data cv2.imread reads
    its orientation from), or b"". `data` has been decoded already."""
    for kind, body in _png_chunks(data):
        if kind == b"IDAT":
            break
        if kind == b"eXIf":
            return body
    return b""


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def exif_orientation(tiff: bytes) -> int:
    """The orientation (1-8) of EXIF data that starts at its TIFF header."""
    return int(library().yl_exif_orientation(tiff, len(tiff)))


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """An EXIF orientation applied as cv2.imread applies it (flips after a
    transpose for 5-8)."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (slice(None), slice(None, None, -1)), 3: (slice(None, None, -1),) * 2,
            4: (slice(None, None, -1),), 6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1),) * 2, 8: (slice(None, None, -1),)}.get(orientation)
    return np.ascontiguousarray(img[flip] if flip else img)


# Formats cv2.imread decodes in OpenCV 5.0 (as built here: GIF, PNM/PAM/PFM,
# JPEG 2000, Sun raster, Radiance HDR and AVIF; OpenEXR is recognised too)
# that this package does not: each raises UnsupportedImage naming it.
UNDECODED = {"gif": "GIF", "pnm": "PNM/PAM", "pfm": "PFM", "jpeg2000": "JPEG 2000",
             "sunras": "Sun raster", "hdr": "Radiance HDR", "exr": "OpenEXR", "avif": "AVIF"}
SNIFF_BYTES = 64


def sniff(head: bytes) -> str:
    """The format cv2.imread would pick from a file's first SNIFF_BYTES bytes,
    by content as cv2's decoders check it (not by extension): "jpeg", "png",
    "bmp", "tiff", "webp", a key of UNDECODED, or "" (not an image cv2
    reads)."""
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(b"BM"):
        return "bmp"
    if head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if len(head) >= 3 and head[:1] == b"P" and head[2:3].isspace():
        if head[1:2] in b"1234567":
            return "pnm"
        if head[1:2] in (b"f", b"F"):
            return "pfm"
    if head.startswith((b"\x00\x00\x00\x0cjP  \r\n\x87\n", b"\xff\x4f\xff\x51")):
        return "jpeg2000"
    if head.startswith(b"\x59\xa6\x6a\x95"):
        return "sunras"
    if head.startswith((b"#?RADIANCE", b"#?RGBE")):
        return "hdr"
    if head.startswith(b"\x76\x2f\x31\x01"):
        return "exr"
    if head[4:8] == b"ftyp" and (b"avif" in head[8:SNIFF_BYTES] or b"avis" in head[8:SNIFF_BYTES]):
        return "avif"
    return ""


def imread_bgr(path: str) -> np.ndarray:
    """What `cv2.imread(path)` returns: BGR uint8 [H, W, 3]. Where cv2
    returns None (missing, unreadable or damaged file) this raises
    `ValueError`; a format this package does not decode raises
    `UnsupportedImage`."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ValueError(f"{path}: cannot read ({e})") from e
    kind = sniff(data[:SNIFF_BYTES])
    try:
        if kind == "jpeg":
            return decode_jpeg(data)
        if kind == "bmp":
            return decode_bmp(data)
        if kind == "tiff":
            return decode_tiff(data)
        if kind == "webp":
            return decode_webp(data)
        if kind == "png":
            img = decode_png(data)
            bgr = (np.repeat(img[..., None], 3, axis=2) if img.ndim == 2
                   else np.ascontiguousarray(img[..., 2::-1]))
            return orient(bgr, exif_orientation(png_exif(data)))
    except (ValueError, UnsupportedImage) as e:
        raise type(e)(f"{path}: {e}") from e
    if kind:
        raise UnsupportedImage(f"{path}: {UNDECODED[kind]} images are not decoded by this "
                               f"package (it reads JPEG, PNG, BMP, TIFF and WebP)")
    raise ValueError(f"{path}: not an image file cv2.imread reads")
