"""Image codecs: read JPEG, BMP and PNG files as `cv2.imread` reads them.

The decoders are host C++ (`csrc/imgcodec.cpp`), built with the host C++
compiler at first use (`csrc/build.py`) and called through ctypes, which
drops the GIL for the call, so loader threads decode in parallel. Each
decoder gives the pixels of `cv2.imread(path)` (IMREAD_COLOR) bit for bit:

  - JPEG (baseline, extended and progressive Huffman; 1 or 3 components; any
    sampling whose ratios are integral; restart intervals) with
    libjpeg-turbo's ISLOW IDCT, fancy upsampling and YCbCr tables, the
    Adobe transform flag and the EXIF orientation;
  - BMP 24-bit, 8-bit palette and 32-bit (BI_RGB and BI_BITFIELDS), rows
    bottom-up or top-down;
  - PNG of every colour type, bit depth 1-16, plain or Adam7 interlaced:
    the chunks are parsed here, with the CRC of each critical chunk checked
    as libpng checks it, the IDAT stream is inflated by the standard
    library's zlib (which drops the GIL too), and the unfilter and libpng's
    sample conversion run in C++; the orientation of an eXIf chunk is
    applied.

A file cv2 would give `None` for (damaged, truncated before any image data,
not an image) raises `ValueError`; a variant this package does not decode
(TIFF, arithmetic-coded, lossless, hierarchical, 12-bit or
CMYK JPEG, 1/4/16-bit or RLE BMP) raises `UnsupportedImage` naming it.
There is no other decoder to give way to: without a host compiler the first
read raises, naming the compiler.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_LIB = None
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
        lib.yl_exif_orientation.argtypes = [buf, i64]
        lib.yl_png_unfilter.argtypes = [buf, i64, i32, i32, i32, i32, i32, buf, buf, ptr, i32,
                                        buf, ctypes.c_int]
        for fn in (lib.yl_jpeg_header, lib.yl_jpeg_decode, lib.yl_bmp_header,
                   lib.yl_bmp_decode, lib.yl_exif_orientation, lib.yl_png_unfilter):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> BGR uint8 [H, W, 3]."""
    return _decode("bmp", data)


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


def sniff(head: bytes) -> str:
    """The format cv2.imread would pick from a file's first bytes: "jpeg",
    "png", "bmp", "TIFF" (not decoded by this package), or "" (not an image
    this package knows)."""
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(b"BM"):
        return "bmp"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
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
    kind = sniff(data[:16])
    try:
        if kind == "jpeg":
            return decode_jpeg(data)
        if kind == "bmp":
            return decode_bmp(data)
        if kind == "png":
            img = decode_png(data)
            bgr = (np.repeat(img[..., None], 3, axis=2) if img.ndim == 2
                   else np.ascontiguousarray(img[..., 2::-1]))
            return orient(bgr, exif_orientation(png_exif(data)))
    except (ValueError, UnsupportedImage) as e:
        raise type(e)(f"{path}: {e}") from e
    if kind:
        raise UnsupportedImage(f"{path}: {kind} images are not decoded by this package "
                               f"(it reads JPEG, PNG and BMP)")
    raise ValueError(f"{path}: not a JPEG, PNG, BMP or TIFF file")
