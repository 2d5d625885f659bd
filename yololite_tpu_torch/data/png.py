"""A PNG decoder in numpy and the standard library's zlib (no cv2, no PIL).

Reads non-interlaced 8-bit grayscale, RGB and RGBA images (colour types 0, 2
and 6) with any of the five scanline filters (None, Sub, Up, Average,
Paeth). Other PNG variants (palette, 16-bit, grey+alpha, interlaced) raise
`UnsupportedImage`; damaged data raises `ValueError`.

Unfiltering is vectorized. An image of None/Sub/Up rows takes one numpy op
a row (Sub as a cumulative sum per channel, mod 256). Average and Paeth
depend on the pixel to the left and the row above, so an image with any of
them is solved as one wavefront over anti-diagonals: W + H - 1 numpy steps.
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> channels


class UnsupportedImage(NotImplementedError):
    """A PNG variant (or an image format) this package does not decode."""


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _unfilter_rows(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Images whose rows use only None (0), Sub (1) and Up (2): one
    vectorized op per row. filt [H, W, C] uint8 -> reconstructed uint8."""
    img = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for y, t in enumerate(types):
        if t == 0:
            img[y] = filt[y]
        elif t == 1:
            img[y] = np.cumsum(filt[y], axis=0, dtype=np.uint8)      # wraps mod 256
        else:
            img[y] = filt[y] + prev                                   # uint8 wraps
        prev = img[y]
    return img


def _unfilter_wavefront(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Any mix of the five filters, solved over anti-diagonals: pixel (y, x)
    needs (y, x-1), (y-1, x) and (y-1, x-1), all on earlier diagonals, so
    W + H - 1 steps cover the image. The image is held skewed, S[x + y + 2,
    y + 1] = pixel (y, x) (row 0 is the zero row above the image, and cells
    off the image stay 0), so each step reads and writes contiguous slices."""
    h, w, ch = filt.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    skew_u, skew_r = xs + ys + 2, ys + 1
    f = np.zeros((w + h + 1, h + 1, ch), np.int16)
    f[skew_u, skew_r] = filt
    s = np.zeros_like(f)
    masks = [(types == k).astype(np.int16)[:, None] for k in range(5)]
    use_avg, use_paeth = bool(masks[3].any()), bool(masks[4].any())
    for u in range(2, w + h + 1):
        lo, hi = max(0, u - 1 - w), min(h - 1, u - 2)
        a = s[u - 1, lo + 1:hi + 2]           # left
        b = s[u - 1, lo:hi + 1]               # above
        pred = masks[1][lo:hi + 1] * a + masks[2][lo:hi + 1] * b
        if use_avg:
            pred += masks[3][lo:hi + 1] * ((a + b) >> 1)
        if use_paeth:
            c = s[u - 2, lo:hi + 1]           # above-left
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred += masks[4][lo:hi + 1] * paeth
        s[u, lo + 1:hi + 2] = (f[u, lo + 1:hi + 2] + pred) & 0xFF
    return s[skew_u, skew_r].astype(np.uint8)


# Unfiltering is thousands of small numpy calls, each of which may release
# and retake the GIL; decoders in several threads then wait on each other's
# switch interval at every call (8 threads took many times longer than one).
# One decoder at a time keeps it at the serial cost (zlib still runs in
# parallel).
_UNFILTER_LOCK = threading.Lock()


def _unfilter(raw: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    rows = raw.reshape(h, 1 + w * ch)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(types.max())}")
    filt = rows[:, 1:].reshape(h, w, ch)
    with _UNFILTER_LOCK:
        if types.max(initial=0) <= 2:
            return _unfilter_rows(filt, types)
        return _unfilter_wavefront(filt, types)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise UnsupportedImage(f"PNG bit depth {depth}, colour type {ctype}, interlace "
                               f"{interlace}: only 8-bit gray/RGB/RGBA, non-interlaced")
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    if len(raw) != h * (1 + w * ch):
        raise ValueError(f"PNG data has {len(raw)} bytes, expected {h * (1 + w * ch)}")
    img = _unfilter(np.frombuffer(raw, np.uint8), h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
