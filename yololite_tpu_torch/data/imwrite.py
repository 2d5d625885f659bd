"""Image writers, in numpy and the standard library (the card's machine has
no cv2): `imwrite_bgr(path, img)` picks the encoder by the file's extension,
as `cv2.imwrite` does.

  - `.jpg` / `.jpeg`: baseline JPEG, 4:2:0, at cv2's default quality 95
    (`write_jpeg`): the IJG quality-scaled quantization tables and the
    standard Huffman tables of JPEG Annex K (libjpeg's defaults), an
    orthonormal float DCT; any height and width (the last MCUs repeat the
    edge pixels, as libjpeg pads);
  - `.png`: 8-bit RGB, each row's filter chosen as libpng's heuristic does,
    zlib (`write_png`);
  - `.bmp`: 24-bit, bottom-up rows padded to 4 bytes (`write_bmp`);
  - `.tif` / `.tiff`: what cv2.imwrite writes by default (`write_tiff`):
    chunky 8-bit RGB, LZW with horizontal differencing (Predictor 2), strips
    of 8 KiB of rows, little-endian; the LZW coder is the host codec
    library's (`csrc/imgcodec.cpp`, built at first use).

Any other extension raises `ValueError` naming it. The files decode with
`cv2.imread` and with the port's own codecs (`data/codecs.py`): PNG, BMP and
TIFF to the array written, JPEG within its quantization.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

JPEG_QUALITY = 95           # cv2.imwrite's default IMWRITE_JPEG_QUALITY


def imwrite_bgr(path: str, img: np.ndarray) -> None:
    """Write a BGR uint8 [H, W, 3] image; the encoder follows the extension."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: expected a BGR uint8 [H, W, 3] image, got "
                         f"{img.dtype} {img.shape}")
    ext = os.path.splitext(path)[1].lower()
    rgb = img[..., ::-1]
    if ext in (".jpg", ".jpeg"):
        write_jpeg(path, rgb, JPEG_QUALITY)
    elif ext == ".png":
        write_png(path, rgb)
    elif ext == ".bmp":
        write_bmp(path, rgb)
    elif ext in (".tif", ".tiff"):
        write_tiff(path, rgb)
    else:
        raise ValueError(f"{path}: cannot write {ext or 'a file without an extension'!r} "
                         f"images (the port writes .jpg, .jpeg, .png, .bmp, .tif and .tiff)")


def write_bmp(path: str, rgb: np.ndarray) -> None:
    """24-bit BI_RGB BMP of an RGB uint8 [H, W, 3] image."""
    h, w, _ = rgb.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(head + info + rows.tobytes())


def _lzw(data: bytes) -> bytes:
    from yololite_tpu_torch.data.codecs import library
    out = np.empty(2 * len(data) + 16, np.uint8)      # 12-bit codes never need more
    n = library().yl_lzw_encode(data, len(data), out.ctypes.data, out.size)
    return out[:n].tobytes()


def write_tiff(path: str, rgb: np.ndarray) -> None:
    """TIFF of an RGB uint8 [H, W, 3] image as cv2.imwrite writes one by
    default: LZW, Predictor 2, chunky RGB, rows per strip 8192 // row bytes."""
    h, w, _ = rgb.shape
    rps = max(1, min(h, 8192 // (3 * w)))
    strips = []
    for y in range(0, h, rps):
        rows = rgb[y:y + rps].reshape(-1, 3 * w).astype(np.int16)
        rows[:, 3:] -= rows[:, :-3].copy()
        strips.append(_lzw((rows & 0xFF).astype(np.uint8).tobytes()))
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s) + (len(s) & 1)
    extra = pos                                  # arrays that do not fit in an entry
    fields = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [5]), (262, 3, [2]),
              (273, 4, offsets), (277, 3, [3]), (278, 4, [rps]), (279, 4, [len(s) for s in strips]),
              (284, 3, [1]), (317, 3, [2]), (339, 3, [1, 1, 1])]
    blobs, entries = b"", b""
    for tag, typ, vals in fields:
        data = struct.pack("<" + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(data) <= 4:
            entries += struct.pack("<HHI", tag, typ, len(vals)) + data.ljust(4, b"\0")
        else:
            entries += struct.pack("<HHII", tag, typ, len(vals), extra + len(blobs))
            blobs += data
    ifd = extra + len(blobs)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", ifd))
        for s in strips:
            f.write(s + b"\0" * (len(s) & 1))
        f.write(blobs + struct.pack("<H", len(fields)) + entries + b"\0\0\0\0")


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """8-bit RGB PNG, each row's filter chosen as libpng's heuristic does (the
    least sum of |filtered byte| as signed), so all five filters occur."""
    h, w, _ = rgb.shape
    x = rgb.astype(np.int16)
    up = np.concatenate([np.zeros((1, w, 3), np.int16), x[:-1]], 0)
    left = np.concatenate([np.zeros((h, 1, 3), np.int16), x[:, :-1]], 1)
    upleft = np.concatenate([np.zeros((h, 1, 3), np.int16), up[:, :-1]], 1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cands = np.stack([x, x - left, x - up, x - ((left + up) >> 1), x - paeth]) & 0xFF
    cost = np.abs(cands.astype(np.int8).astype(np.int16)).sum((2, 3))      # [5, h]
    best = cost.argmin(0)
    rows = np.concatenate([best[:, None].astype(np.uint8),
                           cands[best, np.arange(h)].reshape(h, -1).astype(np.uint8)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


# --------------------------------------------------------------------------- #
# Baseline JPEG
# --------------------------------------------------------------------------- #

_JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_JPEG_QBASE = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24,
              40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103,
              77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72,
              92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99,
              99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32))
_JPEG_HUFF = {   # (class, id): (counts of lengths 1-16, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], [
        1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145,
        161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130, 9, 10, 22, 23, 24,
        25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72,
        73, 74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115,
        116, 117, 118, 119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147,
        148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178,
        179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202,
        210, 211, 212, 213, 214, 215, 216, 217, 218, 225, 226, 227, 228, 229, 230, 231, 232,
        233, 234, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250]),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
        0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66,
        145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37,
        241, 23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71,
        72, 73, 74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106,
        115, 116, 117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138,
        146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169,
        170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200,
        201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 226, 227, 228, 229, 230, 231,
        232, 233, 234, 242, 243, 244, 245, 246, 247, 248, 249, 250]),
}
_YCC = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                 [0.5, -0.418688, -0.081312]], np.float32)   # JFIF's RGB -> YCbCr
_N = np.arange(8)
_DCT = np.sqrt(np.where(_N == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
    (2 * _N[None, :] + 1) * _N[:, None] * np.pi / 16)        # orthonormal DCT-II rows
# the 2-D DCT of a raster-order 8x8 block as one matrix, its outputs in
# zigzag order: coefficients = block (64,) @ _DCT2
_DCT2 = np.kron(_DCT, _DCT).T[:, _JPEG_ZIGZAG]


def _jpeg_codes(counts, symbols):
    """Canonical Huffman codes as (code, length) arrays indexed by symbol."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


# per class (0 DC, 1 AC): code and length arrays indexed by 256 * chroma + symbol
_JPEG_CODES = {cls: np.concatenate([_jpeg_codes(*_JPEG_HUFF[(cls, t)])[0] for t in (0, 1)])
               for cls in (0, 1)}
_JPEG_LENS = {cls: np.concatenate([_jpeg_codes(*_JPEG_HUFF[(cls, t)])[1] for t in (0, 1)])
              for cls in (0, 1)}


def _jpeg_blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """[H, W] samples (multiples of 8) -> quantized coefficients [N, 64] in
    zigzag order, blocks in raster order."""
    h, w = plane.shape
    blk = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    coef = (blk - 128.0) @ _DCT2
    return np.round(coef / q[_JPEG_ZIGZAG]).astype(np.int32)


def _size_of(v: np.ndarray) -> np.ndarray:
    """JPEG's magnitude category: the bit length of |v|."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _symbols(cls, chroma, sym, value, size):
    """(code followed by the value's bits, total length) of each symbol: a
    negative value is sent as value - 1 in `size` bits."""
    at = (chroma << 8) + sym
    value = value.astype(np.int64)
    bits = value + ((value >> 63) & ((1 << size) - 1))
    return (_JPEG_CODES[cls][at] << size) | bits, _JPEG_LENS[cls][at] + size


def _pack_bits(codes: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate variable-length codes (<= 27 bits each) MSB first, pad
    the last byte with ones and stuff a zero after every 0xFF."""
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    starts = ends - lens
    # each code aligned in a 40-bit window starting at its first byte
    win = codes << (40 - (starts & 7) - lens)
    byte0 = starts >> 3
    n = (total + 7) >> 3
    out = np.zeros(n + 5, np.float64)
    for j in range(5):          # disjoint bits: the sums are ORs
        out += np.bincount(byte0 + j, weights=((win >> (32 - 8 * j)) & 0xFF).astype(
            np.float64), minlength=n + 5)
    data = out[:n].astype(np.uint8)
    if total & 7:
        data[-1] |= (1 << (8 - (total & 7))) - 1
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).astype(np.uint8).tobytes()


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 90) -> None:
    """A baseline 4:2:0 JPEG file of an RGB uint8 [H, W, 3] image."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))


def encode_jpeg(rgb: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """A baseline 4:2:0 JPEG of an RGB uint8 [H, W, 3] image, as bytes."""
    h, w, _ = rgb.shape
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qt = [np.clip((b * scale + 50) // 100, 1, 255) for b in _JPEG_QBASE]
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(rgb, ((0, H - h), (0, W - w), (0, 0)), mode="edge").astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    ycc = [_YCC[k, 0] * r + _YCC[k, 1] * g + _YCC[k, 2] * b for k in range(3)]
    luma = _jpeg_blocks(np.clip(np.round(ycc[0]), 0, 255), qt[0])
    chroma = [_jpeg_blocks(np.clip(np.round(ycc[k].reshape(H // 2, 2, W // 2, 2)
                                            .mean((1, 3)) + 128), 0, 255), qt[1])
              for k in (1, 2)]
    # MCU order: four luma blocks (2x2), then Cb, then Cr
    my, mx = H // 16, W // 16
    luma = luma.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    blocks = np.concatenate([luma, chroma[0][:, None], chroma[1][:, None]], 1)   # [MCUs, 6, 64]
    comp = np.array([0, 0, 0, 0, 1, 2])
    dc = blocks[..., 0]
    prev = np.zeros_like(dc)
    for k in range(3):                  # DC differences within each component
        seq = dc[:, comp == k].reshape(-1)
        prev[:, comp == k] = np.concatenate([[0], seq[:-1]]).reshape(-1, int((comp == k).sum()))
    # the symbols block by block: the DC difference, each nonzero AC after
    # the ZRLs (16 zeros) its run needs, then EOB unless the block ends on a
    # nonzero; each symbol's place in the stream is counted, not sorted
    flat = blocks.reshape(-1, 64)
    n_blocks = len(flat)
    chroma = (comp[np.arange(n_blocks) % 6] != 0).astype(np.int64)
    b, k = np.nonzero(flat[:, 1:])
    k = k + 1
    run = k - np.where(np.r_[True, b[1:] != b[:-1]], 0, np.r_[0, k[:-1]]) - 1
    z = run >> 4
    lastk = np.zeros(n_blocks, np.int64)
    lastk[b] = k
    eob = lastk < 63
    ac = np.bincount(b, weights=1 + z, minlength=n_blocks).astype(np.int64)
    per_block = 1 + ac + eob
    start = np.cumsum(per_block) - per_block
    # each AC's place (its ZRLs just before it): after the DC and the
    # earlier ACs and ZRLs of its block
    at = start[b] + np.cumsum(1 + z) - (np.cumsum(ac) - ac)[b]
    codes = np.zeros(int(per_block.sum()), np.int64)
    lens = np.zeros_like(codes)
    d = (dc - prev).reshape(-1)
    sz = _size_of(d)
    codes[start], lens[start] = _symbols(0, chroma, sz, d, sz)
    v = flat[b, k]
    sz = _size_of(v)
    codes[at], lens[at] = _symbols(1, chroma[b], ((run & 15) << 4) | sz, v, sz)
    if z.any():
        owner = np.repeat(np.arange(len(z)), z)
        zat = at[owner] - (np.arange(len(owner)) - np.repeat(np.cumsum(z) - z, z)) - 1
        at_zrl = (chroma[b[owner]] << 8) + 0xF0
        codes[zat], lens[zat] = _JPEG_CODES[1][at_zrl], _JPEG_LENS[1][at_zrl]
    ends = (start + per_block - 1)[eob]
    codes[ends], lens[ends] = _JPEG_CODES[1][chroma[eob] << 8], _JPEG_LENS[1][chroma[eob] << 8]
    data = _pack_bits(codes, lens)

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body
    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, t in enumerate(qt):
        out.append(seg(0xDB, bytes([i]) + t.astype(np.uint8)[_JPEG_ZIGZAG].tobytes()))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1,
                                                                    3, 0x11, 1])))
    for (cls, t_id), (counts, symbols) in _JPEG_HUFF.items():
        out.append(seg(0xC4, bytes([cls << 4 | t_id] + counts + symbols)))
    out.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out) + data + b"\xff\xd9"


# --------------------------------------------------------------------------- #
# a video stream in a RIFF AVI (Motion-JPEG by default; mp4v for data/video.py)
# --------------------------------------------------------------------------- #

class AviWriter:
    """One video stream in an AVI 1.0 file (an idx1 index), each frame
    encoded as it comes: by default Motion-JPEG (`encode_jpeg` at quality
    95), else by `encode` (BGR frame -> bytes) under `fourcc`; the headers'
    sizes and counts are filled in by `close`."""

    def __init__(self, path: str, fps: float, size, fourcc: bytes = b"MJPG", encode=None):
        self.w, self.h = int(size[0]), int(size[1])
        self.fps = float(fps)
        self.fourcc = fourcc
        self.encode = encode or (lambda frame: encode_jpeg(frame[..., ::-1]))
        self.f = open(path, "wb")
        self.index = []                 # (offset from the 'movi' fourcc, size)
        self.f.write(self._headers(0, 0, 0))
        self.movi = self.f.tell() - 4   # the 'movi' fourcc

    def _headers(self, riff_size: int, movi_size: int, frames: int) -> bytes:
        w, h = self.w, self.h
        rate, scale = int(round(self.fps * 1000)), 1000
        avih = struct.pack("<IIIIIIIIII16x", int(round(1e6 / self.fps)), 0, 0, 0x10,
                           frames, 0, 1, w * h * 3, w, h)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", self.fourcc, 0, 0, 0, 0, scale,
                           rate, 0, frames, w * h * 3, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, self.fourcc, w * h * 3, 0, 0,
                           0, 0)
        strl = (b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8 + len(strf)) + b"strl"
                + b"strh" + struct.pack("<I", len(strh)) + strh
                + b"strf" + struct.pack("<I", len(strf)) + strf)
        hdrl = (b"hdrl" + b"avih" + struct.pack("<I", len(avih)) + avih + strl)
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI "
                + b"LIST" + struct.pack("<I", len(hdrl)) + hdrl
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, frame_bgr: np.ndarray) -> None:
        if frame_bgr.shape[:2] != (self.h, self.w):
            raise ValueError(f"frame {frame_bgr.shape[:2]} differs from the video's "
                             f"{(self.h, self.w)}")
        data = self.encode(frame_bgr)
        self.index.append((self.f.tell() - self.movi, len(data)))
        self.f.write(b"00dc" + struct.pack("<I", len(data)) + data
                     + b"\x00" * (len(data) & 1))

    def close(self) -> None:
        if self.f is None:
            return
        end = self.f.tell()
        self.f.write(b"idx1" + struct.pack("<I", 16 * len(self.index)))
        for off, n in self.index:
            self.f.write(b"00dc" + struct.pack("<III", 0x10, off, n))
        total = self.f.tell()
        self.f.seek(0)
        self.f.write(self._headers(total - 8, end - self.movi, len(self.index)))
        self.f.close()
        self.f = None
