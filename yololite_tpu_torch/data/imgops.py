"""The image operations of host augmentation, drawing and the dataset
generators, in numpy, without cv2.

The card's machine has no cv2, so the port carries its own versions of the
OpenCV calls that `data/augment.py`, `data/weather.py`, `utils/viz.py` and
`tools/make_*.py` make. Each works on whole arrays (no per-pixel Python loop;
the contour tracer walks border pixels) and follows OpenCV 5.0's arithmetic,
which the JAX package's cv2 runs:

  - `warp_affine` / `remap` (INTER_LINEAR, BORDER_CONSTANT): OpenCV 5 inverts
    the 2x3 matrix in double, casts it to float32, maps each destination pixel
    with a fused multiply-add, and interpolates in float32 (three lerps),
    rounding half to even. `remap` takes the float
    source coordinates as given;
  - `resize_f32`: float bilinear, half-pixel centres, edge-clamped;
    `resize_cubic_f32`: INTER_CUBIC (a = -0.75, taps clamped to the edge),
    within 2 ulp of cv2 (its sums run in another order);
  - `gaussian_blur_f32` (`getGaussianKernel` weights) and `box_blur_u8`,
    separable, BORDER_REFLECT_101; `gaussian_blur3` (3x3, sigma 0: uint8
    in OpenCV's bit-exact fixed point, float in its probed op order); `box_blur2_u8` (the even 2x2 window,
    anchored at its lower right, OpenCV's 8-bit divide rounding up) and
    `box_blur_f32` (sums in double, as OpenCV's float path);
  - `line_blur3`: `filter2D` with a 3x3 kernel holding one line of 1/3;
  - pixel arithmetic: `convert_scale_abs` (fma in float32, round half to
    even), saturating `add_scalar` / `add_noise` (noise rounded first), `permute_channels`, `lut`;
  - `rgb2hsv` (OpenCV's integer division tables) and `hsv2rgb` (float32 with
    fma; OpenCV's vector loop truncates while the scalar tail of each row
    (width mod 32 pixels) rounds);
  - `convex_hull`, `fill_convex_poly` (OpenCV's fixed-point scanline fill
    and its 8-connected outline, at shift 0 or 16), `line` (`cv2.line`,
    LINE_8, clipped as `cv2.clipLine` clips; thicker lines as `ThickLine`
    quads with round caps), `fill_circle` (OpenCV's midpoint circle,
    filled) and `fill_ellipse` (`ellipse2Poly`'s polygon, filled);
  - `fill_poly`: `cv2.fillPoly` of one polygon with integer vertices (any
    shape: non-convex, self-intersecting, partly outside), OpenCV's edge
    collection and even-odd scanline fill in 16.16 fixed point, plus each
    edge's 8-connected line clipped as `cv2.clipLine` clips it;
  - `rectangle`: `cv2.rectangle` at any thickness (filled for < 0): each
    side of a thick outline is `ThickLine`'s quad, which is axis-aligned
    with integer corners for a rectangle, plus a round cap at each corner;
  - `text_size` / `put_text`: `cv2.getTextSize` / `cv2.putText` with
    FONT_HERSHEY_SIMPLEX at scale 0.5 thickness 1 and scale 0.8 thickness 2.
    OpenCV 5.0 draws the Hershey faces with its TrueType engine: each glyph's
    anti-aliased coverage is blended in at an integer pen position as
    round((dst * (255 - a) + color * a) / 255), glyph after glyph; the
    bitmaps are data (`data/font_simplex.py`, probed from cv2 by
    `tests/font_probe.py`);
  - `find_contours` / `contour_area`: `cv2.findContours` with RETR_CCOMP
    and CHAIN_APPROX_TC89_L1 (Suzuki-Abe border following, the two-level
    hierarchy, Teh-Chin approximation as OpenCV 5.0 runs it) and
    `cv2.contourArea`.
"""

from __future__ import annotations

import base64
import functools
import math
import zlib
from typing import Sequence, Tuple

import numpy as np

F32 = np.float32
HSV_VECTOR_PIXELS = 32      # pixels per step of OpenCV's HSV2RGB vector loop


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: a*b + c rounded once (the product of two
    float32 values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


# --------------------------------------------------------------------------- #
# Warps
# --------------------------------------------------------------------------- #

def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's inversion of a 2x3 matrix (in double), as a flat [6] array."""
    M = np.asarray(m, np.float64).reshape(6).copy()
    d = M[0] * M[4] - M[1] * M[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = M[4] * d, M[0] * d
    M[0], M[4] = a11, a22
    M[1] *= -d
    M[3] *= -d
    b1 = -M[0] * M[2] - M[1] * M[5]
    b2 = -M[3] * M[2] - M[4] * M[5]
    M[2], M[5] = b1, b2
    return M


def sample_bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                    border: float) -> np.ndarray:
    """uint8 [H,W,C] sampled at float32 source coordinates [h,w]; taps
    outside the image read `border`."""
    H, W = img.shape[:2]
    ch = img.shape[2]
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    a = (sx - x0).astype(F32)[..., None]
    b = (sy - y0).astype(F32)[..., None]
    # pad by 2 so every clipped tap of a far-outside point reads the border
    pad = np.full((H + 4, W + 4, ch), border, F32)
    pad[2:-2, 2:-2] = img
    flat = pad.reshape(-1, ch)
    xi = np.clip(x0, -2, W + 1).astype(np.int64) + 2
    yi = np.clip(y0, -2, H + 1).astype(np.int64) + 2
    xj = np.minimum(xi + 1, W + 3)
    yj = np.minimum(yi + 1, H + 3)
    f00 = np.take(flat, yi * (W + 4) + xi, axis=0)
    f01 = np.take(flat, yi * (W + 4) + xj, axis=0)
    f10 = np.take(flat, yj * (W + 4) + xi, axis=0)
    f11 = np.take(flat, yj * (W + 4) + xj, axis=0)
    # cv2 fuses these lerps; unfused float32 gives the same uint8 on every
    # value the tests draw, at a fraction of the cost of emulating the fma
    t0 = f00 + a * (f01 - f00)
    t1 = f10 + a * (f11 - f10)
    v = t0 + b * (t1 - t0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                border: int = 114) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize, INTER_LINEAR, BORDER_CONSTANT, border)."""
    w, h = dsize
    M = invert_affine(m).astype(F32)
    xs = np.arange(w, dtype=F32)
    ys = np.arange(h, dtype=F32)
    row_x = ys * M[1] + M[2]                       # float32, not fused
    row_y = ys * M[4] + M[5]
    sx = _fma32(M[0], xs[None, :], row_x[:, None])
    sy = _fma32(M[3], xs[None, :], row_y[:, None])
    out = sample_bilinear(np.asarray(img).reshape(img.shape[0], img.shape[1], -1),
                          sx, sy, border)
    return out.reshape((h, w) + img.shape[2:])


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          border: int = 114) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT, border)."""
    out = sample_bilinear(np.asarray(img).reshape(img.shape[0], img.shape[1], -1),
                          np.asarray(map_x, F32), np.asarray(map_y, F32), border)
    return out.reshape(map_x.shape + img.shape[2:])


# --------------------------------------------------------------------------- #
# Resize and blurs
# --------------------------------------------------------------------------- #

def _linear_taps(n_src: int, n_dst: int):
    """cv2's INTER_LINEAR source index and weight per destination index."""
    scale = n_src / n_dst
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(F32)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s >= n_src - 1
    f[high], s[high] = 0, n_src - 1
    return s, np.minimum(s + 1, n_src - 1), (F32(1) - f).astype(F32), f


def resize_f32(src: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize of a float32 [H,W] array to (w, h), INTER_LINEAR."""
    src = np.asarray(src, F32)
    x0, x1, ax0, ax1 = _linear_taps(src.shape[1], w)
    y0, y1, by0, by1 = _linear_taps(src.shape[0], h)
    rows = src[:, x0] * ax0 + src[:, x1] * ax1
    return (by0[:, None] * rows[y0] + by1[:, None] * rows[y1]).astype(F32)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Indices of a length-n axis padded by r on each side, BORDER_REFLECT_101."""
    i = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    return np.where(i >= n, period - i, i)


# getGaussianKernel's fixed kernels for sigma <= 0 and k <= 7 (exact in float32)
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(k, sigma, CV_32F): for sigma <= 0 the fixed
    table at k = 1, 3, 5, 7 (OpenCV 5.0 rounds larger sigma-0 kernels to
    fixed point, which the port does not follow: they raise)."""
    if sigma <= 0:
        if k not in _SMALL_GAUSSIAN:
            raise ValueError(f"gaussian_kernel: sigma <= 0 at k = {k} (1, 3, 5 or 7 only)")
        return np.asarray(_SMALL_GAUSSIAN[k], F32)
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t * (1.0 / t.sum())).astype(F32)


def _sep_filter(src: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Separable correlation of a float32 [H,W] array, rows then columns,
    BORDER_REFLECT_101."""
    H, W = src.shape
    rx, ry = len(kx) // 2, len(ky) // 2
    padded = src[:, _reflect101(W, rx)]
    rows = np.zeros((H, W), F32)
    for i, c in enumerate(kx):
        rows += padded[:, i:i + W] * c
    padded = rows[_reflect101(H, ry)]
    out = np.zeros((H, W), F32)
    for i, c in enumerate(ky):
        out += padded[i:i + H] * c
    return out


def gaussian_blur_f32(src: np.ndarray, k: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(src, (k, k), sigma) of a float32 [H,W] array."""
    kern = gaussian_kernel(k, sigma)
    return _sep_filter(np.asarray(src, F32), kern, kern)


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) of an [H,W] or [H,W,C] array, the
    kernel [1/4, 1/2, 1/4] each way, BORDER_REFLECT_101. uint8: OpenCV's
    bit-exact fixed point, (sum of the [1 2 1] x [1 2 1] taps + 8) >> 4.
    float64: rows as (a/4 + b/2) + c/4, then columns as b/2 + (a + c)/4;
    float32: both passes as b/2 + (a + c)/4 (the op orders probed on cv2)."""
    x = np.asarray(img)
    H, W = x.shape[:2]
    ry, rx = _reflect101(H, 1), _reflect101(W, 1)
    if x.dtype == np.uint8:
        p = x.astype(np.int32)[:, rx]
        rows = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
        p = rows[ry]
        return ((p[:-2] + 2 * p[1:-1] + p[2:] + 8) >> 4).astype(np.uint8)
    if x.dtype not in (np.float32, np.float64):
        raise ValueError(f"gaussian_blur3: uint8, float32 or float64, got {x.dtype}")
    q, h = x.dtype.type(0.25), x.dtype.type(0.5)
    p = x[:, rx]
    if x.dtype == np.float64:
        rows = (p[:, :-2] * q + p[:, 1:-1] * h) + p[:, 2:] * q
    else:
        rows = p[:, 1:-1] * h + (p[:, :-2] + p[:, 2:]) * q
    p = rows[ry]
    return p[1:-1] * h + (p[:-2] + p[2:]) * q


def box_blur_u8(src: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(src, (k, k)) of a uint8 [H,W] array: the k x k mean over a
    BORDER_REFLECT_101 border, rounded to nearest (no ties exist for odd
    k*k)."""
    H, W = src.shape
    r = k // 2
    x = np.asarray(src, np.int64)[_reflect101(H, r)][:, _reflect101(W, r)]
    c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    n = k * k
    return ((2 * s + n) // (2 * n)).astype(np.uint8)


def box_blur2_u8(src: np.ndarray) -> np.ndarray:
    """cv2.blur(src, (2, 2)) of a uint8 [H,W] or [H,W,C] array: each output
    pixel is the sum of itself and its upper, left and upper-left neighbours
    (the default anchor of an even kernel), BORDER_REFLECT_101, divided as
    OpenCV's 8-bit box filter divides by 4: (sum + 3) >> 2."""
    x = np.asarray(src, np.int32)
    H, W = x.shape[:2]
    p = x[_reflect101(H, 1)[:H + 1]][:, _reflect101(W, 1)[:W + 1]]
    s = p[:-1, :-1] + p[1:, :-1] + p[:-1, 1:] + p[1:, 1:]
    return ((s + 3) >> 2).astype(np.uint8)


def box_blur_f32(src: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(src, (k, k)) of a float32 [H,W] array, odd k: the window's
    sum in double (exact for these inputs, so in any order), times 1/k^2,
    rounded to float32; BORDER_REFLECT_101."""
    H, W = src.shape
    r = k // 2
    x = np.asarray(src, np.float64)[_reflect101(H, r)][:, _reflect101(W, r)]
    c = np.cumsum(np.cumsum(np.pad(x, ((1, 0), (1, 0))), 0), 1)
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return (s * (1.0 / (k * k))).astype(F32)


def _cubic_taps(n_src: int, n_dst: int):
    """cv2's INTER_CUBIC source indices [n_dst, 4] (clamped to the edge) and
    float32 weights (interpolateCubic, A = -0.75)."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(F32)
    s = np.floor(f).astype(np.int64)
    x = (f - s).astype(F32)
    A, one = F32(-0.75), F32(1)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_src - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(F32)


def resize_cubic_f32(src: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize of a float32 [H,W] array to (w, h), INTER_CUBIC: rows then
    columns, four taps each, in float32."""
    src = np.asarray(src, F32)
    xi, xc = _cubic_taps(src.shape[1], w)
    yi, yc = _cubic_taps(src.shape[0], h)
    rows = src[:, xi[:, 0]] * xc[:, 0]
    for k in range(1, 4):
        rows = rows + src[:, xi[:, k]] * xc[:, k]
    out = rows[yi[:, 0]] * yc[:, 0, None]
    for k in range(1, 4):
        out = out + rows[yi[:, k]] * yc[:, k, None]
    return out.astype(F32)


def line_blur3(img: np.ndarray, horizontal: bool) -> np.ndarray:
    """cv2.filter2D(img, -1, K) for a 3x3 K holding 1/3 along its middle
    row (horizontal) or column, BORDER_REFLECT_101: round((a+b+c)/3), where
    no sum of three integers lands on a half."""
    x = np.asarray(img, np.int32)
    axis = 1 if horizontal else 0
    n = x.shape[axis]
    idx = _reflect101(n, 1)
    p = np.take(x, idx, axis=axis)
    s = (np.take(p, np.arange(0, n), axis=axis) + np.take(p, np.arange(1, n + 1), axis=axis)
         + np.take(p, np.arange(2, n + 2), axis=axis))
    return ((s + 1) // 3).astype(np.uint8)


# --------------------------------------------------------------------------- #
# Pixel arithmetic
# --------------------------------------------------------------------------- #

def convert_scale_abs(img: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    """cv2.convertScaleAbs: |img*alpha + beta| in float32 (fused), rounded
    half to even, saturated to uint8."""
    v = _fma32(np.asarray(img, F32), F32(alpha), F32(beta))
    return np.clip(np.rint(np.abs(v)), 0, 255).astype(np.uint8)


def add_scalar(img: np.ndarray, shift: Sequence[float]) -> np.ndarray:
    """cv2.add(img, (s0, s1, s2, 0)) for integer shifts: saturating."""
    s = np.asarray(shift, np.int32)[: img.shape[-1]]
    return np.clip(np.asarray(img, np.int32) + s, 0, 255).astype(np.uint8)


def add_noise(img: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """cv2.add(img, noise, dtype=CV_8UC3) with float32 noise: cv2 rounds the
    noise to integers first (half to even), then adds with saturation."""
    n = np.rint(np.asarray(noise, F32)).astype(np.int64)
    return np.clip(np.asarray(img, np.int64) + n, 0, 255).astype(np.uint8)


def permute_channels(img: np.ndarray, perm: Sequence[int]) -> np.ndarray:
    """cv2.transform(img, m) with m[i, perm[i]] = 1: out[..., i] = img[..., perm[i]]."""
    return np.ascontiguousarray(np.asarray(img)[..., list(perm)])


def lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    """cv2.LUT(img, table) with a [256,1,C] table: each channel its own."""
    t = np.asarray(table).reshape(256, -1)
    return np.stack([t[img[..., c], c] for c in range(img.shape[-1])], -1)


# --------------------------------------------------------------------------- #
# HSV (H in [0, 180))
# --------------------------------------------------------------------------- #

_HSV_SHIFT = 12
_I = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I)]).astype(np.int32)
_HDIV180 = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I))]).astype(np.int32)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) for uint8 RGB (int32 suffices: the
    largest product is 255 * (255 << 12))."""
    x = np.asarray(img, np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


def hsv2rgb(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HSV2RGB) for uint8 HSV with H in [0, 180)."""
    img = np.asarray(img)
    h = img[..., 0].astype(F32) * F32(6.0 / 180)
    s = img[..., 1].astype(F32) * F32(1.0 / 255)
    v = img[..., 2].astype(F32) * F32(1.0 / 255)
    sector = np.trunc(h).astype(np.int64)
    hf = (h - sector).astype(F32)
    one = F32(1)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, hf, one),
                    v * _fma32(-s, one - hf, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector % 6], -1)
    rgb = bgr[..., ::-1] * F32(255)
    out = np.trunc(rgb)
    w = img.shape[-2]
    tail = w % HSV_VECTOR_PIXELS
    if tail:
        out[..., w - tail:, :] = np.rint(rgb[..., w - tail:, :])
    return np.clip(out, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# Drawing
# --------------------------------------------------------------------------- #

def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull of integer points (monotone chain, collinear points
    dropped), as an [K,2] int32 array."""
    p = sorted(set(map(tuple, np.asarray(pts, np.int64).tolist())))
    if len(p) < 3:
        return np.asarray(p, np.int32).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    for q in reversed(p):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1], np.int32)


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def fill_convex_poly(mask: np.ndarray, pts: np.ndarray, value, shift: int = 0) -> np.ndarray:
    """cv2.fillConvexPoly(mask, pts, value, LINE_8, shift) (in place), as
    OpenCV's `FillConvexPoly` runs it: the outline (at shift 0 the
    8-connected `line`, else `_line2` in 16.16 fixed point), then from the
    top vertex a left and a right edge walked down in 16.16 fixed point (dx
    from the rounded division of the edge's run by its rows, taken when the
    scan reaches the edge's first row; a vertex's row is its y rounded at
    `shift`), each row filled between their rounded x; the scan stops when
    either chain runs out of vertices."""
    v = np.asarray(pts, np.int64).reshape(-1, 2).tolist()
    n = len(v)
    H, W = mask.shape[:2]
    up = _XY_SHIFT - shift
    for i in range(n):
        if shift == 0:
            line(mask, v[i - 1], v[i], value)
        else:
            _line2(mask, [c << up for c in v[i - 1]], [c << up for c in v[i]], value)
    if n < 3:
        return mask
    delta = (1 << shift) >> 1
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return mask
    ymax = min(ymax, H - 1)
    # per chain: [vertex index, step, x, dx, first row past the edge]
    edge = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]
    y, left = ymin, n
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, idx = e[0], (e[0] + e[1]) % n
            while True:
                more, left = left > 0, left - 1
                if not more:
                    break
                ty = (ys[idx] + delta) >> shift
                if ty > y:
                    x0, x1 = xs[idx0] << up, xs[idx] << up
                    e[2] = x0
                    e[3] = _trunc_div(2 * (x1 - x0) + ty - y, 2 * (ty - y))
                    e[0], e[4] = idx, ty
                    break
                idx0, idx = idx, (idx + e[1]) % n
        if left < 0:
            break
        # rows until the next vertex of either chain: x moves by dx a row
        stop = min(edge[0][4], edge[1][4], ymax + 1)
        rows = np.arange(y, stop)
        xa = edge[0][2] + edge[0][3] * (rows - y)
        xb = edge[1][2] + edge[1][3] * (rows - y)
        lo = (np.minimum(xa, xb) + (_XY_ONE >> 1)) >> _XY_SHIFT
        hi = (np.maximum(xa, xb) + (_XY_ONE >> 1)) >> _XY_SHIFT
        for r, a, b in zip(rows, lo, hi):
            if r >= 0 and b >= 0 and a < W:
                mask[r, max(a, 0):min(b, W - 1) + 1] = value
        edge[0][2] += edge[0][3] * (stop - y)
        edge[1][2] += edge[1][3] * (stop - y)
        y = stop
        if y > ymax:
            break
    return mask


def _line2(img: np.ndarray, p1, p2, value) -> np.ndarray:
    """OpenCV's `Line2`: an 8-connected line between 16.16 fixed-point end
    points (in place), clipped to the image at that scale as `clipLine`
    clips; the major axis steps whole pixels from the first point (its
    fraction dropped), the minor one adds (d << 16) / (|major| | 1) a step,
    and the pixel of the rounded second point is set too."""
    H, W = img.shape[:2]
    inside, (x1, y1), (x2, y2) = clip_line(W << _XY_SHIFT, H << _XY_SHIFT, p1, p2)
    if not inside:
        return img
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy, x1, x2, y1, y2 = -dy, x2, x1, y2, y1
        step = _trunc_div(dy << _XY_SHIFT, ax | 1)
        k = np.arange(((x2 - x1) >> _XY_SHIFT) + 1)
        xs = ((x1 + (_XY_ONE >> 1)) >> _XY_SHIFT) + k
        ys = (y1 + (_XY_ONE >> 1) + step * k) >> _XY_SHIFT
    else:
        if dy < 0:
            dx, x1, x2, y1, y2 = -dx, x2, x1, y2, y1
        step = _trunc_div(dx << _XY_SHIFT, ay | 1)
        k = np.arange(((y2 - y1) >> _XY_SHIFT) + 1)
        xs = (x1 + (_XY_ONE >> 1) + step * k) >> _XY_SHIFT
        ys = ((y1 + (_XY_ONE >> 1)) >> _XY_SHIFT) + k
    xs = np.append(xs, (x2 + (_XY_ONE >> 1)) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + (_XY_ONE >> 1)) >> _XY_SHIFT)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[keep], xs[keep]] = value
    return img


def line8(img: np.ndarray, p0, p1, value) -> np.ndarray:
    """cv2.line(img, p0, p1, value) with LINE_8 and thickness 1 (in place):
    Bresenham from the left end point; the minor coordinate after k major
    steps is max(0, (2*minor*k + major - 1) // (2*major))."""
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = -1 if y1 < y0 else 1
    major, minor = max(dx, dy), min(dx, dy)
    k = np.arange(major + 1)
    c = np.maximum(0, (2 * minor * k + major - 1) // (2 * major)) if major else k
    if dy > dx:
        xs, ys = x0 + c, y0 + sy * k
    else:
        xs, ys = x0 + k, y0 + sy * c
    H, W = img.shape[:2]
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[keep], xs[keep]] = value
    return img


def clip_line(w: int, h: int, p1, p2):
    """cv2.clipLine to the rectangle [0, w) x [0, h): (inside, p1', p2'),
    the cut computed in double and truncated toward zero, as OpenCV does."""
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line(img: np.ndarray, p0, p1, value, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p0, p1, value, thickness) with LINE_8 (in place), for a
    pixel `value` of `img`'s type (see `_color`).

    Thickness 1: the 8-connected line, endpoints outside the image clipped
    first. Thicker, as OpenCV 5.0 draws it (probed): the segment clipped to
    the image grown by `thickness` on every side (`clip_line`, integer end
    points), then `ThickLine`: a quad around it whose half-width vector is
    (t + t % 2) / 2 pixels along the normal, rounded in 16.16 fixed point
    from double, filled by `fill_convex_poly` at shift 16, and a disc of
    radius (t + 1) // 2 (`fill_circle`) at each end."""
    H, W = img.shape[:2]
    if thickness > 1:
        t = int(thickness)
        inside, a, b = clip_line(W + 2 * t, H + 2 * t, (p0[0] + t, p0[1] + t),
                                 (p1[0] + t, p1[1] + t))
        if not inside:
            return img
        (x0, y0), (x1, y1) = (a[0] - t, a[1] - t), (b[0] - t, b[1] - t)
        dx, dy = float(x0 - x1), float(y1 - y0)
        r = dx * dx + dy * dy
        if abs(r) > np.finfo(np.float64).eps:
            r = ((t << (_XY_SHIFT - 1)) + (t & 1) * _XY_ONE * 0.5) / np.sqrt(r)
            ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
            X0, Y0, X1, Y1 = (c << _XY_SHIFT for c in (x0, y0, x1, y1))
            quad = [(X0 + ex, Y0 + ey), (X0 - ex, Y0 - ey), (X1 - ex, Y1 - ey),
                    (X1 + ex, Y1 + ey)]
            fill_convex_poly(img, quad, value, shift=_XY_SHIFT)
        for c in ((x0, y0), (x1, y1)):
            fill_circle(img, c, (t + 1) // 2, value)
        return img
    if not all(0 <= p[0] < W and 0 <= p[1] < H for p in (p0, p1)):
        inside, p0, p1 = clip_line(W, H, p0, p1)
        if not inside:
            return img
    return line8(img, p0, p1, value)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def fill_poly(img: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """cv2.fillPoly(img, [pts], value) for one polygon of integer vertices,
    LINE_8, shift 0 (in place).

    As OpenCV 5.0 does (probed against cv2 on random polygons): every edge
    is drawn as an 8-connected line; every non-horizontal edge becomes
    (y0, y1, x at y0, dx) in 16.16 fixed point with dx by C division; an
    edge that leaves the image takes the x of its clipped line (and its y
    too unless the clipped line is horizontal); each row y pairs the x's of
    the edges with y0 <= y < y1 in ascending order and fills
    [ceil(x_a), floor(x_b)] of each pair."""
    v = np.asarray(pts, np.int64).reshape(-1, 2)
    n = len(v)
    H, W = img.shape[:2]
    edges = []
    for i in range(n):
        (x0, y0), (x1, y1) = (int(c) for c in v[i - 1]), (int(c) for c in v[i])
        line(img, (x0, y0), (x1, y1), value)
        # fixed-point end points (pt0c/pt1c in OpenCV)
        ax, ay, bx, by = x0 << _XY_SHIFT, y0, x1 << _XY_SHIFT, y1
        if not (0 <= x0 < W and 0 <= x1 < W and 0 <= y0 < H and 0 <= y1 < H):
            _, (cx0, cy0), (cx1, cy1) = clip_line(W, H, (x0, y0), (x1, y1))
            ax, bx = cx0 << _XY_SHIFT, cx1 << _XY_SHIFT
            if cy0 != cy1:
                ay, by = cy0, cy1
        if y0 == y1:
            continue
        dx = _trunc_div(bx - ax, by - ay)
        if y0 < y1:
            edges.append((y0, y1, ax + (y0 - ay) * dx, dx))
        else:
            edges.append((y1, y0, bx + (y1 - by) * dx, dx))
    if len(edges) < 2:
        return img
    e = np.asarray(edges, np.int64)
    ey0, ey1, ex, edx = e.T
    xend = ex + (ey1 - ey0) * edx
    if (ey1.max() < 0 or ey0.min() >= H or max(ex.max(), xend.max()) < 0
            or min(ex.min(), xend.min()) >= (W << _XY_SHIFT)):
        return img
    rows = np.arange(max(int(ey0.min()), 0), min(int(ey1.max()), H))
    if not len(rows):
        return img
    active = (ey0[:, None] <= rows) & (rows < ey1[:, None])          # [E, R]
    big = np.iinfo(np.int64).max
    xs = np.where(active, ex[:, None] + (rows - ey0[:, None]) * edx[:, None], big)
    xs = np.sort(xs, axis=0)
    if len(xs) % 2:
        xs = np.concatenate([xs, np.full((1, len(rows)), big)])
    left, right = xs[0::2], xs[1::2]
    ok = right != big
    # the pixels whose left corner lies within the pair: ceil .. floor
    x1, x2 = (left + _XY_ONE - 1) >> _XY_SHIFT, right >> _XY_SHIFT
    ok &= (x1 < W) & (x2 >= 0)
    r = np.broadcast_to(np.arange(len(rows)), x1.shape)[ok]
    x1, x2 = np.maximum(x1[ok], 0), np.minimum(x2[ok], W - 1)
    diff = np.zeros((len(rows), W + 1), np.int32)
    np.add.at(diff, (r, x1), 1)
    np.add.at(diff, (r, x2 + 1), -1)
    fill = np.cumsum(diff[:, :W], axis=1) > 0
    img[rows[0]:rows[-1] + 1][fill] = value
    return img


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int, color) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1) (8-connected, no shift):
    the midpoint circle's half-width per row offset, filled (in place)."""
    cx, cy = int(center[0]), int(center[1])
    half = np.full(radius + 1, -1, np.int64)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        half[dy] = max(half[dy], dx)
        half[dx] = max(half[dx], dy)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    H, W = img.shape[:2]
    ys = np.arange(max(cy - radius, 0), min(cy + radius, H - 1) + 1)
    if len(ys) == 0:
        return img
    hw = half[np.abs(ys - cy)]
    xs = np.arange(W)
    inside = (hw[:, None] >= 0) & (np.abs(xs[None, :] - cx) <= hw[:, None])
    img[ys[0]:ys[-1] + 1][inside] = color
    return img


# OpenCV's SinTable: sin of each whole degree 0..450 rounded to 7 decimals, as
# float (probed through cv2.ellipse2Poly at axes of 2^30)
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(F32).astype(np.float64)


def fill_ellipse(img: np.ndarray, center: Tuple[int, int], axes: Tuple[int, int],
                 value) -> np.ndarray:
    """cv2.ellipse(img, center, axes, 0, 0, 360, value, -1) with LINE_8 (in
    place): `ellipse2Poly`'s polygon in 16.16 fixed point (a vertex every 90,
    30, 18 or 5 degrees as the larger axis is < 3, < 10, < 15 or more
    pixels; x = cx + a cos, y = cy + b sin from the float SinTable, in
    double, rounded; repeats dropped), filled by `fill_convex_poly` at
    shift 16."""
    cx, cy = int(center[0]) << _XY_SHIFT, int(center[1]) << _XY_SHIFT
    aw, ah = abs(int(axes[0])) << _XY_SHIFT, abs(int(axes[1])) << _XY_SHIFT
    d = (max(aw, ah) + (_XY_ONE >> 1)) >> _XY_SHIFT
    d = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    deg = np.minimum(np.arange(0, 360 + d, d), 360)
    px = np.rint(cx + aw * _SIN_TABLE[450 - deg]).astype(np.int64)
    py = np.rint(cy + ah * _SIN_TABLE[deg]).astype(np.int64)
    v = np.stack([px, py], 1)
    v = v[np.r_[True, (v[1:] != v[:-1]).any(1)]]
    if len(v) == 1:
        v = np.array([[cx, cy], [cx, cy]])
    return fill_convex_poly(img, v, value, shift=_XY_SHIFT)


def _color(img: np.ndarray, color) -> np.ndarray:
    """A cv2 colour scalar as a value of `img`'s pixels (its first C
    components; rounded and saturated for uint8)."""
    c = np.asarray(color, np.float64).reshape(-1)
    ch = img.shape[2] if img.ndim == 3 else 1
    c = np.concatenate([c, np.zeros(max(0, ch - len(c)))])[:ch]
    if img.dtype == np.uint8:
        c = np.clip(np.rint(c), 0, 255)
    return c.astype(img.dtype) if img.ndim == 3 else c[0].astype(img.dtype)


def _fill_rect(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, value) -> None:
    """Fill the pixels of [x0..x1] x [y0..y1] (either order) that lie in `img`."""
    H, W = img.shape[:2]
    xa, xb = max(min(x0, x1), 0), min(max(x0, x1), W - 1)
    ya, yb = max(min(y0, y1), 0), min(max(y0, y1), H - 1)
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = value


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, p1, p2, color, thickness) with LINE_8 (in place).

    Filled (thickness < 0): every pixel between the corners. Thickness 0 or
    1: the closed outline of 8-connected lines. Thicker: OpenCV's `ThickLine`
    for each side, whose quad is the side widened by (t + t % 2) / 2 pixels
    on each side of it, plus a disc of radius (t + 1) // 2 at the side's end
    (`fill_circle`); a side of zero length draws only its disc."""
    value = _color(img, color)
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    if thickness < 0:
        _fill_rect(img, x1, y1, x2, y2, value)
        return img
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness <= 1:
        for i in range(4):
            line(img, pts[i - 1], pts[i], value)
        return img
    d, r = (thickness + (thickness & 1)) // 2, (thickness + 1) // 2
    for i in range(4):
        (ax, ay), (bx, by) = pts[i - 1], pts[i]
        if ay == by and ax != bx:
            _fill_rect(img, ax, ay - d, bx, by + d, value)
        elif ax == bx and ay != by:
            _fill_rect(img, ax - d, ay, bx + d, by, value)
        fill_circle(img, (bx, by), r, value)
    return img


# --------------------------------------------------------------------------- #
# Text (FONT_HERSHEY_SIMPLEX as OpenCV 5.0 draws it)
# --------------------------------------------------------------------------- #

_FIRST_CHAR, _LAST_CHAR = 32, 126


@functools.lru_cache(maxsize=None)
def _font(scale: float, thickness: int):
    """(height, [(dx, dy, advance, coverage uint8 [h, w])] by character code
    from 32) of one size of the probed table."""
    from yololite_tpu_torch.data.font_simplex import GLYPHS
    key = (float(scale), int(thickness))
    if key not in GLYPHS:
        raise ValueError(f"text at scale {scale}, thickness {thickness}: the port draws "
                         f"FONT_HERSHEY_SIMPLEX at {sorted(GLYPHS)} (scale, thickness)")
    height, chunks = GLYPHS[key]
    blob = zlib.decompress(base64.b64decode("".join(chunks)))
    glyphs, at = [], 0
    for _ in range(_LAST_CHAR - _FIRST_CHAR + 1):
        dx, dy = np.frombuffer(blob[at:at + 2], np.int8).tolist()
        h, w, adv = blob[at + 2], blob[at + 3], blob[at + 4]
        at += 5
        cov = np.frombuffer(blob[at:at + h * w], np.uint8).reshape(h, w)
        at += h * w
        glyphs.append((dx, dy, adv, cov))
    return height, glyphs


def _glyph_codes(text: str):
    """Character codes into the table; anything outside printable ASCII is
    drawn as '?'."""
    return [ord(c) - _FIRST_CHAR if _FIRST_CHAR <= ord(c) <= _LAST_CHAR
            else ord("?") - _FIRST_CHAR for c in text]


def text_size(text: str, scale: float, thickness: int):
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, scale, thickness):
    ((width, height), baseline). The width is the advances' sum plus one,
    the height the font's, the baseline the deepest row any glyph reaches
    below the origin; an empty text measures ((0, 0), 0)."""
    height, glyphs = _font(scale, thickness)
    if not text:
        return (0, 0), 0
    gs = [glyphs[k] for k in _glyph_codes(text)]
    width = sum(g[2] for g in gs) + 1
    base = max([g[1] + g[3].shape[0] for g in gs if g[3].size] + [0])
    return (width, height), base


def put_text(img: np.ndarray, text: str, org, scale: float, color,
             thickness: int) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color,
    thickness) on a uint8 image (in place): each glyph's coverage a blends
    the colour in as round((dst * (255 - a) + color * a) / 255), glyph after
    glyph, clipped to the image."""
    _, glyphs = _font(scale, thickness)
    H, W = img.shape[:2]
    view = img.reshape(H, W, -1)
    col = np.asarray(_color(img, color), np.int32).reshape(-1)
    x, y = int(org[0]), int(org[1])
    for k in _glyph_codes(text):
        dx, dy, adv, cov = glyphs[k]
        x0, y0 = x + dx, y + dy
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + cov.shape[1], W), min(y0 + cov.shape[0], H)
        if xa < xb and ya < yb:
            a = cov[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int32)[..., None]
            dst = view[ya:yb, xa:xb].astype(np.int32)
            view[ya:yb, xa:xb] = (dst * (255 - a) + col * a + 127) // 255
        x += adv
    return img


# --------------------------------------------------------------------------- #
# Contours (cv2.findContours with RETR_CCOMP and CHAIN_APPROX_TC89_L1)
# --------------------------------------------------------------------------- #

# Freeman codes 0..7: right, up-right, up, up-left, left, down-left, down, down-right
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_ABS_DIFF = (1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3, 4, 3, 2, 1)   # 1-curvature of a turn


def _follow_border(flat: np.ndarray, i0: int, is_hole: bool, nbd: int, step: int) -> list:
    """Suzuki-Abe border following from pixel `i0` of the padded label image
    `flat`, as OpenCV's `icvFetchContourEx` runs it: the first neighbour
    searched clockwise from the left (outer border) or the right (hole), then
    counter-clockwise around each pixel from the one it came from; a pixel is
    marked -nbd where the search passed its right neighbour (a 0), else nbd
    if it was 1. Returns the Freeman chain (empty for a lone pixel)."""
    deltas = (1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1) * 2
    s_end = s = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if flat[i1] != 0 or s == s_end:
            break
    if s == s_end:
        flat[i0] = -nbd
        return []
    chain, i3 = [], i0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if flat[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:
            flat[i3] = -nbd
        elif flat[i3] == 1:
            flat[i3] = nbd
        chain.append(s)
        if i4 == i0 and i3 == i1:
            return chain
        i3 = i4
        s = (s + 4) & 7


def _approx_tc89_l1(chain: list, origin: Tuple[int, int]) -> list:
    """OpenCV 5.0's Teh-Chin approximation (CHAIN_APPROX_TC89_L1) of a closed
    Freeman chain, as probed on cv2 (49,303 contours of random masks, all
    equal). Pass 0: the points of non-zero 1-curvature s. Pass 1: each
    one's support region k (grown while the chord lengthens and the
    distance-to-chord ratio keeps its sign's trend, in the float32 sign
    test). Pass 2: drop a point if a point within k // 2 has a larger s.
    Pass 3: drop a k = 1 point not above both neighbours. A dropped point's
    s becomes 0. Pass 4, in index order from the head: where both ends of
    the chain survive (a run across the start), the s of the start's run
    but its last point are zeroed, the end's run after its first point is
    dropped, the walk starts at the start run's last point (if that run is
    the lone point 0 and the end's run the lone point n - 1, at 0's
    successor, with a copy of point 0 appended after point n - 1). Then
    each couple of adjacent survivors keeps the larger s (on a tie the
    first where its k <= the second's) and each longer run keeps its ends
    (the first run counted from the successor of the walk's start, or of
    point 0). Returns the surviving points in index order."""
    n = len(chain)
    if n == 0:
        return [origin]
    x, y = origin
    pts, S = [], []
    for i, code in enumerate(chain):
        pts.append((x, y))
        S.append(_ABS_DIFF[code - chain[i - 1] + 7])
        x += _CODE_DX[code]
        y += _CODE_DY[code]
    K = [0] * n
    for cur in range(n):                             # pass 1: support region
        if not S[cur]:
            continue
        x0, y0 = pts[cur]
        k, l, d_num = 1, 0, 0
        while True:
            xa, ya = pts[cur - k] if cur >= k else pts[cur - k + n]
            xb, yb = pts[cur + k - n] if cur + k >= n else pts[cur + k]
            dx, dy = xb - xa, yb - ya
            lk = dx * dx + dy * dy
            dk_num = (x0 - xa) * dy - (y0 - ya) * dx
            d = float(d_num) * lk - float(dk_num) * l       # only its sign matters
            if k > 1 and (l >= lk or (d_num > 0 and d <= 0)
                          or (d_num < 0 and (d > 0 or (d == 0 and math.copysign(1, d) > 0)))):
                break
            d_num, l = dk_num, lk
            k += 1
        K[cur] = k - 1
    for cur in range(n):                             # pass 2: non-maxima suppression
        if S[cur] and any(S[(cur - j) % n] > S[cur] or S[(cur + j) % n] > S[cur]
                          for j in range(1, (K[cur] >> 1) + 1)):
            S[cur] = 0
    for cur in range(n):                             # pass 3: k = 1, not dominant
        if S[cur] and K[cur] == 1 and (S[cur] <= S[cur - 1] or S[cur] <= S[(cur + 1) % n]):
            S[cur] = 0
    # pass 4: NXT[i] is the next survivor after i
    removed = [s == 0 for s in S] + [True]
    pts.append(pts[0])
    S.append(0)
    K.append(0)
    NXT = [-1] * (n + 1)
    nxt = -1
    for i in range(n - 1, -1, -1):
        NXT[i] = nxt
        if not removed[i]:
            nxt = i
    head, first = nxt, 0
    if S[0] and S[n - 1]:                            # a run across the start
        i1 = 1
        while i1 < n and S[i1]:
            S[i1 - 1] = 0
            i1 += 1
        if i1 == n:                                  # every point survived
            return [pts[i] for i in range(n) if not removed[i]]
        i1 -= 1
        i2 = n - 2
        while i2 > 0 and S[i2]:
            NXT[i2] = -1
            S[i2 + 1], removed[i2 + 1] = 0, True
            i2 -= 1
        if i1 == 0 and i2 + 1 == n - 1:              # the lone points 0 and n - 1
            i1 = NXT[0]
            S[n], K[n], removed[n] = S[0], K[0], False
            NXT[n - 1] = n
        head = first = i1
    cur, prev, count = head, -1, 1
    while cur >= 0:
        nx = NXT[cur]
        if nx < 0 or nx - cur != 1:
            if count == 2:
                if S[prev] > S[cur] or (S[prev] == S[cur] and K[prev] <= K[cur]):
                    removed[cur] = True
                else:
                    removed[prev] = True
            elif count > 2:
                j = NXT[NXT[first]]
                while 0 <= j != cur:
                    removed[j] = True
                    j = NXT[j]
            first, count = cur, 1
        else:
            count += 1
        prev, cur = cur, nx
    return [pts[i] for i in range(n + 1) if not removed[i]]


def find_contours(mask: np.ndarray):
    """cv2.findContours(mask, RETR_CCOMP, CHAIN_APPROX_TC89_L1) for a 2-D
    mask (non-zero is foreground): (contours, hierarchy), each contour an
    int32 [N, 1, 2] array of (x, y), the hierarchy int32 [1, N, 4] of (next,
    previous, first child, parent), or ((), None) for an empty mask.

    As OpenCV runs it: the mask's bounding box padded by one zero pixel, a
    raster scan that starts an outer border at a 0 -> 1 step and a hole
    border at a step from a pixel >= 1 (unlabelled, or labelled without the
    right-edge mark) to 0, each border followed (`_follow_border`) and
    approximated (`_approx_tc89_l1`). Outer borders are top level; a hole's
    parent is the outer border of the last labelled pixel before it on its
    row (or that border's parent if it is a hole). Each new contour goes to
    the front of its parent's children, and the list is the tree in
    depth-first order: outer borders last found first, each followed by its
    holes, last found first. The scan jumps between changes of a row with
    numpy; the border following walks the border's pixels."""
    m = np.asarray(mask) != 0
    if not m.any():
        return (), None
    rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
    oy, ox = int(rows[0]), int(cols[0])
    img = np.zeros((rows[-1] - oy + 3, cols[-1] - ox + 3), np.int64)
    img[1:-1, 1:-1] = m[oy:rows[-1] + 1, ox:cols[-1] + 1]
    H, W = img.shape
    flat = img.reshape(-1)
    holes, parents, points, owner = [], [], [], {}
    nbd = 2
    for y in range(1, H - 1):
        base, x, prev, lnbd = y * W, 1, 0, 0
        while x < W - 1:
            diff = np.flatnonzero(flat[base + x:base + W - 1] != prev)
            if not len(diff):
                break
            x += int(diff[0])
            p = int(flat[base + x])
            if prev == 0 and p == 1:
                is_hole = False
            elif p == 0 and prev >= 1:
                is_hole = True
                if prev != 1:
                    lnbd = x - 1
            else:
                prev = p
                if p not in (0, 1):
                    lnbd = x
                x += 1
                continue
            parent = -1
            if is_hole and lnbd > 0:
                parent = owner[abs(int(flat[base + lnbd]))]
                if holes[parent]:
                    parent = parents[parent]
            lnbd = x - is_hole
            chain = _follow_border(flat, base + lnbd, is_hole, nbd, W)
            owner[nbd] = len(holes)
            nbd += 1
            holes.append(is_hole)
            parents.append(parent)
            points.append(_approx_tc89_l1(chain, (lnbd, y)))
            prev = int(flat[base + x])
            x += 1
    # the tree in depth-first order, children last found first
    children = [[] for _ in holes]
    top = []
    for i, par in enumerate(parents):
        (top if par < 0 else children[par]).append(i)
    order = []

    def visit(level):
        for i in reversed(level):
            order.append(i)
            visit(children[i])
    visit(top)
    pos = {c: i for i, c in enumerate(order)}
    hier = np.full((1, len(order), 4), -1, np.int32)
    for i, c in enumerate(order):
        sib = top if parents[c] < 0 else children[parents[c]]
        k = sib.index(c)
        if k > 0:
            hier[0, i, 0] = pos[sib[k - 1]]
        if k + 1 < len(sib):
            hier[0, i, 1] = pos[sib[k + 1]]
        if children[c]:
            hier[0, i, 2] = pos[children[c][-1]]
        if parents[c] >= 0:
            hier[0, i, 3] = pos[parents[c]]
    shift = np.array([ox - 1, oy - 1], np.int32)
    contours = tuple((np.asarray(points[c], np.int32) + shift).reshape(-1, 1, 2)
                     for c in order)
    return contours, hier


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea(contour): half the absolute shoelace sum, in double
    (exact for integer points)."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(p) == 0:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return abs(float(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]))) * 0.5
