"""The image operations of host augmentation, in numpy, without cv2.

The card's machine has no cv2, so the port carries its own versions of the
OpenCV calls that `data/augment.py` and `data/weather.py` make. Each works on
whole arrays (no per-pixel Python loop) and follows OpenCV 5.0's arithmetic,
which the JAX package's cv2 runs:

  - `warp_affine` / `remap` (INTER_LINEAR, BORDER_CONSTANT): OpenCV 5 inverts
    the 2x3 matrix in double, casts it to float32, maps each destination pixel
    with a fused multiply-add, and interpolates in float32 (three lerps),
    rounding half to even. `remap` takes the float
    source coordinates as given;
  - `resize_f32`: float bilinear, half-pixel centres, edge-clamped;
  - `gaussian_blur_f32` (`getGaussianKernel` weights) and `box_blur_u8`,
    separable, BORDER_REFLECT_101;
  - `line_blur3`: `filter2D` with a 3x3 kernel holding one line of 1/3;
  - pixel arithmetic: `convert_scale_abs` (fma in float32, round half to
    even), saturating `add_scalar` / `add_noise` (noise rounded first), `permute_channels`, `lut`;
  - `rgb2hsv` (OpenCV's integer division tables) and `hsv2rgb` (float32 with
    fma; OpenCV's vector loop truncates while the scalar tail of each row
    (width mod 32 pixels) rounds);
  - `convex_hull`, `fill_convex_poly` (OpenCV's fixed-point scanline fill
    and its 8-connected outline) and `fill_circle` (OpenCV's midpoint
    circle, filled);
  - `fill_poly`: `cv2.fillPoly` of one polygon with integer vertices (any
    shape: non-convex, self-intersecting, partly outside), OpenCV's edge
    collection and even-odd scanline fill in 16.16 fixed point, plus each
    edge's 8-connected line clipped as `cv2.clipLine` clips it.
"""

from __future__ import annotations

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


def gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(k, sigma, CV_32F) for sigma > 0."""
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


def fill_convex_poly(mask: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """Fill a convex polygon of integer vertices into `mask` (in place), as
    cv2.fillConvexPoly's scanline pass: each row from the left edge to the
    right edge, edges walked in 16.16 fixed point, then the 8-connected
    outline (`line8`)."""
    v = np.asarray(pts, np.int64).reshape(-1, 2)
    n = len(v)
    H, W = mask.shape[:2]
    if n < 3:
        return mask
    ymin, ymax = int(v[:, 1].min()), int(v[:, 1].max())
    if v[:, 0].max() < 0 or ymax < 0 or v[:, 0].min() >= W or ymin >= H:
        return mask
    ymax = min(ymax, H - 1)
    imin = int(np.argmin(v[:, 1]))
    # the two chains from the top vertex, as (y_start, y_end, x_start, dx)
    # segments in fixed point: edge i steps +1 (di=1) or -1 (di=n-1)
    spans = []
    for di in (1, n - 1):
        segs, idx0, y = [], imin, ymin
        for _ in range(n):
            idx = (idx0 + di) % n
            ty = int(v[idx, 1])
            if ty > y:
                xs, xe = int(v[idx0, 0]) << _XY_SHIFT, int(v[idx, 0]) << _XY_SHIFT
                dx = ((xe - xs) * 2 + (ty - y)) // (2 * (ty - y))
                segs.append((y, ty, xs, dx))
                y = ty
            idx0 = idx
            if y >= ymax:
                break
        spans.append(segs)
    rows = np.arange(ymin, ymax + 1)
    xe = []
    for segs in spans:
        x = np.full(len(rows), np.iinfo(np.int64).min)
        for y0, y1, xs, dx in segs:
            sel = (rows >= y0) & (rows <= y1)
            x[sel] = xs + dx * (rows[sel] - y0)
        xe.append(x)
    ok = (xe[0] > np.iinfo(np.int64).min) & (xe[1] > np.iinfo(np.int64).min) & (rows >= 0)
    left = (np.minimum(xe[0], xe[1]) + (_XY_ONE >> 1)) >> _XY_SHIFT
    right = (np.maximum(xe[0], xe[1]) + (_XY_ONE >> 1)) >> _XY_SHIFT
    for r, lo, hi in zip(rows[ok], left[ok], right[ok]):
        if hi >= 0 and lo < W:
            mask[r, max(lo, 0):min(hi, W - 1) + 1] = value
    for i in range(n):
        line8(mask, v[i - 1], v[i], value)
    return mask


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


def _line8_clipped(img: np.ndarray, p0, p1, value) -> None:
    """cv2.line (LINE_8): endpoints outside the image are clipped first."""
    H, W = img.shape[:2]
    if not all(0 <= p[0] < W and 0 <= p[1] < H for p in (p0, p1)):
        inside, p0, p1 = clip_line(W, H, p0, p1)
        if not inside:
            return
    line8(img, p0, p1, value)


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
        _line8_clipped(img, (x0, y0), (x1, y1), value)
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
