"""The OpenCV calls of the dataset generators, in `data/imgops.py`, against
the installed cv2 (OpenCV 5.0) on seeded inputs, all exactly:

  - `fill_ellipse`: cv2.ellipse(img, c, axes, 0, 0, 360, color, -1), centres
    near and past the edges, zero axes;
  - `line` at thickness 1-5 on uint8, float32 and float64 with float
    colours and ends outside the image (OpenCV 5.0 clips a thick line to the
    image grown by its thickness first);
  - `fill_convex_poly` at shift 16 (the fixed-point fill under both);
  - `fill_circle` and `fill_poly` on float32 patches with float colours and
    on uint8 masks (value 0 punches the ring's hole);
  - `gaussian_blur3` (3x3, sigma 0) on float32 and float64 3-channel and
    uint8 images, and `gaussian_kernel`'s sigma-0 table;
  - `find_contours` (RETR_CCOMP, CHAIN_APPROX_TC89_L1) and `contour_area`
    on random masks with holes, holes within holes, one-pixel blobs,
    diagonal touches and blobs on the border: the contours, their order and
    the hierarchy equal.
"""

import cv2
import numpy as np
import pytest

from yololite_tpu_torch.data import imgops


def test_fill_ellipse_equals_cv2():
    rng = np.random.RandomState(0)
    for trial in range(1500):
        h, w = rng.randint(1, 60, 2)
        c = tuple(int(v) for v in rng.randint(-30, 90, 2))
        axes = tuple(int(v) for v in rng.randint(0, 50, 2))
        if trial % 5 == 0:
            axes = (axes[0], 0)
        if trial % 7 == 0:
            axes = (0, 0)
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.ellipse(want, c, axes, 0, 0, 360, color, -1)
        got = imgops.fill_ellipse(np.zeros((h, w, 3), np.uint8), c, axes, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {c} {axes}")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_line_any_thickness_equals_cv2(dtype):
    rng = np.random.RandomState({np.uint8: 1, np.float32: 2, np.float64: 3}[dtype])
    for trial in range(1200):
        h, w = rng.randint(1, 50, 2)
        t = int(rng.randint(1, 6))
        p0 = tuple(int(v) for v in rng.randint(-25, 75, 2))
        p1 = p0 if trial % 9 == 0 else tuple(int(v) for v in rng.randint(-25, 75, 2))
        img = (rng.rand(h, w, 3) * 100).astype(dtype)
        color = tuple(float(v) for v in rng.rand(3) * 300 - 20)
        want = img.copy()
        cv2.line(want, p0, p1, color, t)
        got = imgops.line(img.copy(), p0, p1, imgops._color(img, color), t)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {p0} {p1} t={t}")


def test_fill_convex_poly_shift16_equals_cv2():
    rng = np.random.RandomState(4)
    for _ in range(1000):
        h, w = rng.randint(2, 40, 2)
        c = rng.rand(2) * [w, h]
        ang = np.sort(rng.rand(rng.randint(3, 9)) * 2 * np.pi)
        r = rng.rand() * 30 + 0.3
        pts = np.stack([c[0] + r * np.cos(ang) * rng.uniform(0.3, 1.5),
                        c[1] + r * np.sin(ang)], 1)
        fixed = np.round(pts * 65536).astype(np.int64)
        want = np.zeros((h, w), np.uint8)
        cv2.fillConvexPoly(want, fixed.astype(np.int32), 1, cv2.LINE_8, 16)
        got = imgops.fill_convex_poly(np.zeros((h, w), np.uint8), fixed, 1, shift=16)
        np.testing.assert_array_equal(got, want)


def test_circle_and_poly_on_float_patches_and_masks():
    """HardSynth's texture patches (float32, float colours) and shape masks
    (uint8, value 1, and 0 for the ring's hole)."""
    rng = np.random.RandomState(5)
    for _ in range(300):
        size = int(rng.randint(10, 121))
        color = rng.rand(3) * 255
        want = np.full((size, size, 3), 7.5, np.float32)
        got = want.copy()
        for _ in range(3):
            x, y, r = (int(v) for v in rng.randint(-5, size + 5, 3))
            r = abs(r) // 3
            cv2.circle(want, (x, y), r, tuple(map(float, color)), -1)
            imgops.fill_circle(got, (x, y), r, imgops._color(got, color))
        np.testing.assert_array_equal(got, want)
        want = np.zeros((size, size), np.uint8)
        got = want.copy()
        c, r = size // 2, size // 2 - 1
        cv2.circle(want, (c, c), r, 1, -1)
        cv2.circle(want, (c, c), max(1, int(r * 0.55)), 0, -1)
        imgops.fill_circle(got, (c, c), r, 1)
        imgops.fill_circle(got, (c, c), max(1, int(r * 0.55)), 0)
        np.testing.assert_array_equal(got, want)
        pts = rng.randint(-3, size + 3, (int(rng.randint(3, 11)), 2)).astype(np.int32)
        want = np.zeros((size, size), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        np.testing.assert_array_equal(imgops.fill_poly(np.zeros_like(want), pts, 1), want)
        patch = np.zeros((size, size, 3), np.float32)
        want = patch.copy()
        cv2.fillPoly(want, [pts], tuple(map(float, color)))
        np.testing.assert_array_equal(
            imgops.fill_poly(patch, pts, imgops._color(patch, color)), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 3, 3), (47, 33, 3), (64, 91), (160, 107, 3)])
def test_gaussian_blur3_equals_cv2(dtype, shape):
    rng = np.random.RandomState(6)
    if dtype == np.uint8:
        x = rng.randint(0, 256, shape).astype(np.uint8)
    else:
        x = (rng.rand(*shape) * 300 - 20 + rng.randn(*shape)).astype(dtype)
    want = cv2.GaussianBlur(x, (3, 3), 0)
    got = imgops.gaussian_blur3(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_gaussian_kernel_sigma0_table():
    for k in (1, 3, 5, 7):
        np.testing.assert_array_equal(imgops.gaussian_kernel(k, 0),
                                      cv2.getGaussianKernel(k, 0, ktype=cv2.CV_32F)[:, 0])
    with pytest.raises(ValueError):
        imgops.gaussian_kernel(9, 0)


def _masks(seed: int, n: int):
    """Random masks of every kind the suite draws, plus the corner cases."""
    rng = np.random.RandomState(seed)
    out = [np.zeros((5, 5), np.uint8), np.ones((1, 1), np.uint8), np.ones((3, 4), np.uint8),
           np.eye(6, dtype=np.uint8), np.eye(6, dtype=np.uint8)[::-1] * 255]
    ring = np.zeros((30, 30), np.uint8)              # holes within holes, nested blobs
    for r, v in ((14, 1), (11, 0), (8, 1), (5, 0), (2, 1)):
        cv2.circle(ring, (15, 15), r, v, -1)
    out.append(ring)
    for i in range(n):
        h, w = rng.randint(1, 40, 2)
        kind = i % 4
        if kind == 0:                               # noise: lone pixels, diagonal touches
            m = (rng.rand(h, w) < rng.uniform(0.2, 0.8)).astype(np.uint8)
        elif kind == 1:                             # blobs with holes, on the border too
            m = np.zeros((h, w), np.uint8)
            for _ in range(rng.randint(1, 5)):
                c = (int(rng.randint(0, w)), int(rng.randint(0, h)))
                r = int(rng.randint(1, 15))
                cv2.circle(m, c, r, 1, -1)
                cv2.circle(m, c, max(0, r // 2 - 1), 0, -1)
        elif kind == 2:                             # smooth regions
            m = (cv2.resize(rng.rand(max(h // 3, 1), max(w // 3, 1)), (int(w), int(h)))
                 > 0.5).astype(np.uint8)
        else:                                       # any non-zero value is foreground
            m = ((rng.rand(h, w) < 0.5) * rng.randint(1, 255)).astype(np.uint8)
        out.append(m)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_contours_and_area_equal_cv2(seed):
    for m in _masks(seed, 700):
        want, want_h = cv2.findContours(m.copy(), cv2.RETR_CCOMP, cv2.CHAIN_APPROX_TC89_L1)
        got, got_h = imgops.find_contours(m)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.int32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            assert imgops.contour_area(a) == cv2.contourArea(b)
        if want_h is None:
            assert got_h is None
        else:
            np.testing.assert_array_equal(got_h, want_h)


def test_find_contours_of_instance_masks():
    """Full-frame visible masks as HardSynth makes them: a few shapes, later
    ones occluding earlier ones (rings, stars, slivers at the frame's edge)."""
    rng = np.random.RandomState(9)
    for _ in range(60):
        h, w = 427, 640
        vis = np.zeros((h, w), np.uint8)
        for _ in range(3):
            size = int(rng.randint(10, 121))
            x, y = int(rng.randint(-20, w - 5)), int(rng.randint(-20, h - 5))
            cv2.circle(vis, (x + size // 2, y + size // 2), size // 2 - 1, 1, -1)
            cv2.circle(vis, (x + size // 2, y + size // 2), int((size // 2 - 1) * 0.55), 0, -1)
        for _ in range(2):
            x, y = int(rng.randint(0, w)), int(rng.randint(0, h))
            cv2.rectangle(vis, (x, y), (x + int(rng.randint(5, 60)), y + int(rng.randint(5, 60))), 0, -1)
        want, want_h = cv2.findContours(vis.copy(), cv2.RETR_CCOMP, cv2.CHAIN_APPROX_TC89_L1)
        got, got_h = imgops.find_contours(vis)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if want:
            np.testing.assert_array_equal(got_h, want_h)
