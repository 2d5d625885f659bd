"""PyTorch port parity: host augmentation (`data/augment.py`,
`data/weather.py`, `data/imgops.py`) against the JAX package's cv2 pipeline
on the same `np.random.RandomState` (CPU).

Every call is made twice from one seed, once per package: the labels must be
equal, the boxes within 1e-4 px, and the RandomState's state equal after the
call (the port drew the same numbers in the same order). Pixels, each with
its reason:
  - exact: flips, brightness-contrast (fused float32 as cv2), colour jitter
    and HSV shift (cv2's integer RGB2HSV tables, its float HSV2RGB with the
    vector loop's truncation and the row tail's rounding, the LUT), RGB shift
    and noise (saturating adds), channel shuffle, motion blur (a 3-tap mean
    never lands on a half), coarse dropout, sun flare (cv2's midpoint circle);
  - within 1 level: the affine warp and the elastic remap (cv2 5's float
    bilinear; its scalar tail at a row's last columns rounds a few near-ties
    the other way: at most 1e-4 of the values), the shadow (cv2's fill and
    outline replicated; a rare rim pixel differs before the 25x25 blur);
  - the presets end in the letterbox resize, whose rounding is torch's, not
    cv2's (tests/test_torch_port_letterbox.py): within 1 level; with
    `use_resize` the square resize comes before the colour ops, which may
    widen its 1-level differences (RESIZED_TOL).
"""

import numpy as np
import pytest

from yololite_tpu.data import augment as J
from yololite_tpu.data import weather as JW

from yololite_tpu_torch.data import augment as P
from yololite_tpu_torch.data import weather as PW

SEEDS = range(20)
# a square resize before the colour ops: its 1-level differences pass
# through contrast (x1.2) and HSV (a near-gray pixel's hue moves), so up to
# RESIZED_TOL levels on at most RESIZED_SHARE of the values (2e-2 measured)
RESIZED_TOL, RESIZED_SHARE = 8, 3e-2


def _sample(seed):
    """An image of 64-96 px with flat and noisy regions, gray patches, and
    1-5 boxes."""
    rng = np.random.RandomState(1000 + seed)
    h, w = rng.randint(64, 97), rng.randint(64, 97)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    img[h // 4:h // 2, : w // 2] = rng.randint(0, 256, 3)
    img[h // 2:, w // 2:] = rng.randint(0, 256)
    n = rng.randint(1, 6)
    x1, y1 = rng.uniform(0, w - 8, n), rng.uniform(0, h - 8, n)
    boxes = np.stack([x1, y1, np.minimum(x1 + rng.uniform(4, w / 2, n), w),
                      np.minimum(y1 + rng.uniform(4, h / 2, n), h)], 1).astype(np.float32)
    return img, boxes, rng.randint(0, 3, n).astype(np.int64)


def _same_state(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:]
    np.testing.assert_array_equal(sa[1], sb[1])


def _pixels(got, want, tol, share=1.0, above=0):
    """Every value within `tol` levels; at most `share` of them more than
    `above` levels apart."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= tol, f"max diff {d.max()} > {tol}"
    assert (d > above).mean() <= share, f"{(d > above).mean():.2e} of the values differ"
    return d


IMAGE_OPS = {   # name: (reference, port, tolerance in levels, share allowed to differ)
    "brightness_contrast": (J.random_brightness_contrast, P.random_brightness_contrast, 0, 0),
    "color_jitter": (J.color_jitter, P.color_jitter, 0, 0),
    "hsv_shift": (J.hsv_shift, P.hsv_shift, 0, 0),
    "rgb_shift": (J.rgb_shift, P.rgb_shift, 0, 0),
    "channel_shuffle": (J.channel_shuffle, P.channel_shuffle, 0, 0),
    "gauss_noise": (J.gauss_noise, P.gauss_noise, 0, 0),
    "motion_blur": (J.motion_blur, P.motion_blur, 0, 0),
    "coarse_dropout": (J.coarse_dropout, P.coarse_dropout, 0, 0),
    "sunflare": (JW.add_sunflare, PW.add_sunflare, 0, 0),
    "shadow": (JW.add_shadow, PW.add_shadow, 1, 0.05),
}


@pytest.mark.parametrize("name", sorted(IMAGE_OPS))
def test_image_op_matches_jax(name):
    ref, port, tol, share = IMAGE_OPS[name]
    worst = 0.0
    for seed in SEEDS:
        img, _, _ = _sample(seed)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        want, got = ref(img, rj), port(img, rp)
        _same_state(rj, rp)
        d = _pixels(got, want, tol, share)
        worst = max(worst, float((d > 0).mean()))
    print(f"{name}: worst share of differing values {worst:.2e}")


BOX_OPS = {
    "hflip": (lambda i, b, r: J.hflip(i, b), lambda i, b, r: P.hflip(i, b), 0, 0),
    "vflip": (lambda i, b, r: J.vflip(i, b), lambda i, b, r: P.vflip(i, b), 0, 0),
    "random_affine": (J.random_affine, P.random_affine, 1, 1e-4),
    "elastic_transform": (J.elastic_transform, P.elastic_transform, 1, 1e-3),
}


@pytest.mark.parametrize("name", sorted(BOX_OPS))
def test_geometric_op_matches_jax(name):
    ref, port, tol, share = BOX_OPS[name]
    for seed in SEEDS:
        img, boxes, _ = _sample(seed)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        (wi, wb), (gi, gb) = ref(img, boxes, rj), port(img, boxes, rp)
        _same_state(rj, rp)
        _pixels(gi, wi, tol, share)
        np.testing.assert_allclose(gb, wb, atol=1e-4, rtol=0)


def test_affine_matrix_and_box_helpers_match_jax():
    for seed in SEEDS:
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        mj, mp = J.affine_matrix(80, 96, rj), P.affine_matrix(80, 96, rp)
        _same_state(rj, rp)
        assert mp.dtype == mj.dtype
        np.testing.assert_array_equal(mp, mj)
        _, boxes, labels = _sample(seed)
        np.testing.assert_array_equal(P._transform_boxes_affine(boxes, mp),
                                      J._transform_boxes_affine(boxes, mj))
        for args in ((96, 80), (40, 30)):
            bj, lj = J._filter_boxes(boxes * 1.3 - 5, labels, *args)
            bp, lp = P._filter_boxes(boxes * 1.3 - 5, labels, *args)
            np.testing.assert_array_equal(bp, bj)
            np.testing.assert_array_equal(lp, lj)


PRESETS = {   # name: (reference, port, tolerance, share more than 1 level apart)
    "base": (lambda s: J.TrainTransform(s), lambda s: P.TrainTransform(s), 1, 0),
    "base_resize": (lambda s: J.TrainTransform(s, use_resize=True),
                    lambda s: P.TrainTransform(s, use_resize=True), RESIZED_TOL, RESIZED_SHARE),
    "base_geometry_only": (lambda s: J.TrainTransform(s, p_color=0.0, p_noise=0.0),
                           lambda s: P.TrainTransform(s, p_color=0.0, p_noise=0.0), 1, 0),
    "strong": (lambda s: J.StrongTrainTransform(s), lambda s: P.StrongTrainTransform(s), 1, 0),
    "strong_geometry_only": (lambda s: J.StrongTrainTransform(s, photometric=False),
                             lambda s: P.StrongTrainTransform(s, photometric=False), 1, 0),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_matches_jax(name):
    ref_f, port_f, tol, share = PRESETS[name]
    ref_t, port_t = ref_f(64), port_f(64)
    worst, top = 0.0, 0
    for seed in range(40):
        img, boxes, labels = _sample(seed)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        wi, wb, wl = ref_t(img, boxes, labels, rj)
        gi, gb, gl = port_t(img, boxes, labels, rp)
        _same_state(rj, rp)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gb, wb, atol=1e-4, rtol=0)
        d = _pixels(gi, wi, tol, share, above=1)
        worst = max(worst, float((d > 1).mean()))
        top = max(top, int(d.max()))
    print(f"{name}: worst share of values more than 1 level apart {worst:.2e}, max {top}")


# --------------------------------------------------------------------------- #
# The image operations one by one against cv2
# --------------------------------------------------------------------------- #
import cv2  # noqa: E402

from yololite_tpu_torch.data import imgops  # noqa: E402

SIZES = [(64, 64), (61, 80), (72, 96), (17, 33)]


def _image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    img[h // 3:h // 2, : w // 2] = 200
    return img, rng


@pytest.mark.parametrize("hw", SIZES)
def test_pixel_ops_exact_against_cv2(hw):
    img, rng = _image(*hw)
    for _ in range(5):
        a, b = 1 + rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2) * 255
        np.testing.assert_array_equal(imgops.convert_scale_abs(img, a, b),
                                      cv2.convertScaleAbs(img, alpha=a, beta=b))
    sh = rng.randint(-20, 21, 3)
    np.testing.assert_array_equal(imgops.add_scalar(img, sh),
                                  cv2.add(img, tuple(float(s) for s in sh) + (0.0,)))
    noise = rng.standard_normal(img.shape).astype(np.float32) * np.float32(4.5)
    noise.flat[::7] = np.round(noise.flat[::7]) + 0.5            # exact halves: ties
    np.testing.assert_array_equal(imgops.add_noise(img, noise),
                                  cv2.add(img, noise, dtype=cv2.CV_8UC3))
    perm = rng.permutation(3)
    m = np.zeros((3, 3), np.float32)
    m[np.arange(3), perm] = 1
    np.testing.assert_array_equal(imgops.permute_channels(img, perm), cv2.transform(img, m))
    table = rng.randint(0, 256, (256, 1, 3)).astype(np.uint8)
    np.testing.assert_array_equal(imgops.lut(img, table), cv2.LUT(img, table))
    for horizontal in (True, False):
        k = np.zeros((3, 3), np.float32)
        k[(1, slice(None)) if horizontal else (slice(None), 1)] = 1 / 3
        np.testing.assert_array_equal(imgops.line_blur3(img, horizontal),
                                      cv2.filter2D(img, -1, k))
    mask = ((rng.rand(*hw) > 0.7) * 255).astype(np.uint8)
    np.testing.assert_array_equal(imgops.box_blur_u8(mask, 25), cv2.blur(mask, (25, 25)))


@pytest.mark.parametrize("width", [16, 80, 4096])
def test_hsv_conversions_exact_against_cv2(width):
    """Every RGB colour and every HSV triple (H < 180), in rows of `width`:
    80 = two vector steps of 32 and a 16-pixel scalar tail."""
    c = np.arange(1 << 24, dtype=np.int64)
    rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
    rgb = rgb[: (len(rgb) // width) * width].reshape(-1, width, 3)
    np.testing.assert_array_equal(imgops.rgb2hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = rgb[(rgb[..., 0] < 180).all(1)]
    np.testing.assert_array_equal(imgops.hsv2rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("hw", SIZES)
def test_warps_and_float_filters_against_cv2(hw):
    """Warps within 1 level on at most 1e-4 of the values (cv2's row tail);
    float resize and Gaussian blur within 1e-6 (float32 sums reordered)."""
    h, w = hw
    img, rng = _image(h, w, 1)
    for seed in range(5):
        m = J.affine_matrix(h, w, np.random.RandomState(seed))
        _pixels(imgops.warp_affine(img, m, (w, h)),
                cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_CONSTANT, borderValue=(114, 114, 114)),
                1, 1e-4)
    field = rng.uniform(-1, 1, (max(h // 8, 2), max(w // 8, 2))).astype(np.float32)
    up = cv2.resize(field, (w, h))
    np.testing.assert_allclose(imgops.resize_f32(field, w, h), up, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(imgops.gaussian_kernel(25, 6.25),
                                  cv2.getGaussianKernel(25, 6.25, ktype=cv2.CV_32F)[:, 0])
    dx = cv2.GaussianBlur(up, (25, 25), 6.25)
    np.testing.assert_allclose(imgops.gaussian_blur_f32(up, 25, 6.25), dx, atol=1e-6, rtol=0)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    mx, my = xs + 3 * dx, ys - 3 * dx[::-1]
    _pixels(imgops.remap(img, mx, my), cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                                                 borderMode=cv2.BORDER_CONSTANT,
                                                 borderValue=(114, 114, 114)), 1, 1e-4)


@pytest.mark.parametrize("hw", SIZES)
def test_drawing_against_cv2(hw):
    """Filled circles exact; filled convex hulls (scanline + 8-connected
    outline) on at most 5e-4 of the pixels apart: a rim pixel where cv2's
    outline clipping and the scanline's fixed point meet."""
    h, w = hw
    rng = np.random.RandomState(h * w)
    for _ in range(10):
        want = np.zeros((h, w, 3), np.float32)
        got = want.copy()
        center, r = (rng.randint(0, w), rng.randint(0, h // 2)), rng.randint(1, 60)
        cv2.circle(want, center, r, (255, 240, 200), -1)
        imgops.fill_circle(got, center, r, (255, 240, 200))
        np.testing.assert_array_equal(got, want)
        pts = np.stack([rng.randint(0, w, 5), rng.randint(h // 2, h, 5)], 1)
        want = np.zeros((h, w), np.uint8)
        got = want.copy()
        cv2.fillConvexPoly(want, cv2.convexHull(pts.astype(np.int32)), 255)
        imgops.fill_convex_poly(got, imgops.convex_hull(pts), 255)
        assert np.mean(got != want) <= 5e-4
