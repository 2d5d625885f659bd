"""Host-side augmentation with box tracking (port of `data/augment.py`).

The reference's Albumentations pipelines, re-implemented on numpy with the
port's own image operations (`data/imgops.py`, no cv2):

  TrainTransform (get_base_transform): HFlip/VFlip p=0.3, optional square
    resize, Affine (rot +-20 deg, shear +-10 deg, scale .85-1.15, translate
    5-10%) p=0.2 with border 114, one of five colour ops p=0.4
    (brightness-contrast / colour jitter / HSV / RGB shift / channel
    shuffle), noise or motion blur p=0.15, letterbox, boxes filtered at
    min_visibility 0.25 / min_area 16;
  StrongTrainTransform (get_strong_transform, `aug_preset: strong`);
  ValTransform: letterbox (or square resize) only.

Each function draws from the caller's `np.random.RandomState` in the JAX
package's order and number of draws, so a seed gives the reference's sample.
The canvases are uint8; normalisation happens on the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data.weather import add_shadow, add_sunflare
from yololite_tpu_torch.ops.letterbox import letterbox_image, resize_image

PAD = 114
NOISE_POOL_N = 1 << 23  # 8M floats (32 MB), read-only, shared across threads


# --------------------------------------------------------------------------- #
# Geometry helpers
# --------------------------------------------------------------------------- #

def _transform_boxes_affine(boxes: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to xyxy boxes -> AABB of the 4 transformed corners."""
    if len(boxes) == 0:
        return boxes
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack([
        np.stack([x1, y1], -1), np.stack([x2, y1], -1),
        np.stack([x1, y2], -1), np.stack([x2, y2], -1),
    ], axis=1)  # [N,4,2]
    ones = np.ones((*corners.shape[:2], 1), np.float32)
    pts = np.concatenate([corners, ones], -1) @ m.T  # [N,4,2]
    return np.concatenate([pts.min(1), pts.max(1)], -1).astype(np.float32)


def _filter_boxes(boxes, labels, w, h, orig_areas=None,
                  min_visibility=0.25, min_area=16.0):
    """Clip to the canvas and drop boxes by visibility/area (Albumentations
    BboxParams semantics)."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4), labels
    clipped = boxes.copy()
    clipped[:, [0, 2]] = clipped[:, [0, 2]].clip(0, w)
    clipped[:, [1, 3]] = clipped[:, [1, 3]].clip(0, h)
    areas = np.maximum(clipped[:, 2] - clipped[:, 0], 0) * \
        np.maximum(clipped[:, 3] - clipped[:, 1], 0)
    if orig_areas is None:
        orig_areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
            np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    vis = areas / np.maximum(orig_areas, 1e-9)
    keep = (areas >= min_area) & (vis >= min_visibility) & \
           (clipped[:, 2] > clipped[:, 0]) & (clipped[:, 3] > clipped[:, 1])
    return clipped[keep], labels[keep]


# --------------------------------------------------------------------------- #
# Individual transforms
# --------------------------------------------------------------------------- #

def hflip(img, boxes):
    w = img.shape[1]
    img = img[:, ::-1].copy()
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def vflip(img, boxes):
    h = img.shape[0]
    img = img[::-1].copy()
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    return img, boxes


def affine_matrix(h, w, rng: np.random.RandomState,
                  rotate=(-20, 20), shear=(-10, 10), scale=(0.85, 1.15),
                  translate=(0.05, 0.10)) -> np.ndarray:
    """The train-time 2x3 affine: rotation and scale about the centre, then
    shear, then translation."""
    ang = math.radians(rng.uniform(*rotate))
    shx = math.radians(rng.uniform(*shear))
    shy = math.radians(rng.uniform(*shear))
    sc = rng.uniform(*scale)
    t_mag = rng.uniform(*translate)
    tx = rng.choice([-1, 1]) * t_mag * w
    ty = rng.choice([-1, 1]) * t_mag * h

    cx, cy = w / 2.0, h / 2.0
    ca, sa = math.cos(ang) * sc, math.sin(ang) * sc
    rot = np.array([[ca, -sa, cx - ca * cx + sa * cy],
                    [sa, ca, cy - sa * cx - ca * cy]], np.float32)
    sh = np.array([[1.0, math.tan(shx), 0.0],
                   [math.tan(shy), 1.0, 0.0]], np.float32)
    m = (np.vstack([rot, [0, 0, 1]]) @ np.vstack([sh, [0, 0, 1]]))[:2]
    m[:, 2] += (tx, ty)
    return m


def random_affine(img, boxes, rng: np.random.RandomState,
                  rotate=(-20, 20), shear=(-10, 10), scale=(0.85, 1.15),
                  translate=(0.05, 0.10)):
    h, w = img.shape[:2]
    m = affine_matrix(h, w, rng, rotate, shear, scale, translate)
    img = imgops.warp_affine(img, m, (w, h), PAD)
    return img, _transform_boxes_affine(boxes, m)


def random_brightness_contrast(img, rng, brightness=0.2, contrast=0.2):
    alpha = 1.0 + rng.uniform(-contrast, contrast)
    beta = rng.uniform(-brightness, brightness) * 255.0
    return imgops.convert_scale_abs(img, alpha, beta)


def _hsv_lut(hue_add: float, sat_scale: float, sat_add: float,
             val_add: float) -> np.ndarray:
    """256x1x3 uint8 LUT over the HSV channels."""
    idx = np.arange(256, dtype=np.float32)
    lut = np.empty((256, 1, 3), np.uint8)
    lut[:, 0, 0] = np.mod(idx + hue_add, 180.0).astype(np.uint8)
    lut[:, 0, 1] = np.clip(idx * sat_scale + sat_add, 0, 255).astype(np.uint8)
    lut[:, 0, 2] = np.clip(idx + val_add, 0, 255).astype(np.uint8)
    return lut


def color_jitter(img, rng, brightness=0.2, contrast=0.2, saturation=0.15, hue=0.05):
    img = random_brightness_contrast(img, rng, brightness, contrast)
    hsv = imgops.rgb2hsv(img)
    lut = _hsv_lut(rng.uniform(-hue, hue) * 180.0,
                   1.0 + rng.uniform(-saturation, saturation), 0.0, 0.0)
    return imgops.hsv2rgb(imgops.lut(hsv, lut))


def hsv_shift(img, rng, hue_lim=5, sat_lim=15, val_lim=15):
    hsv = imgops.rgb2hsv(img)
    lut = _hsv_lut(float(rng.randint(-hue_lim, hue_lim + 1)), 1.0,
                   float(rng.randint(-sat_lim, sat_lim + 1)),
                   float(rng.randint(-val_lim, val_lim + 1)))
    return imgops.hsv2rgb(imgops.lut(hsv, lut))


def rgb_shift(img, rng, lim=20):
    return imgops.add_scalar(img, rng.randint(-lim, lim + 1, size=3))


def channel_shuffle(img, rng):
    return imgops.permute_channels(img, rng.permutation(3))


COLOR_OPS = (random_brightness_contrast, color_jitter, hsv_shift, rgb_shift,
             channel_shuffle)


@functools.lru_cache(maxsize=1)
def noise_pool() -> np.ndarray:
    """The JAX package's unit-normal pool: default_rng(0xA0C5E), 8M float32."""
    return np.random.default_rng(0xA0C5E).standard_normal(NOISE_POOL_N, dtype=np.float32)


def gauss_noise(img, rng, var=(5.0, 20.0)):
    """Additive white noise from the precomputed pool at a random offset
    drawn from the sample's RandomState."""
    sigma = math.sqrt(rng.uniform(*var))
    n = int(img.size)
    if n + 1 >= NOISE_POOL_N:  # an image larger than the pool
        noise = np.random.default_rng(rng.randint(1 << 31)).standard_normal(
            img.shape, dtype=np.float32) * sigma
    else:
        off = rng.randint(NOISE_POOL_N - n)
        noise = (noise_pool()[off:off + n] * sigma).reshape(img.shape)
    return imgops.add_noise(img, noise)


def motion_blur(img, rng):
    return imgops.line_blur3(img, horizontal=bool(rng.rand() < 0.5))


def elastic_transform(img, boxes, rng, alpha=1.0, sigma=50.0):
    """ElasticTransform(alpha=1, sigma=50): a Gaussian-smoothed random
    displacement field (drawn at 1/8 resolution, resized up) remaps the
    pixels; boxes follow the displacement at their corners."""
    h, w = img.shape[:2]
    gh, gw = max(h // 8, 2), max(w // 8, 2)
    dx = imgops.resize_f32(rng.uniform(-1, 1, (gh, gw)).astype(np.float32), w, h)
    dy = imgops.resize_f32(rng.uniform(-1, 1, (gh, gw)).astype(np.float32), w, h)
    s8 = max(sigma / 8.0, 0.5)
    k = int(s8 * 4) | 1
    dx = imgops.gaussian_blur_f32(dx, k, s8) * alpha
    dy = imgops.gaussian_blur_f32(dy, k, s8) * alpha
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    img = imgops.remap(img, xs + dx, ys + dy, PAD)
    if len(boxes):
        boxes = boxes.copy()
        xi = boxes[:, [0, 2]].clip(0, w - 1).astype(np.int32)
        yi = boxes[:, [1, 3]].clip(0, h - 1).astype(np.int32)
        # remap maps output<-input, so corners move by -d
        boxes[:, [0, 2]] -= dx[yi[:, [0, 1]], xi]
        boxes[:, [1, 3]] -= dy[yi, xi[:, [0, 1]]]
    return img, boxes


def coarse_dropout(img, rng, num_holes=(3, 10), hole_h=(0.01, 0.05),
                   hole_w=(0.01, 0.05)):
    """CoarseDropout: a few small random rectangles set to black; labels
    unchanged."""
    h, w = img.shape[:2]
    img = img.copy()
    for _ in range(rng.randint(num_holes[0], num_holes[1] + 1)):
        hh = max(1, int(rng.uniform(*hole_h) * h))
        hw = max(1, int(rng.uniform(*hole_w) * w))
        y = rng.randint(0, max(1, h - hh))
        x = rng.randint(0, max(1, w - hw))
        img[y:y + hh, x:x + hw] = 0
    return img


# --------------------------------------------------------------------------- #
# Composed pipelines
# --------------------------------------------------------------------------- #

def _square_resize(img, boxes, size):
    h, w = img.shape[:2]
    img = resize_image(img, size)[0]
    if len(boxes):
        boxes = boxes * np.array([size / w, size / h] * 2, np.float32)
    return img, boxes


def _finish(img, boxes, labels, orig_areas, size, min_visibility, min_area):
    """Letterbox to size x size, map the boxes, filter them."""
    canvas, scale, px, py = letterbox_image(img, size)
    if len(boxes):
        boxes = boxes * scale
        boxes[:, [0, 2]] += px
        boxes[:, [1, 3]] += py
        if orig_areas is not None:
            orig_areas = orig_areas * (scale ** 2)
    boxes, labels = _filter_boxes(boxes, labels, size, size, orig_areas,
                                  min_visibility, min_area)
    return canvas, boxes, labels


def _prepare(boxes, labels):
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    labels = np.asarray(labels, np.int64).reshape(-1)
    orig_areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
        np.maximum(boxes[:, 3] - boxes[:, 1], 0) if len(boxes) else None
    return boxes, labels, orig_areas


class TrainTransform:
    """The reference's get_base_transform; emits a uint8 letterboxed canvas."""

    def __init__(self, img_size: int, use_resize: bool = False,
                 p_flip: float = 0.3, p_affine: float = 0.2,
                 p_color: float = 0.4, p_noise: float = 0.15,
                 min_visibility: float = 0.25, min_area: float = 16.0):
        self.img_size = img_size
        self.use_resize = use_resize
        self.p_flip = p_flip
        self.p_affine = p_affine
        self.p_color = p_color
        self.p_noise = p_noise
        self.min_visibility = min_visibility
        self.min_area = min_area

    def __call__(self, img, boxes, labels, rng: np.random.RandomState):
        boxes, labels, orig_areas = _prepare(boxes, labels)
        if rng.rand() < self.p_flip:
            img, boxes = hflip(img, boxes)
        if rng.rand() < self.p_flip:
            img, boxes = vflip(img, boxes)
        if self.use_resize:
            img, boxes = _square_resize(img, boxes, self.img_size)
        if rng.rand() < self.p_affine:
            img, boxes = random_affine(img, boxes, rng)
        if rng.rand() < self.p_color:
            img = COLOR_OPS[rng.randint(5)](img, rng)
        if rng.rand() < self.p_noise:
            img = gauss_noise(img, rng) if rng.rand() < 0.5 else motion_blur(img, rng)
        return _finish(img, boxes, labels, orig_areas, self.img_size,
                       self.min_visibility, self.min_area)


class StrongTrainTransform:
    """The reference's get_strong_transform (`aug_preset: strong`): HFlip
    p=0.5 (no VFlip), Affine p=0.3, Elastic(alpha=1, sigma=50) p=0.1, colour
    p=0.1, shadow-or-sunflare p=0.2, CoarseDropout p=0.2, noise-or-blur
    p=0.3, letterbox, min_visibility 0.3 / min_area 0."""

    def __init__(self, img_size: int, use_resize: bool = False,
                 photometric: bool = True):
        self.img_size = img_size
        self.use_resize = use_resize
        self.photometric = photometric

    def __call__(self, img, boxes, labels, rng: np.random.RandomState):
        boxes, labels, orig_areas = _prepare(boxes, labels)
        if rng.rand() < 0.5:
            img, boxes = hflip(img, boxes)
        if self.use_resize:
            img, boxes = _square_resize(img, boxes, self.img_size)
        if rng.rand() < 0.3:
            img, boxes = random_affine(img, boxes, rng)
        if rng.rand() < 0.1:
            img, boxes = elastic_transform(img, boxes, rng)
        if self.photometric and rng.rand() < 0.1:
            img = COLOR_OPS[rng.randint(5)](img, rng)
        if self.photometric and rng.rand() < 0.2:
            img = add_shadow(img, rng) if rng.rand() < 0.5 else add_sunflare(img, rng)
        if rng.rand() < 0.2:
            img = coarse_dropout(img, rng)
        if self.photometric and rng.rand() < 0.3:
            img = gauss_noise(img, rng) if rng.rand() < 0.5 else motion_blur(img, rng)
        return _finish(img, boxes, labels, orig_areas, self.img_size, 0.3, 0.0)


class ValTransform:
    """Letterbox (or resize) only, as the reference's get_val_transform."""

    def __init__(self, img_size: int, use_resize: bool = False):
        self.img_size = img_size
        self.use_resize = use_resize

    def __call__(self, img, boxes, labels, rng=None):
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        labels = np.asarray(labels, np.int64).reshape(-1)
        if self.use_resize:
            canvas, sx, sy = resize_image(img, self.img_size)
            if len(boxes):
                boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        else:
            canvas, scale, px, py = letterbox_image(img, self.img_size)
            if len(boxes):
                boxes = boxes * scale
                boxes[:, [0, 2]] += px
                boxes[:, [1, 3]] += py
        if len(boxes):
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, self.img_size)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, self.img_size)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, labels = boxes[keep], labels[keep]
        return canvas, boxes, labels
