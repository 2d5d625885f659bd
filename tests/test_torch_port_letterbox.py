"""PyTorch port: letterbox geometry and the torch bilinear resize.

The resize is held against `cv2.INTER_LINEAR` within +-1 intensity level:
cv2 interpolates uint8 in 11-bit fixed point, the port in fp32 and rounds,
so the two differ by at most one level. Geometry and back-mapping are exact.
"""

import cv2
import numpy as np
import pytest

from yololite_tpu.ops.letterbox import letterbox_image as jax_letterbox_image
from yololite_tpu.ops.letterbox import letterbox_params as jax_letterbox_params
from yololite_tpu.ops.letterbox import unletterbox_boxes as jax_unletterbox

from yololite_tpu_torch.ops.letterbox import (
    letterbox_image, letterbox_params, resize_image, unletterbox_boxes,
)


def _img(h, w, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("h,w,nh,nw", [(37, 53, 45, 64), (101, 67, 31, 21),
                                       (9, 13, 29, 41), (64, 64, 64, 64)])
def test_resize_within_one_level_of_cv2(h, w, nh, nw):
    img = _img(h, w)
    from yololite_tpu_torch.ops.letterbox import _resize_bilinear
    got = _resize_bilinear(img, nw, nh)
    want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("h,w", [(37, 53), (101, 67), (64, 64), (480, 640)])
def test_letterbox_matches_jax(h, w):
    img = _img(h, w, seed=1)
    assert letterbox_params(h, w, 96) == jax_letterbox_params(h, w, 96)
    canvas, scale, px, py = letterbox_image(img, 96)
    want, wscale, wpx, wpy = jax_letterbox_image(img, 96)
    assert (scale, px, py) == (wscale, wpx, wpy)
    assert canvas.shape == want.shape
    assert np.abs(canvas.astype(int) - want.astype(int)).max() <= 1
    out, sx, sy = resize_image(img, 96)
    assert out.shape == (96, 96, 3) and (sx, sy) == (96 / w, 96 / h)


@pytest.mark.parametrize("scale", [0.37, (0.5, 0.25)])
def test_unletterbox_exact(scale):
    boxes = np.random.RandomState(2).rand(20, 4).astype(np.float32) * 120
    got = unletterbox_boxes(boxes, scale, 7, 3, 90, 70)
    want = jax_unletterbox(boxes, scale, 7, 3, 90, 70)
    np.testing.assert_array_equal(got, want)
