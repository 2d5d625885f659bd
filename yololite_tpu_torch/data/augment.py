"""Host-side transforms (port of `data/augment.py`, the validation transform).

`ValTransform` letterboxes (or square-resizes) with the port's own resize
(`ops/letterbox.py`) and maps the boxes along. The training pipeline
(`TrainTransform`, `StrongTrainTransform`, mosaic, cutmix) is ROADMAP Queue 1
item 8a.
"""

from __future__ import annotations

import numpy as np

from yololite_tpu_torch.ops.letterbox import letterbox_image, resize_image


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
