"""YOLO-format detection dataset with a RAM label cache (port of
`data/dataset.py`, detection only).

  - scans the image dir for image files, sorted; caches every YOLO-txt label
    file as an [N, 5] array (polygon rows collapse to their box);
  - xywhn -> xyxy pixels at load;
  - training samples (`augment=True`): mosaic 2x2 (p `mosaic_p`) or a
    small-object cutmix paste (p `cutmix_p`), then `TrainTransform` (or
    `StrongTrainTransform` for `aug_preset: strong`; `photometric=False`
    leaves the colour and noise ops to the device, `data/device_augment.py`);
    every draw comes from the caller's RandomState in the JAX package's order;
  - otherwise letterbox only (`ValTransform`);
  - `get` returns fixed-shape padded targets: image uint8 [S,S,3], boxes f32
    [M,4], labels i32 [M], mask bool [M], image_id.

Images are decoded without cv2 or PIL: PNG by the port's own decoder
(`data/png.py`; 8-bit gray, RGB, RGBA) and `.npy` files of BGR uint8 arrays
(the port's convention for decoded frames, see `api.py`); both give RGB, as
the JAX package's `cv2.imread` + BGR->RGB does (gray replicated, alpha
dropped, as `cv2.IMREAD_COLOR`). Any other extension makes the constructor
raise `UnsupportedImage` naming the file. A damaged file of a readable
format falls back to a black image with no targets, as in the JAX package;
nothing else is swallowed, so an unreadable format never trains on zeros.

Segmentation datasets are ROADMAP Queue 1 item 9 and raise.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from yololite_tpu_torch.data.augment import StrongTrainTransform, TrainTransform, ValTransform
from yololite_tpu_torch.data.png import UnsupportedImage, read_png
from yololite_tpu_torch.ops.letterbox import resize_image

VALID_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".npy"}
READABLE_EXTS = (".png", ".npy")


def list_images(img_dir: str) -> List[str]:
    files = []
    if os.path.exists(img_dir):
        with os.scandir(str(img_dir)) as entries:
            for e in entries:
                if e.is_file() and os.path.splitext(e.name)[1].lower() in VALID_EXTS:
                    files.append(e.path)
    files.sort()
    return files


def parse_yolo_label_file(path: str) -> np.ndarray:
    """Parse one YOLO txt file -> [N,5] (cls, xc, yc, w, h) normalized.
    Polygon rows (cls + 2k coords, k>2) collapse to their bbox; an unreadable
    file or row gives what the JAX package gives (rows before the fault)."""
    boxes = []
    try:
        with open(path, "r") as f:
            lines = f.readlines()
        for line in lines:
            parts = line.strip().split()
            if len(parts) >= 5:
                cls = int(float(parts[0]))
                coords = np.array([float(x) for x in parts[1:]], dtype=np.float32)
                if len(coords) > 4:  # segmentation polygon
                    pts = coords.reshape(-1, 2)
                    xmin, ymin = pts.min(axis=0)
                    xmax, ymax = pts.max(axis=0)
                    xc, yc = (xmin + xmax) / 2, (ymin + ymax) / 2
                    w, h = (xmax - xmin), (ymax - ymin)
                else:
                    xc, yc, w, h = coords[:4]
                boxes.append([cls, xc, yc, w, h])
    except (OSError, ValueError):
        pass
    if boxes:
        return np.asarray(boxes, dtype=np.float32)
    return np.zeros((0, 5), dtype=np.float32)


def max_instances_per_image(lab_dir: str) -> int:
    """Largest number of label rows in any txt under `lab_dir` (for
    `training.max_boxes: auto`)."""
    best = 0
    p = Path(lab_dir)
    if not p.is_dir():
        return 0
    for f in p.glob("*.txt"):
        try:
            with open(f) as fh:
                n = sum(1 for ln in fh if ln.strip())
        except OSError:
            continue
        best = max(best, n)
    return best


def read_image_rgb(path: str) -> np.ndarray:
    """A PNG or a `.npy` BGR array -> uint8 RGB [H, W, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: expected a uint8 [H,W,3] BGR array, got "
                             f"{img.dtype} {img.shape}")
        return np.ascontiguousarray(img[..., ::-1])
    if ext != ".png":
        raise UnsupportedImage(f"{path}: this package reads {READABLE_EXTS} images")
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


class _LRUImageCache:
    """Bounded decoded-image cache (byte budget, LRU eviction, thread-safe)."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self._od: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, idx: int) -> Optional[np.ndarray]:
        with self._lock:
            img = self._od.get(idx)
            if img is not None:
                self._od.move_to_end(idx)
                self.hits += 1
            else:
                self.misses += 1
            return img

    def put(self, idx: int, img: np.ndarray) -> None:
        nb = img.nbytes
        if nb > self.budget:
            return  # a single image over budget: never cache it
        with self._lock:
            old = self._od.pop(idx, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._od[idx] = img
            self._bytes += nb
            while self._bytes > self.budget and self._od:
                _, ev = self._od.popitem(last=False)
                self._bytes -= ev.nbytes

    @property
    def nbytes(self) -> int:
        return self._bytes


class YoloDataset:
    def __init__(self, img_dir: str, label_dir: str, img_size: int = 640,
                 is_train: bool = True, max_boxes: int = 100,
                 use_resize: bool = False, mosaic_p: float = 0.2,
                 cutmix_p: float = 0.2, augment: bool = True, seed: int = 0,
                 task: str = "detect", cache_images: bool = False,
                 photometric: bool = True, aug_preset: str = "base",
                 cache_budget_mb: Optional[float] = None):
        if task != "detect":
            raise NotImplementedError("segmentation datasets: ROADMAP Queue 1 item 9")
        self.img_dir = Path(img_dir)
        self.label_dir = Path(label_dir)
        self.img_files = list_images(str(img_dir))
        if len(self.img_files) == 0:
            raise ValueError(f"No images found in {img_dir}")
        bad = [f for f in self.img_files if not f.lower().endswith(READABLE_EXTS)]
        if bad:
            raise UnsupportedImage(f"{bad[0]} (and {len(bad) - 1} more): this package "
                                   f"reads {READABLE_EXTS} images only (no cv2/PIL)")
        self.img_size = int(img_size)
        self.is_train = bool(is_train)
        self.max_boxes = int(max_boxes)
        self.mosaic_p = float(mosaic_p) if (is_train and augment) else 0.0
        self.cutmix_p = float(cutmix_p) if (is_train and augment) else 0.0
        self.augment_enabled = bool(augment) and self.is_train
        self.photometric = bool(photometric)
        self.aug_preset = str(aug_preset)
        self.val_transform = ValTransform(img_size, use_resize)
        self.transform = (self._make_train_transform(use_resize)
                          if self.augment_enabled else self.val_transform)
        self.seed = seed
        self.labels_cache = self._cache_labels()
        self.lru_cache: Optional[_LRUImageCache] = None
        self.image_cache: Optional[List[Optional[np.ndarray]]] = None
        if cache_budget_mb is not None:
            self.lru_cache = _LRUImageCache(int(float(cache_budget_mb) * 2**20))
        elif cache_images:
            self.image_cache = [None] * len(self.img_files)

    def _make_train_transform(self, use_resize: bool):
        if self.aug_preset == "strong":
            return StrongTrainTransform(self.img_size, use_resize,
                                        photometric=self.photometric)
        if self.photometric:
            return TrainTransform(self.img_size, use_resize)
        return TrainTransform(self.img_size, use_resize, p_color=0.0, p_noise=0.0)

    def set_img_size(self, img_size: int):
        """Multi-scale training: switch the target size, keeping the kind of
        transform (train or letterbox only)."""
        self.img_size = int(img_size)
        use_resize = self.val_transform.use_resize
        self.val_transform = ValTransform(self.img_size, use_resize)
        self.transform = (self._make_train_transform(use_resize)
                          if self.augment_enabled else self.val_transform)

    # -- the augmentation taper ---------------------------------------------- #
    def set_mosaic_cutmix(self, mosaic_p: float, cutmix_p: float):
        self.mosaic_p = mosaic_p
        self.cutmix_p = cutmix_p

    def set_augment(self, enabled: bool):
        self.augment_enabled = enabled and self.is_train
        self.transform = (self._make_train_transform(self.val_transform.use_resize)
                          if self.augment_enabled else self.val_transform)
        if not enabled:
            self.mosaic_p = 0.0
            self.cutmix_p = 0.0

    def _cache_labels(self) -> List[np.ndarray]:
        cache = []
        for img_path in self.img_files:
            label_path = self.label_dir / (Path(img_path).stem + ".txt")
            cache.append(parse_yolo_label_file(str(label_path))
                         if label_path.exists() else np.zeros((0, 5), np.float32))
        return cache

    def __len__(self):
        return len(self.img_files)

    def load_image(self, idx: int) -> np.ndarray:
        if self.lru_cache is not None:
            cached = self.lru_cache.get(idx)
            if cached is not None:
                return cached
        elif self.image_cache is not None:
            cached = self.image_cache[idx]
            if cached is not None:
                return cached
        img = read_image_rgb(self.img_files[idx])
        if self.lru_cache is not None:
            self.lru_cache.put(idx, img)
        elif self.image_cache is not None:
            self.image_cache[idx] = img  # per-slot write: thread-safe
        return img

    def load_label_processed(self, idx: int, img_h: int, img_w: int):
        data = self.labels_cache[idx]
        if data.shape[0] == 0:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        cls = data[:, 0].astype(np.int64)
        xywh = data[:, 1:]
        x1 = (xywh[:, 0] - xywh[:, 2] / 2) * img_w
        y1 = (xywh[:, 1] - xywh[:, 3] / 2) * img_h
        x2 = (xywh[:, 0] + xywh[:, 2] / 2) * img_w
        y2 = (xywh[:, 1] + xywh[:, 3] / 2) * img_h
        return np.stack([x1, y1, x2, y2], axis=1).astype(np.float32), cls

    # ------------------------------ Mosaic ---------------------------------- #
    def mosaic(self, index: int, rng: np.random.RandomState):
        """2x2 mosaic on a 2S canvas of 114: this image and three drawn ones,
        each resized to S x S."""
        indices = [index] + list(rng.randint(0, len(self), size=3))
        s = self.img_size
        canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
        offsets = [(0, 0), (0, s), (s, 0), (s, s)]
        all_boxes, all_labels = [], []
        for i, idx in enumerate(indices):
            img = self.load_image(idx)
            h, w = img.shape[:2]
            boxes, labels = self.load_label_processed(idx, h, w)
            img = resize_image(img, s)[0]
            if len(boxes):
                boxes = boxes * np.array([s / w, s / h, s / w, s / h], np.float32)
            oy, ox = offsets[i]
            canvas[oy:oy + s, ox:ox + s] = img
            if len(boxes):
                boxes[:, [0, 2]] += ox
                boxes[:, [1, 3]] += oy
                all_boxes.append(boxes)
                all_labels.append(labels)
        if all_boxes:
            fb = np.vstack(all_boxes)
            fl = np.concatenate(all_labels)
            valid = (fb[:, 2] > fb[:, 0]) & (fb[:, 3] > fb[:, 1])
            return canvas, fb[valid], fl[valid]
        return canvas, np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)

    # ------------------------------ CutMix ---------------------------------- #
    def cutmix_focus_small(self, img, boxes, labels, other_idx: int,
                           rng: np.random.RandomState, alpha: float = 0.7):
        """Blend the other image's smallest box at a random place of this
        one (alpha 0.7) and add it as a target."""
        img2 = self.load_image(other_idx)
        h2, w2 = img2.shape[:2]
        boxes2, labels2 = self.load_label_processed(other_idx, h2, w2)
        if len(boxes2) == 0:
            return img, boxes, labels
        areas = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
        si = int(np.argmin(areas))
        x1, y1, x2, y2 = boxes2[si].astype(int)
        x1, y1 = max(x1, 0), max(y1, 0)
        patch = img2[y1:y2, x1:x2]
        if patch.size == 0:
            return img, boxes, labels
        ph, pw = patch.shape[:2]
        h, w = img.shape[:2]
        if ph >= h or pw >= w:
            return img, boxes, labels
        cx = rng.randint(0, max(1, w - pw))
        cy = rng.randint(0, max(1, h - ph))
        roi = img[cy:cy + ph, cx:cx + pw]
        if roi.shape[:2] != patch.shape[:2]:
            return img, boxes, labels
        img = img.copy()
        img[cy:cy + ph, cx:cx + pw] = (alpha * patch + (1 - alpha) * roi).astype(np.uint8)
        new_box = np.array([[cx, cy, cx + pw, cy + ph]], np.float32)
        new_lbl = np.array([labels2[si]], np.int64)
        boxes = np.vstack([boxes, new_box]) if len(boxes) else new_box
        labels = np.concatenate([labels, new_lbl]) if len(labels) else new_lbl
        return img, boxes, labels

    def _pad_targets(self, boxes, labels):
        m = self.max_boxes
        out_b = np.zeros((m, 4), np.float32)
        out_l = np.zeros((m,), np.int32)
        out_m = np.zeros((m,), bool)
        n = min(len(boxes), m)
        if n:
            out_b[:n] = boxes[:n]
            out_l[:n] = labels[:n]
            out_m[:n] = True
        return out_b, out_l, out_m

    def get(self, idx: int, rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        rng = rng or np.random.RandomState()
        try:
            img = self.load_image(idx)
            h, w = img.shape[:2]
            boxes, labels = self.load_label_processed(idx, h, w)
            if self.augment_enabled:
                p = rng.rand()
                if p < self.mosaic_p:
                    img, boxes, labels = self.mosaic(idx, rng)
                elif p < self.mosaic_p + self.cutmix_p:
                    img, boxes, labels = self.cutmix_focus_small(
                        img, boxes, labels, rng.randint(0, len(self)), rng)
                h, w = img.shape[:2]
                if len(boxes):
                    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
                    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            canvas, boxes, labels = self.transform(img, boxes, labels, rng)
        except UnsupportedImage:
            raise
        except (OSError, ValueError) as e:  # damaged file: black image, no targets
            print(f"[ERROR] {self.img_files[idx]}: {e}")
            canvas = np.zeros((self.img_size, self.img_size, 3), np.uint8)
            boxes, labels = np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        b, l, m = self._pad_targets(boxes, labels)
        return {"image": canvas, "boxes": b, "labels": l, "mask": m,
                "image_id": np.int64(idx)}

    def __getitem__(self, idx):
        return self.get(idx)
