"""YOLO-format detection dataset with a RAM label cache (port of
`data/dataset.py`, detection only).

  - scans the image dir for image files, sorted; caches every YOLO-txt label
    file as an [N, 5] array (polygon rows collapse to their box);
  - xywhn -> xyxy pixels at load; letterbox (`ValTransform`);
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

Host augmentation (TrainTransform, mosaic, cutmix) is ROADMAP Queue 1 item
8a: `augment=True` on a training set raises. Segmentation is item 9.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from yololite_tpu_torch.data.augment import ValTransform
from yololite_tpu_torch.data.png import UnsupportedImage, read_png

VALID_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".npy"}
READABLE_EXTS = (".png", ".npy")
AUGMENT_TODO = "host augmentation (TrainTransform, mosaic, cutmix): ROADMAP Queue 1 item 8a"


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
                 use_resize: bool = False, augment: bool = True,
                 task: str = "detect", cache_images: bool = False,
                 cache_budget_mb: Optional[float] = None):
        if task != "detect":
            raise NotImplementedError("segmentation datasets: ROADMAP Queue 1 item 9")
        if is_train and augment:
            raise NotImplementedError(AUGMENT_TODO)
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
        self.transform = ValTransform(img_size, use_resize)
        self.labels_cache = self._cache_labels()
        self.lru_cache: Optional[_LRUImageCache] = None
        self.image_cache: Optional[List[Optional[np.ndarray]]] = None
        if cache_budget_mb is not None:
            self.lru_cache = _LRUImageCache(int(float(cache_budget_mb) * 2**20))
        elif cache_images:
            self.image_cache = [None] * len(self.img_files)

    def set_img_size(self, img_size: int):
        """Multi-scale training: switch the letterbox target size."""
        self.img_size = int(img_size)
        self.transform = ValTransform(self.img_size, self.transform.use_resize)

    def set_augment(self, enabled: bool):
        """The augmentation taper's switch; only `False` is ported."""
        if enabled and self.is_train:
            raise NotImplementedError(AUGMENT_TODO)

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
