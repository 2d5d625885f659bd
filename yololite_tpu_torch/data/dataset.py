"""YOLO-format dataset with a RAM label cache (port of `data/dataset.py`):
detection, and instance segmentation with `task="segment"`.

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
    [M,4], labels i32 [M], mask bool [M], image_id;
  - segmentation (`task="segment"`) keeps each label row's polygon (a box
    row becomes its rectangle) and carries the points through the same
    geometry (mosaic, a mask-aware cutmix that pastes the donor's smallest
    instance inside its polygon, flips, affine, letterbox), then rasterizes
    each instance with `imgops.fill_poly` (cv2.fillPoly's arithmetic): at
    prototype resolution (img_size / 4), bit-packed along W as
    "masks_packed" [M, Hp, ceil(Wp/8)], and, with `want_rles`, at full
    resolution as RLE under "gt_rles" (host-only, for segm evaluation).
    Validation samples are deterministic and cached by (index, img_size);
    the cache is unbounded and hands out the same arrays on every call, as
    in the JAX package.

Images are decoded without cv2 or PIL: JPEG, PNG and BMP by the port's own
host codecs (`data/codecs.py`, equal to `cv2.imread` bit for bit) and `.npy`
files of BGR uint8 arrays (the port's convention for decoded frames, see
`api.py`); all give RGB, as the JAX package's `cv2.imread` + BGR->RGB does.
A TIFF makes the constructor raise `UnsupportedImage` naming the file. A
damaged file (where cv2.imread gives None) falls back to a black image with
no targets, as in the JAX package; nothing else is swallowed, so an
unreadable format never trains on zeros. The codec library is built or
loaded by the constructor of any split that holds images, so a missing host
compiler raises `csrc.build.BuildError` there and never in a sample.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from yololite_tpu_torch.data import imgops
from yololite_tpu_torch.data.augment import (
    COLOR_OPS, PAD, StrongTrainTransform, TrainTransform, ValTransform, affine_matrix,
    gauss_noise, motion_blur,
)
from yololite_tpu_torch.data.codecs import UnsupportedImage, imread_bgr, library
from yololite_tpu_torch.ops.letterbox import letterbox_image, resize_image
from yololite_tpu_torch.ops.masks import rle_encode_np

VALID_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".npy"}
READABLE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")
CODEC_ITEM = "TIFF decoding is not ported (ROADMAP Queue 1, when a user needs it)"
PROTO_STRIDE = 4          # GT masks at the ProtoNet's resolution


def list_images(img_dir: str) -> List[str]:
    files = []
    if os.path.exists(img_dir):
        with os.scandir(str(img_dir)) as entries:
            for e in entries:
                if e.is_file() and os.path.splitext(e.name)[1].lower() in VALID_EXTS:
                    files.append(e.path)
    files.sort()
    return files


def parse_yolo_seg_file(path: str):
    """Parse a YOLO txt keeping polygons: a list of (cls, pts [P,2]
    normalized); a plain box row becomes its rectangle polygon. An
    unreadable file or row gives the rows before the fault, as in JAX."""
    out = []
    try:
        with open(path, "r") as f:
            lines = f.readlines()
        for line in lines:
            parts = line.strip().split()
            if len(parts) >= 5:
                cls = int(float(parts[0]))
                coords = np.array([float(x) for x in parts[1:]], dtype=np.float32)
                if len(coords) > 4:
                    pts = coords.reshape(-1, 2)
                else:
                    xc, yc, w, h = coords[:4]
                    pts = np.array([[xc - w / 2, yc - h / 2], [xc + w / 2, yc - h / 2],
                                    [xc + w / 2, yc + h / 2], [xc - w / 2, yc + h / 2]],
                                   np.float32)
                out.append((cls, pts))
    except (OSError, ValueError):
        pass
    return out


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
    """A JPEG, PNG or BMP (as `cv2.imread` + BGR->RGB) or a `.npy` BGR
    array -> uint8 RGB [H, W, 3]. A damaged file raises `ValueError`."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: expected a uint8 [H,W,3] BGR array, got "
                             f"{img.dtype} {img.shape}")
        return np.ascontiguousarray(img[..., ::-1])
    if ext not in READABLE_EXTS:
        raise UnsupportedImage(f"{path}: this package reads {READABLE_EXTS} images "
                               f"({CODEC_ITEM})")
    return np.ascontiguousarray(imread_bgr(path)[..., ::-1])


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
                 cache_budget_mb: Optional[float] = None, want_rles: bool = True):
        self.img_dir = Path(img_dir)
        self.label_dir = Path(label_dir)
        self.img_files = list_images(str(img_dir))
        if len(self.img_files) == 0:
            raise ValueError(f"No images found in {img_dir}")
        bad = [f for f in self.img_files if not f.lower().endswith(READABLE_EXTS)]
        if bad:
            raise UnsupportedImage(f"{bad[0]} (and {len(bad) - 1} more): this package "
                                   f"reads {READABLE_EXTS} images only ({CODEC_ITEM})")
        if not all(f.lower().endswith(".npy") for f in self.img_files):
            library()     # the codec builds or loads here: no compiler raises BuildError
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
        self.task = task
        self.proto_size = int(img_size) // PROTO_STRIDE
        # full-resolution GT RLEs feed only segm evaluation; the train split
        # skips them (one full-size fill + encode per instance per sample)
        self.want_rles = bool(want_rles)
        self._val_seg_cache: Dict = {}
        self.labels_cache = self._cache_labels()
        self.poly_cache = self._cache_polygons() if task == "segment" else None
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
        self.proto_size = self.img_size // PROTO_STRIDE
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

    def _cache_polygons(self):
        cache = []
        for img_path in self.img_files:
            label_path = self.label_dir / (Path(img_path).stem + ".txt")
            cache.append(parse_yolo_seg_file(str(label_path))
                         if label_path.exists() else [])
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

    # ------------------------------ segmentation --------------------------- #
    def mosaic_segment(self, index: int, rng: np.random.RandomState):
        """Polygon-aware mosaic: the box mosaic's geometry (each tile resized
        to S x S on a 2S canvas) with polygon points scaled and offset."""
        indices = [index] + list(rng.randint(0, len(self), size=3))
        s = self.img_size
        canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
        offsets = [(0, 0), (0, s), (s, 0), (s, s)]
        polys, labels = [], []
        for i, idx in enumerate(indices):
            img = self.load_image(idx)
            canvas_off = np.array(offsets[i][::-1], np.float32)  # (ox, oy)
            oy, ox = offsets[i]
            canvas[oy:oy + s, ox:ox + s] = resize_image(img, s)[0]
            for c, p in self.poly_cache[idx]:
                polys.append(p * np.float32(s) + canvas_off)
                labels.append(c)
        return canvas, polys, np.asarray(labels, np.int64)

    def cutmix_segment(self, img, polys, labels, other_idx: int,
                       rng: np.random.RandomState, alpha: float = 0.7):
        """Mask-aware cutmix: the donor's smallest instance (by its polygon's
        box) is alpha-blended into this image inside its polygon only, and
        the shifted polygon becomes a new instance."""
        items = self.poly_cache[other_idx]
        if not items:
            return img, polys, labels
        img2 = self.load_image(other_idx)
        h2, w2 = img2.shape[:2]
        px2 = [p * np.array([w2, h2], np.float32) for _, p in items]
        areas = [max(float(p[:, 0].max() - p[:, 0].min()), 1.0) *
                 max(float(p[:, 1].max() - p[:, 1].min()), 1.0) for p in px2]
        si = int(np.argmin(areas))
        poly = px2[si]
        x1, y1 = np.floor(poly.min(0)).astype(int)
        x2, y2 = np.ceil(poly.max(0)).astype(int)
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, w2), min(y2, h2)
        patch = img2[y1:y2, x1:x2]
        ph, pw = patch.shape[:2]
        h, w = img.shape[:2]
        if ph < 4 or pw < 4 or ph >= h or pw >= w:
            return img, polys, labels
        cx = rng.randint(0, max(1, w - pw))
        cy = rng.randint(0, max(1, h - ph))
        local = poly - np.array([x1, y1], np.float32)
        pm = np.zeros((ph, pw), np.uint8)
        imgops.fill_poly(pm, np.round(local).astype(np.int32), 1)
        roi = img[cy:cy + ph, cx:cx + pw]
        blend = (alpha * patch + (1 - alpha) * roi).astype(np.uint8)
        img = img.copy()
        img[cy:cy + ph, cx:cx + pw] = np.where(pm[..., None] > 0, blend, roi)
        polys = list(polys) + [local + np.array([cx, cy], np.float32)]
        labels = np.concatenate([np.asarray(labels, np.int64),
                                 [np.int64(items[si][0])]])
        return img, polys, labels

    def _get_segment(self, idx: int, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """A segmentation sample: the geometric pipeline on polygon points,
        GT masks filled at prototype resolution (bit-packed) and, with
        `want_rles`, at full resolution as RLE. Validation samples are
        cached, finished, by (idx, img_size)."""
        if not self.is_train:
            cached = self._val_seg_cache.get((idx, self.img_size))
            if cached is not None:
                return cached
        s = self.img_size
        ps = self.proto_size
        p_mix = rng.rand() if self.augment_enabled else 1.0
        if p_mix < self.mosaic_p:
            img, polys, labels = self.mosaic_segment(idx, rng)
            h, w = img.shape[:2]
        else:
            img = self.load_image(idx)
            h, w = img.shape[:2]
            items = self.poly_cache[idx]
            polys = [p * np.array([w, h], np.float32) for _, p in items]
            labels = np.array([c for c, _ in items], np.int64)
            if p_mix < self.mosaic_p + self.cutmix_p:
                img, polys, labels = self.cutmix_segment(
                    img, polys, labels, int(rng.randint(0, len(self))), rng)

        if self.augment_enabled:
            if rng.rand() < 0.3:
                img = img[:, ::-1].copy()
                polys = [np.stack([w - p[:, 0], p[:, 1]], 1) for p in polys]
            if rng.rand() < 0.3:
                img = img[::-1].copy()
                polys = [np.stack([p[:, 0], h - p[:, 1]], 1) for p in polys]
            if rng.rand() < 0.2:
                m_aff = affine_matrix(h, w, rng)
                img = imgops.warp_affine(img, m_aff, (w, h), PAD)
                polys = [p @ m_aff[:, :2].T + m_aff[:, 2] for p in polys]
            # photometric=False: the colour and noise ops run on the device
            if self.photometric and rng.rand() < 0.4:
                img = COLOR_OPS[rng.randint(5)](img, rng)
            if self.photometric and rng.rand() < 0.15:
                img = gauss_noise(img, rng) if rng.rand() < 0.5 else motion_blur(img, rng)

        canvas, scale, px, py = letterbox_image(img, s)
        polys = [p * scale + np.array([px, py], np.float32) for p in polys]

        m = self.max_boxes
        boxes = np.zeros((m, 4), np.float32)
        labs = np.zeros((m,), np.int32)
        valid = np.zeros((m,), bool)
        masks = np.zeros((m, ps, ps), np.uint8)
        gt_rles = []
        full = np.zeros((s, s), np.uint8)
        n = 0
        for poly, lab in zip(polys, labels):
            if n >= m:
                break
            poly = poly.clip([0, 0], [s - 1, s - 1])
            x1, y1 = poly.min(0)
            x2, y2 = poly.max(0)
            if x2 - x1 < 2 or y2 - y1 < 2:
                continue
            boxes[n] = (x1, y1, x2, y2)
            labs[n] = int(lab)
            valid[n] = True
            imgops.fill_poly(masks[n], np.round(poly * (ps / float(s))).astype(np.int32), 1)
            if self.want_rles:
                full[:] = 0
                imgops.fill_poly(full, np.round(poly).astype(np.int32), 1)
                gt_rles.append(rle_encode_np(full))
            n += 1
        # the unpack on the device takes its count from Hp: square only
        assert masks.shape[-1] == masks.shape[-2], (
            f"masks_packed needs square prototype masks; got {masks.shape}")
        out = {"image": canvas, "boxes": boxes, "labels": labs, "mask": valid,
               "masks_packed": np.packbits(masks, axis=-1),
               "image_id": np.int64(idx)}
        if self.want_rles:
            out["gt_rles"] = gt_rles
        if not self.is_train:
            self._val_seg_cache[(idx, self.img_size)] = out
        return out

    def _empty_segment(self, idx: int) -> Dict[str, np.ndarray]:
        """The sample of a damaged image: black, no instances."""
        ps, m = self.proto_size, self.max_boxes
        out = {"image": np.zeros((self.img_size, self.img_size, 3), np.uint8),
               "boxes": np.zeros((m, 4), np.float32),
               "labels": np.zeros((m,), np.int32),
               "mask": np.zeros((m,), bool),
               "masks_packed": np.zeros((m, ps, (ps + 7) // 8), np.uint8),
               "image_id": np.int64(idx)}
        if self.want_rles:
            out["gt_rles"] = []
        return out

    def get(self, idx: int, rng: Optional[np.random.RandomState] = None) -> Dict[str, np.ndarray]:
        rng = rng or np.random.RandomState()
        if self.task == "segment":
            try:
                return self._get_segment(idx, rng)
            except UnsupportedImage:
                raise
            except (OSError, ValueError) as e:   # damaged file
                print(f"[ERROR] {self.img_files[idx]}: {e}")
                return self._empty_segment(idx)
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
