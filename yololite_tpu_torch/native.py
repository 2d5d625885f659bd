"""Host C++ helpers (port of `native/__init__.py`): greedy NMS, the COCOeval
matcher and the space-to-depth pack. The library also exports the pairwise
IoU matrix `yl_box_iou`, which, as in JAX, has no wrapper: nothing calls it.

The C++ is `csrc/native.cpp`, built with the host C++ compiler at first use
by `csrc/build.py` (as the image codecs are) and called through ctypes,
which drops the GIL for the call. Beside each wrapper is a plain numpy
version of the same function (`*_plain`), which the tests hold the library
against. There is no fallback: without a host compiler the first call
raises `csrc.build.BuildError` naming it, as `data/codecs.py` does.

`nms` sorts by descending score with ties in index order (a stable sort),
and suppresses a box whose IoU with a kept box is above the threshold.
`coco_match` is COCOeval's greedy matcher for one (image, category), with
the ground truths sorted ignored-last.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None


def library() -> ctypes.CDLL:
    """The built `native` library with its C functions typed."""
    global _LIB
    if _LIB is None:
        from yololite_tpu_torch.csrc.build import load
        lib = load("native")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.yl_nms.argtypes = [ptr, ptr, i32, f32, ptr]
        lib.yl_nms.restype = ctypes.c_int
        lib.yl_box_iou.argtypes = [ptr, i32, ptr, i32, ptr]
        lib.yl_box_iou.restype = None
        lib.yl_coco_match.argtypes = [ptr, ptr, i32, i32, ptr, i32, ptr, ptr]
        lib.yl_coco_match.restype = None
        lib.yl_pack_s2d.argtypes = [ptr, i32, i32, i32, i32, ptr]
        lib.yl_pack_s2d.restype = None
        _LIB = lib
    return _LIB


def nms(boxes: np.ndarray, scores: np.ndarray, iou_th: float) -> np.ndarray:
    """Greedy NMS of [n,4] xyxy boxes: kept indices (int64) by descending score."""
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(boxes)
    if len(scores) != n:
        raise ValueError(f"nms: {n} boxes but {len(scores)} scores")
    keep = np.empty(max(n, 1), np.int32)
    kept = library().yl_nms(boxes.ctypes.data, scores.ctypes.data, n, float(iou_th),
                            keep.ctypes.data)
    return keep[:kept].astype(np.int64)


def nms_plain(boxes: np.ndarray, scores: np.ndarray, iou_th: float) -> np.ndarray:
    """Plain numpy version of `nms` (the same fp32 operations in the same order)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    order = np.argsort(-np.asarray(scores, np.float32), kind="stable")
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, np.float32(0)) * np.maximum(y2 - y1, np.float32(0))
    keep = []
    while order.size:
        i, rest = order[0], order[1:]
        keep.append(int(i))
        iw = np.maximum(np.float32(0), np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]))
        ih = np.maximum(np.float32(0), np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]))
        inter = iw * ih
        iou = inter / (areas[i] + areas[rest] - inter + np.float32(1e-7))
        order = rest[~(iou > np.float32(iou_th))]
    return np.asarray(keep, np.int64)


def coco_match(ious: np.ndarray, gt_ignore: np.ndarray, thrs: np.ndarray):
    """COCOeval's greedy matcher: ious [D,G] (dets by descending score, GTs
    ignored-last), gt_ignore [G], thresholds [T] -> (dtm [T,D] int32, matched
    GT index + 1 or 0; dt_ig [T,D] bool)."""
    ious = np.ascontiguousarray(ious, np.float64)
    d, g = ious.shape
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    thrs = np.ascontiguousarray(thrs, np.float64)
    dtm = np.zeros((len(thrs), d), np.int32)
    dt_ig = np.zeros((len(thrs), d), np.uint8)
    if d and g:
        library().yl_coco_match(ious.ctypes.data, gt_ignore.ctypes.data, d, g,
                                thrs.ctypes.data, len(thrs), dtm.ctypes.data,
                                dt_ig.ctypes.data)
    return dtm, dt_ig.astype(bool)


def coco_match_plain(ious: np.ndarray, gt_ignore: np.ndarray, thrs: np.ndarray):
    """Plain Python version of `coco_match` (the JAX evaluator's loop)."""
    ious = np.asarray(ious, np.float64)
    gt_ignore = np.asarray(gt_ignore).astype(bool)
    d, g = ious.shape
    dtm = np.zeros((len(thrs), d), np.int32)
    dt_ig = np.zeros((len(thrs), d), bool)
    for ti, thr in enumerate(thrs):
        gtm = np.zeros(g, bool)
        for di in range(d):
            best = min(thr, 1.0 - 1e-10)
            m = -1
            for gi in range(g):
                if gtm[gi]:
                    continue
                # stop at ignored GTs once a non-ignored match exists
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m + 1
            dt_ig[ti, di] = gt_ignore[m]
            gtm[m] = True
    return dtm, dt_ig


def pack_s2d(images: np.ndarray) -> np.ndarray:
    """Space-to-depth 2x2 pack of uint8 [B,H,W,C] -> [B,H/2,W/2,4C]:
    out[b, y, x, (di*2 + dj)*C + c] = in[b, 2y + di, 2x + dj, c]."""
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"pack_s2d: uint8 [B,H,W,C] expected, got {images.dtype} "
                         f"{images.shape}")
    b, h, w, c = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d pack needs even H,W, got {(h, w)}")
    out = np.empty((b, h // 2, w // 2, 4 * c), np.uint8)
    if out.size:
        library().yl_pack_s2d(images.ctypes.data, b, h, w, c, out.ctypes.data)
    return out


def pack_s2d_plain(images: np.ndarray) -> np.ndarray:
    """Plain numpy version of `pack_s2d` (any dtype)."""
    b, h, w, c = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d pack needs even H,W, got {(h, w)}")
    out = np.empty((b, h // 2, w // 2, 4 * c), images.dtype)
    for di in range(2):
        for dj in range(2):
            ph = di * 2 + dj
            out[..., ph * c:(ph + 1) * c] = images[:, di::2, dj::2, :]
    return out
