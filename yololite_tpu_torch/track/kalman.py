"""SORT-style multi-object tracker with a batched Kalman filter (the port's
own copy of `yololite_tpu/track/kalman.py`, numpy on the host).

Capability parity with the reference `KalmanSortTracker`
(tools/tracker.py:157-326) and its hand-rolled `KalmanFilter` (:76-139):
  - 7-D state [cx, cy, s, r, vx, vy, vs], 4-D measurement [cx, cy, s, r]
    (s = area, r = aspect ratio; standard SORT parameterization)
  - constant-velocity F with P0 = 10*I, Q = 0.01*I, R = I
  - greedy IoU association (descending IoU, threshold, optional class gating)
  - track lifecycle: max_age frames without update, min_hits before reporting
  - `update(boxes, scores, classes)` returns [{track_id, bbox, cls, score}]

Design difference (not a port): the filter state for ALL tracks is stored as
batched arrays X [T,7] / P [T,7,7] and predict/update run as batched einsums —
one numpy call per frame instead of a Python loop per track.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

DIM_X, DIM_Z = 7, 4

_F = np.eye(DIM_X, dtype=np.float32)
_F[0, 4] = _F[1, 5] = _F[2, 6] = 1.0
_Q = np.eye(DIM_X, dtype=np.float32) * 0.01
_H = np.zeros((DIM_Z, DIM_X), dtype=np.float32)
_H[0, 0] = _H[1, 1] = _H[2, 2] = _H[3, 3] = 1.0
_R = np.eye(DIM_Z, dtype=np.float32)
_I = np.eye(DIM_X, dtype=np.float32)


def xyxy_to_cxsysr(box: np.ndarray) -> np.ndarray:
    """xyxy -> [cx, cy, s(area), r(aspect)] measurement."""
    box = np.asarray(box, np.float32)
    w = np.maximum(box[..., 2] - box[..., 0], 1e-6)
    h = np.maximum(box[..., 3] - box[..., 1], 1e-6)
    cx = box[..., 0] + w * 0.5
    cy = box[..., 1] + h * 0.5
    return np.stack([cx, cy, w * h, w / h], axis=-1)


def cxsysr_to_xyxy(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, np.float32)
    s = np.maximum(z[..., 2], 1e-6)
    r = np.maximum(z[..., 3], 1e-6)
    w = np.sqrt(s * r)
    h = s / w
    return np.stack([z[..., 0] - w / 2, z[..., 1] - h / 2,
                     z[..., 0] + w / 2, z[..., 1] + h / 2], axis=-1)


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[T,4] x [D,4] -> [T,D]"""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(0.0, ix2 - ix1) * np.maximum(0.0, iy2 - iy1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


class KalmanSortTracker:
    def __init__(self, iou_threshold: float = 0.3, max_age: int = 15,
                 min_hits: int = 2, match_by_class: bool = True):
        self.iou_threshold = iou_threshold
        self.max_age = max_age
        self.min_hits = min_hits
        self.match_by_class = match_by_class
        self.reset()

    def reset(self):
        self.X = np.zeros((0, DIM_X), np.float32)          # states
        self.P = np.zeros((0, DIM_X, DIM_X), np.float32)   # covariances
        self.ids = np.zeros((0,), np.int64)
        self.cls = np.zeros((0,), np.int64)
        self.score = np.zeros((0,), np.float32)
        self.hits = np.zeros((0,), np.int64)
        self.age = np.zeros((0,), np.int64)
        self.tsu = np.zeros((0,), np.int64)                # time since update
        self._next_id = 1

    def __len__(self):
        return len(self.ids)

    # ----------------------------- Kalman ops ---------------------------- #
    def _predict_all(self):
        if len(self.X) == 0:
            return
        self.X = self.X @ _F.T
        self.P = np.einsum("ij,tjk,lk->til", _F, self.P, _F) + _Q
        self.age += 1
        self.tsu += 1

    def _update_at(self, idx: np.ndarray, z: np.ndarray):
        """Batched measurement update at track rows `idx` with z [M,4]."""
        if len(idx) == 0:
            return
        X = self.X[idx]                                    # [M,7]
        P = self.P[idx]                                    # [M,7,7]
        y = z - X @ _H.T                                   # [M,4]
        S = np.einsum("ij,tjk,lk->til", _H, P, _H) + _R    # [M,4,4]
        K = np.einsum("tij,kj,tkl->til", P, _H, np.linalg.inv(S))  # [M,7,4]
        self.X[idx] = X + np.einsum("tij,tj->ti", K, y)
        KH = np.einsum("tij,jk->tik", K, _H)
        self.P[idx] = np.einsum("tij,tjk->tik", _I - KH, P)

    def _spawn(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray):
        n = len(boxes)
        if n == 0:
            return
        X = np.zeros((n, DIM_X), np.float32)
        X[:, :4] = xyxy_to_cxsysr(boxes)
        P = np.tile((_I * 10.0)[None], (n, 1, 1))
        self.X = np.concatenate([self.X, X])
        self.P = np.concatenate([self.P, P])
        self.ids = np.concatenate([self.ids,
                                   np.arange(self._next_id, self._next_id + n)])
        self._next_id += n
        self.cls = np.concatenate([self.cls, classes.astype(np.int64)])
        self.score = np.concatenate([self.score, scores.astype(np.float32)])
        self.hits = np.concatenate([self.hits, np.ones(n, np.int64)])
        self.age = np.concatenate([self.age, np.ones(n, np.int64)])
        self.tsu = np.concatenate([self.tsu, np.zeros(n, np.int64)])

    def _prune(self):
        keep = self.tsu <= self.max_age
        for name in ("X", "P", "ids", "cls", "score", "hits", "age", "tsu"):
            setattr(self, name, getattr(self, name)[keep])

    def track_boxes(self) -> np.ndarray:
        return cxsysr_to_xyxy(self.X[:, :4]) if len(self.X) else \
            np.zeros((0, 4), np.float32)

    # ------------------------------ update ------------------------------- #
    def update(self, boxes, scores, classes) -> List[Dict]:
        boxes = (np.asarray(boxes, np.float32).reshape(-1, 4)
                 if boxes is not None and len(boxes) else np.zeros((0, 4), np.float32))
        scores = (np.asarray(scores, np.float32).reshape(-1)
                  if scores is not None and len(scores) else np.zeros((len(boxes),), np.float32))
        classes = (np.asarray(classes, np.int64).reshape(-1)
                   if classes is not None and len(classes) else np.zeros((len(boxes),), np.int64))

        self._predict_all()

        if len(boxes) == 0:
            self._prune()
            return []

        # greedy IoU association (tracker.py:263-289 semantics)
        matches = []
        if len(self):
            iou = iou_xyxy(self.track_boxes(), boxes)
            if self.match_by_class:
                iou = iou * (self.cls[:, None] == classes[None, :])
            T, D = iou.shape
            order = np.argsort(-iou.reshape(-1))
            used_t, used_d = set(), set()
            for idx in order:
                i, j = divmod(int(idx), D)
                if iou[i, j] < self.iou_threshold:
                    break
                if i in used_t or j in used_d:
                    continue
                used_t.add(i)
                used_d.add(j)
                matches.append((i, j))

        if matches:
            ti = np.asarray([m[0] for m in matches])
            dj = np.asarray([m[1] for m in matches])
            self._update_at(ti, xyxy_to_cxsysr(boxes[dj]))
            self.score[ti] = np.maximum(self.score[ti], scores[dj])
            if not self.match_by_class:
                self.cls[ti] = classes[dj]
            self.hits[ti] += 1
            self.tsu[ti] = 0

        matched_d = {m[1] for m in matches}
        unmatched = np.asarray([j for j in range(len(boxes)) if j not in matched_d],
                               np.int64)
        self._spawn(boxes[unmatched], scores[unmatched], classes[unmatched])
        self._prune()

        out = []
        tb = self.track_boxes()
        for i in range(len(self)):
            if self.tsu[i] == 0 and self.hits[i] >= self.min_hits:
                out.append({"track_id": int(self.ids[i]), "bbox": tb[i],
                            "cls": int(self.cls[i]), "score": float(self.score[i])})
        return out
