"""Reusable predictor over a checkpoint: the deploy-time inference seam.

Port of `deploy/predictor.py`:
  Predictor(weights).infer_image(img_bgr, img_size, conf, iou, max_det)
    -> (boxes_xyxy, scores, classes) in ORIGINAL image pixels,
with letterbox (or square-resize) preprocessing on the host and, on the
device: uint8 -> folded normalize -> detector (channels_last, `dtype`) ->
fused heads -> decode (fp32) -> scores -> NMS (fp32, pre-NMS top-k 512, the
suppression in the CUDA kernel of `ops/cuda_nms.py`), and for a segmentation
model the masks of all `max_det` slots: the coefficients gathered by the NMS
indices times the prototypes, sigmoid, box crop (`ops/masks.py`, fp32).
The one-frame paths copy only the valid rows to the host, crop the letterbox
pad at prototype resolution, resize each mask to the frame (`cv2.resize`
INTER_LINEAR on floats, `data/imgops.resize_f32`) and binarize at 0.5;
`infer_batched_stream` computes the masks and drops them, as JAX does.

Deploy variants: `quantize="int8"` runs the convs through the dynamic
int8 kernels (`ops/quant.py`, `ops/cuda_int8.py`) on the unfolded, fused
model; `s2d_stem=True` feeds the folded model a space-to-depth packed batch
through a rewritten 2x2 stem (`deploy/s2d.py`).

Suppression is exact greedy (JAX `fixpoint_unroll=0`) at every confidence;
the JAX Predictor's default `unroll=8` approximates it on chains deeper
than 8.

Calls launch asynchronously on the current CUDA stream; results come back
through pinned host buffers and an event, so `infer_stream` (frames, batch
1) and `infer_batched_stream` keep `depth` calls in flight while the host
prepares the next one.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from yololite_tpu_torch.convert import load_flax
from yololite_tpu_torch.data.imgops import resize_f32
from yololite_tpu_torch.deploy.fold_norm import (
    fold_normalization, folded_stem, normalize_images, raw_cast,
)
from yololite_tpu_torch.deploy.fuse_head import fuse_head_params
from yololite_tpu_torch.deploy.s2d import (
    pack_s2d, pack_s2d_device, rewrite_stem_to_s2d, s2d_stem as s2d_stem_module,
)
from yololite_tpu_torch.models.detector import YOLOLiteMS
from yololite_tpu_torch.ops.decode import decode_anchorfree
from yololite_tpu_torch.ops.letterbox import (
    letterbox_image, resize_image, unletterbox_boxes,
)
from yololite_tpu_torch.ops.masks import assemble_masks_batch
from yololite_tpu_torch.ops.nms import batched_nms, yolo_scores
from yololite_tpu_torch.ops.quant import quantize_int8
from yololite_tpu_torch.train.checkpoint import load_checkpoint, model_from_meta

PRE_NMS_TOPK = 512


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def frame_masks(probs: np.ndarray, img_size: int, pad_x: int, pad_y: int,
                w: int, h: int) -> np.ndarray:
    """Prototype-resolution mask probabilities [D, Hp, Wp] in letterbox space
    -> uint8 [D, h, w] in the frame: crop the pad (Python's `round`, as
    JAX), resize each to the frame, threshold at 0.5."""
    if not len(probs):
        return np.zeros((0, h, w), np.uint8)
    r = probs.shape[1] / float(img_size)
    ya, xa = int(round(pad_y * r)), int(round(pad_x * r))
    yb, xb = int(round((img_size - pad_y) * r)), int(round((img_size - pad_x) * r))
    crop = probs[:, ya:max(ya + 1, yb), xa:max(xa + 1, xb)]
    return np.stack([(resize_f32(cm, w, h) > 0.5).astype(np.uint8) for cm in crop])


class Predictor:
    def __init__(self, weights, device: str = "cuda", dtype=torch.bfloat16,
                 use_letterbox: bool = True, fold_normalize: bool = True,
                 quantize: Optional[str] = None, s2d_stem: bool = False):
        """`weights` is a checkpoint path (JAX msgpack format), or a
        `(model, state_dict, meta)` triple of an unfused `YOLOLiteMS`, its
        torch state_dict and a meta dict (img_size, names).

        quantize="int8": every conv whose input has more than 4 channels and
        is not 1x1 runs the dynamic int8 path (`ops/quant.py`; kernels of
        `ops/cuda_int8.py` on the card); the normalize fold is off, the
        heads are fused first and quantized after. s2d_stem=True: after a
        successful fold of a 3-channel 3x3 stem, the stem becomes a 2x2 conv
        over the space-to-depth packed batch (`deploy/s2d.py`), packed on the
        host before upload (on the card for a batch already there)."""
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.device = torch.device(device)
        self.dtype = dtype
        if isinstance(weights, (tuple, list)):
            model, sd, meta = weights
        else:
            flax_sd, meta = load_checkpoint(weights)
            model = load_flax(model_from_meta(meta), flax_sd["params"],
                              flax_sd["batch_stats"])
            sd = model.state_dict()
        self.meta = meta
        self.quantize = quantize
        self.folded = self.s2d = False
        if fold_normalize and quantize is None:
            sd, self.folded = fold_normalization(sd)
            if self.folded and s2d_stem:
                sd, self.s2d = rewrite_stem_to_s2d(sd)
        sd, fused = fuse_head_params(sd)
        self.model = YOLOLiteMS(**dict(model.config, fused_head=fused
                                       or model.config["fused_head"]))
        if self.s2d:
            s2d_stem_module(self.model)
        self.model.load_state_dict(sd)
        if self.folded and not self.s2d:
            folded_stem(self.model)
        if quantize == "int8":          # int8 weights from the fp32 ones, before the cast
            quantize_int8(self.model)
        self.model.to(device=self.device, dtype=dtype).eval()
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.img_size = int(meta.get("img_size", 640))
        self.names = meta.get("names")
        self.use_letterbox = use_letterbox
        self.with_masks = bool(self.model.with_masks)

    # ------------------------------------------------------------------ #
    def forward(self, images_u8: torch.Tensor):
        """[B,S,S,3] uint8 on the device ([B,S/2,S/2,12] packed with s2d) ->
        per-level [B,A,S,S,5+C(+K)] maps (and prototypes [B,Hp,Wp,K] for a
        segmentation model). The NHWC batch viewed as NCHW is channels_last
        already."""
        x = images_u8.permute(0, 3, 1, 2)
        x = raw_cast(x, self.dtype) if self.folded else normalize_images(x, self.dtype)
        return self.model(x)

    def postprocess(self, out, img_size: int, conf: float, iou: float,
                    max_det: int):
        """The model's output -> (boxes, scores, classes, valid) [B, max_det,
        ...], plus masks [B, max_det, Hp, Wp] (probabilities, cropped to the
        boxes) for a segmentation model."""
        outs, protos = out if self.with_masks else (out, None)
        d = decode_anchorfree([o.float() for o in outs], img_size,
                              num_classes=self.model.num_classes
                              if self.with_masks else None)
        scores, classes = yolo_scores(d["obj"][..., 0], d["cls"])
        boxes, s, c, v, idx = batched_nms(d["box"], scores, classes, iou_th=iou,
                                          conf_th=conf, max_det=max_det,
                                          pre_nms_topk=PRE_NMS_TOPK)
        if protos is None:
            return boxes, s, c, v
        coef = torch.gather(d["coef"], 1, idx[..., None].long().expand(
            -1, -1, d["coef"].shape[-1]))
        return boxes, s, c, v, assemble_masks_batch(protos, coef, boxes, float(img_size))

    def _upload(self, batch) -> torch.Tensor:
        """The batch on the device; with s2d, every 3-channel batch packed:
        on the host before upload (the C++ pack), or where it lies when it
        is on the card already."""
        pack = self.s2d and batch.shape[-1] == 3
        if isinstance(batch, torch.Tensor):
            if not (pack and batch.device.type == "cpu"):
                t = batch.to(self.device, non_blocking=True)
                return pack_s2d_device(t) if pack else t
            batch = batch.numpy()
        if pack:
            batch = pack_s2d(np.asarray(batch))
        t = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _run(self, img_size: int, conf: float, iou: float, max_det: int, batch):
        """Launch one graph call; returns device tensors (not waited for)."""
        return self.postprocess(self.forward(self._upload(batch)), img_size,
                                conf, iou, max_det)

    def _launch(self, img_size, conf, iou, max_det, batch, keep_masks: bool = False):
        """Launch a call and the copy of (boxes, scores, classes, valid) back
        to the host. Returns (host tensors, event, device masks or None); the
        tensors are ready once the event has completed. The masks stay on the
        device (dropped unless `keep_masks`)."""
        out = self._run(img_size, conf, iou, max_det, batch)
        masks = out[4] if keep_masks and len(out) == 5 else None
        out = out[:4]
        if self.device.type != "cuda":
            return out, None, masks
        host = tuple(t.to("cpu", non_blocking=True) for t in out)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev, masks

    @staticmethod
    def _wait(handle):
        host, ev, _ = handle
        if ev is not None:
            ev.synchronize()
        return tuple(t.numpy() for t in host)

    @staticmethod
    def _valid_masks(handle, valid: np.ndarray):
        """The device masks of the valid slots only, on the host, as a list
        of [D_i, Hp, Wp] arrays, one per image of `valid` [B, max_det]."""
        masks = handle[2]
        if masks is None:
            return None
        sel = torch.from_numpy(np.ascontiguousarray(valid)).to(masks.device)
        rows = masks[sel].cpu().numpy()
        return np.split(rows, np.cumsum(valid.sum(1))[:-1])

    # ------------------------------------------------------------------ #
    def preprocess(self, img_rgb: np.ndarray, img_size: int):
        """Returns (canvas, ((sx, sy), pad_x, pad_y))."""
        if self.use_letterbox:
            canvas, scale, px, py = letterbox_image(img_rgb, img_size)
            return canvas, ((scale, scale), px, py)
        canvas, sx, sy = resize_image(img_rgb, img_size)
        return canvas, ((sx, sy), 0, 0)

    def _prepare(self, frames_bgr, img_size: int):
        canvases, geoms, sizes = [], [], []
        for f in frames_bgr:
            canvas, geom = self.preprocess(np.ascontiguousarray(f[..., ::-1]),
                                           img_size)
            canvases.append(canvas)
            geoms.append(geom)
            sizes.append(f.shape[:2])
        n = len(frames_bgr)
        batch = np.zeros((_bucket(n), img_size, img_size, 3), np.uint8)
        batch[:n] = np.stack(canvases)
        return batch, geoms, sizes

    def infer_image(self, img_bgr: np.ndarray, img_size: Optional[int] = None,
                    conf: float = 0.25, iou: float = 0.45, max_det: int = 300
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """BGR frame in -> (boxes xyxy px, scores, classes) in original pixels."""
        out = self.infer_image_profiled(img_bgr, img_size, conf, iou, max_det)
        return out["boxes"], out["scores"], out["classes"]

    def infer_image_profiled(self, img_bgr: np.ndarray,
                             img_size: Optional[int] = None, conf: float = 0.25,
                             iou: float = 0.45, max_det: int = 300) -> Dict:
        img_size = int(img_size or self.img_size)
        h, w = img_bgr.shape[:2]
        t0 = time.perf_counter()
        canvas, (scale, px, py) = self.preprocess(
            np.ascontiguousarray(img_bgr[..., ::-1]), img_size)
        t1 = time.perf_counter()
        handle = self._launch(img_size, conf, iou, max_det, canvas[None],
                              keep_masks=True)
        boxes, scores, classes, valid = self._wait(handle)
        probs = self._valid_masks(handle, valid)
        t2 = time.perf_counter()
        m = valid[0]
        b = unletterbox_boxes(boxes[0][m], scale, px, py, w, h)
        masks = (None if probs is None
                 else frame_masks(probs[0], img_size, px, py, w, h))
        t3 = time.perf_counter()
        return {"boxes": b, "scores": scores[0][m], "classes": classes[0][m],
                "masks": masks, "names": self.names,
                "speed": {"preprocess_ms": (t1 - t0) * 1e3,
                          "inference_ms": (t2 - t1) * 1e3,
                          "postprocess_ms": (t3 - t2) * 1e3,
                          "total_ms": (t3 - t0) * 1e3}}

    def _results(self, arrays, geoms, sizes, n: int, per: Dict[str, float],
                 img_size: int = 0, probs=None):
        boxes, scores, classes, valid = arrays
        results = []
        for i in range(n):
            m = valid[i]
            masks = None
            if geoms is None:
                b = boxes[i][m]
            else:
                (scale, px, py), (h, w) = geoms[i], sizes[i]
                b = unletterbox_boxes(boxes[i][m], scale, px, py, w, h)
                if probs is not None:
                    masks = frame_masks(probs[i], img_size, px, py, w, h)
            results.append({"boxes": b, "scores": scores[i][m],
                            "classes": classes[i][m], "masks": masks,
                            "names": self.names, "speed": dict(per)})
        return results

    def infer_batch(self, frames_bgr, img_size: Optional[int] = None,
                    conf: float = 0.25, iou: float = 0.45, max_det: int = 300):
        """One call per power-of-2 batch bucket; per-image back-mapping.
        Returns a list of result dicts like infer_image_profiled."""
        img_size = int(img_size or self.img_size)
        n = len(frames_bgr)
        if n == 0:
            return []
        t0 = time.perf_counter()
        batch, geoms, sizes = self._prepare(frames_bgr, img_size)
        t1 = time.perf_counter()
        handle = self._launch(img_size, conf, iou, max_det, batch, keep_masks=True)
        arrays = self._wait(handle)
        probs = self._valid_masks(handle, arrays[3])
        t2 = time.perf_counter()
        per_pre, per_inf = (t1 - t0) * 1e3 / n, (t2 - t1) * 1e3 / n
        return self._results(arrays, geoms, sizes, n,
                             {"preprocess_ms": per_pre, "inference_ms": per_inf,
                              "postprocess_ms": 0.0,
                              "total_ms": per_pre + per_inf}, img_size, probs)

    def infer_stream(self, frames_bgr, img_size: Optional[int] = None,
                     conf: float = 0.25, iou: float = 0.45, max_det: int = 300,
                     depth: int = 2):
        """Streaming video inference: a generator over an iterable of BGR
        frames (batch 1, letterboxed) that keeps `depth` graph calls in flight
        (depth <= 0: synchronous; JAX keeps one in flight at depth 0, with the
        same results), so frame i+1's letterbox and upload overlap frame i's
        device work. Yields, in order, dicts of `boxes` (frame pixels),
        `scores`, `classes`, `names` and `speed` {preprocess_ms, sync_ms}; a
        segmentation model's masks are dropped, as JAX drops them."""
        img_size = int(img_size or self.img_size)
        inflight = deque()

        def finalize(item):
            handle, (scale, px, py), (h, w), t_pre = item
            t0 = time.perf_counter()
            boxes, scores, classes, valid = self._wait(handle)
            m = valid[0]
            b = unletterbox_boxes(boxes[0][m], scale, px, py, w, h)
            return {"boxes": b, "scores": scores[0][m], "classes": classes[0][m],
                    "names": self.names,
                    "speed": {"preprocess_ms": t_pre * 1e3,
                              "sync_ms": (time.perf_counter() - t0) * 1e3}}

        for frame in frames_bgr:
            t0 = time.perf_counter()
            canvas, geom = self.preprocess(np.ascontiguousarray(frame[..., ::-1]),
                                           img_size)
            t_pre = time.perf_counter() - t0
            inflight.append((self._launch(img_size, conf, iou, max_det, canvas[None]),
                             geom, frame.shape[:2], t_pre))
            if len(inflight) > max(depth, 0):
                yield finalize(inflight.popleft())
        while inflight:
            yield finalize(inflight.popleft())

    def infer_batched_stream(self, batches, img_size: Optional[int] = None,
                             conf: float = 0.25, iou: float = 0.45,
                             max_det: int = 300, depth: int = 2,
                             prepared: bool = False):
        """Sustained batched serving: a generator over an iterable of frame
        batches that keeps `depth` calls in flight (depth <= 0: synchronous).

        Each item is a list of BGR frames (padded to a power-of-2 bucket), or,
        with prepared=True, an already letterboxed uint8 [B, S, S, 3] array
        (or a tensor already on the device); then back-mapping is skipped and
        canvas-space boxes are yielded. Yields one list of result dicts per
        input batch, in order."""
        img_size = int(img_size or self.img_size)
        inflight = deque()

        def finalize(item):
            handle, geoms, sizes, n, t_pre = item
            return self._results(self._wait(handle), geoms, sizes, n,
                                 {"preprocess_ms": t_pre * 1e3 / n})

        for item in batches:
            t0 = time.perf_counter()
            if prepared:
                batch, geoms, sizes, n = item, None, None, len(item)
            else:
                batch, geoms, sizes = self._prepare(item, img_size)
                n = len(item)
            t_pre = time.perf_counter() - t0
            inflight.append((self._launch(img_size, conf, iou, max_det, batch),
                             geoms, sizes, n, t_pre))
            if len(inflight) > max(depth, 0):
                yield finalize(inflight.popleft())
        while inflight:
            yield finalize(inflight.popleft())

    def warmup(self, img_size: Optional[int] = None, conf: float = 0.25,
               iou: float = 0.45, max_det: int = 300):
        img_size = int(img_size or self.img_size)
        self._wait(self._launch(img_size, conf, iou, max_det,
                                np.zeros((1, img_size, img_size, 3), np.uint8)))
