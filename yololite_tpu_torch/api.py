"""Public library API: the `YoloLite` class (port of `api.py`).

    model = YoloLite("edge_n")      # model name / model yaml / checkpoint
    model.train(data="data.yaml", epochs=20)   # on CUDA, the recipe's augmentation
    results = model.predict(frame_bgr)[0]      # the best checkpoint
    results["boxes"]   # xyxy np.ndarray (original pixels)
    results["masks"]   # uint8 [D, H, W] for a segmentation model, else None
    results["speed"]   # {"preprocess_ms", "inference_ms", ..., "total_ms"}
    stats = model.val(data="data.yaml")        # {"map", "map_50", ...}

Sources are decoded BGR uint8 arrays, JPEG, PNG, BMP, TIFF or WebP files
(read by the port's host codecs as `cv2.imread` reads them, `data/codecs.py`), `.npy`
files of BGR arrays, or a folder of them; datasets take the same files
(`data/dataset.py`). A file that cannot be decoded raises
`FileNotFoundError` naming it, as in the JAX API; a format cv2 reads and
the codecs do not (GIF, JPEG 2000, ...) raises `UnsupportedImage`. `draw=True` adds the drawn detections as an RGB
"plot"; `save_dir=` also writes it under the source's basename (an array
as `pred_{n}.jpg`), encoded by the extension (`data/imwrite.py`).
A model name or yaml resolves as in the JAX API (configs/models, then
v2_models, then custom); predicting needs a checkpoint, as there. Everything
runs on `device` (the card by default; tests pass "cpu"). `export` writes a
`torch.export` program (`.pt2`) of the "raw", "decoded" or "nms" graph.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from yololite_tpu_torch.config import resolve_model_arg


class YoloLite:
    def __init__(self, model="edge_n", device: str = "cuda", task: str = "detect"):
        """`model` is a model name, a model yaml, a checkpoint path, or a
        `(model, state_dict, meta)` triple (see `Predictor`). `task` is only
        stored, as in the JAX API: segmentation comes from the model config
        (`with_masks: true` or `task: segment`)."""
        self.task = task
        self.device = device
        self._src = ({"weights": model} if isinstance(model, (tuple, list))
                     else resolve_model_arg(str(model)))
        self._predictor = None

    @property
    def predictor(self):
        if self._predictor is None:
            weights = self._src.get("weights", self._src.get("ckpt"))
            if weights is None:
                raise RuntimeError("predict() needs a trained checkpoint; "
                                   "train first or pass a .ckpt path.")
            from yololite_tpu_torch.deploy.predictor import Predictor
            self._predictor = Predictor(weights, device=self.device)
        return self._predictor

    def predict(self, source: Union[str, np.ndarray, Sequence], conf: float = 0.25,
                iou: float = 0.45, max_det: int = 300,
                img_size: Optional[int] = None, batch: bool = True,
                draw: bool = False, save_dir: Optional[str] = None,
                **_ignored) -> List[Dict[str, Any]]:
        """Detections (and, for a segmentation model, uint8 masks of each
        frame's shape under "masks") for BGR arrays, image files (JPEG, PNG,
        BMP, TIFF, WebP) or `.npy` files, or a folder of them. A file that does not decode raises
        `FileNotFoundError(path)`, as JAX's does where cv2.imread gives None."""
        from yololite_tpu_torch.data.dataset import read_image_rgb
        pred = self.predictor
        frames, names = [], []
        for item in self._expand_source(source):
            if isinstance(item, str):
                try:
                    rgb = read_image_rgb(item)
                except ValueError as e:         # cv2.imread would give None
                    raise FileNotFoundError(item) from e
                # BGR, as the JAX package's cv2.imread hands frames on
                frames.append(np.ascontiguousarray(rgb[..., ::-1]))
                names.append(item)
            else:
                frames.append(np.asarray(item))
                names.append(None)
        if batch and len(frames) > 1:
            results = pred.infer_batch(frames, img_size, conf, iou, max_det)
        else:
            results = [pred.infer_image_profiled(f, img_size, conf, iou, max_det)
                       for f in frames]
        for i, (r, frame, name) in enumerate(zip(results, frames, names)):
            r["source"] = name
            if draw or save_dir:
                from yololite_tpu_torch.utils.viz import draw_detections
                vis_rgb = draw_detections(frame[..., ::-1], r["boxes"], r["scores"],
                                          r["classes"], pred.names)
                r["plot"] = vis_rgb
                if save_dir:
                    from yololite_tpu_torch.data.imwrite import imwrite_bgr
                    os.makedirs(save_dir, exist_ok=True)
                    base = os.path.basename(name) if name else f"pred_{i}.jpg"
                    imwrite_bgr(os.path.join(save_dir, base), vis_rgb[..., ::-1])
        return results

    @staticmethod
    def _expand_source(source):
        if isinstance(source, (list, tuple)):
            return list(source)
        if isinstance(source, np.ndarray):
            return [source]
        if isinstance(source, str) and os.path.isdir(source):
            # JAX's patterns, plus the port's .npy frames
            files = []
            for e in ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.npy"):
                files += glob.glob(os.path.join(source, e))
            return sorted(files)
        return [source]

    def train(self, data: str, epochs: int = 100, batch_size: Optional[int] = None,
              batch: Optional[int] = None, img_size: Optional[int] = None,
              workers: int = 4, accumulate: int = 1, warmup: int = 0,
              freeze_backbone: int = 0, lr: Optional[float] = None,
              train_yaml: Optional[str] = None, run_dir: str = "runs/det",
              **overrides) -> Dict[str, Any]:
        """Train on `data` (a data.yaml) with configs/train/standard_train.yaml
        (or `train_yaml`) and `overrides` of its `training` block
        (`data_parallel=N` trains on N GPUs, one process each;
        `spatial_parallel=S` splits each image's height over S of them);
        afterwards this object serves the best checkpoint."""
        from yololite_tpu_torch.config.config import (REPO_ROOT, load_configs, next_run_dir,
                                                      update_latest_pointer)
        from yololite_tpu_torch.train.checkpoint import load_checkpoint
        from yololite_tpu_torch.train.loop import train_from_config

        model_yaml = self._src.get("model_yaml")
        base_cfg = None
        if model_yaml is None:
            if "ckpt" not in self._src:
                raise RuntimeError("train() needs a model name, yaml or checkpoint path")
            _, meta = load_checkpoint(self._src["ckpt"])   # fine-tune: config from meta
            base_cfg = meta.get("config", {})
        train_yaml = train_yaml or os.path.join(REPO_ROOT, "configs", "train",
                                                "standard_train.yaml")
        if not os.path.exists(train_yaml):
            train_yaml = None
        cfg = load_configs(model_yaml, train_yaml, data, make_run_dir=False)
        if base_cfg:
            model_block = dict(base_cfg.get("model", {}))
            model_block.update(cfg.get("model", {}))
            cfg["model"] = model_block
            cfg["training"].setdefault("resume", self._src["ckpt"])

        tr = cfg.setdefault("training", {})
        tr["epochs"] = int(epochs)
        if batch_size or batch:
            tr["batch_size"] = int(batch_size or batch)
        tr.setdefault("batch_size", 16)
        if img_size:
            tr["img_size"] = int(img_size)
        tr["num_workers"] = int(workers)
        tr["accumulate"] = int(accumulate)
        if warmup:
            tr["warmup_epochs"] = int(warmup)
        if freeze_backbone:
            tr["freeze_backbone_epochs"] = int(freeze_backbone)
        if lr is not None:
            tr["lr"] = float(lr)
        tr.update(overrides)

        rd = next_run_dir(run_dir)
        cfg["logging"] = {"log_dir": rd}
        update_latest_pointer(os.path.dirname(rd), rd)
        results = train_from_config(cfg, device=self.device)
        for name in ("best_model_state.ckpt", "best_no_aug.ckpt", "last_model_state.ckpt"):
            best = os.path.join(rd, "weights", name)
            if os.path.exists(best):
                self._src = {"ckpt": best}
                self._predictor = None
                break
        return results

    def val(self, data: str, split: str = "val", batch_size: int = 8,
            conf: float = 0.001, iou: float = 0.65,
            img_size: Optional[int] = None, out_dir: str = "runs/val") -> Dict[str, Any]:
        """COCO evaluation of this object's checkpoint on a split of `data`."""
        from yololite_tpu_torch.config.config import load_configs
        from yololite_tpu_torch.eval.evaluate import evaluate_checkpoint
        from yololite_tpu_torch.train.checkpoint import load_checkpoint

        if "ckpt" not in self._src:
            raise RuntimeError("val() needs a trained checkpoint; train first or pass "
                               "a .ckpt path.")
        ckpt = load_checkpoint(self._src["ckpt"])
        meta = ckpt[1]
        cfg = load_configs(None, None, data, make_run_dir=False)
        ds_cfg = cfg["dataset"]
        key = "test" if split == "test" and ds_cfg.get("test_images") else "val"
        num_classes = int(meta.get("num_classes", len(ds_cfg.get("names", [])) or 1))
        results = evaluate_checkpoint(
            ckpt, ds_cfg.get(f"{key}_images"), ds_cfg.get(f"{key}_labels"),
            out_dir, num_classes, ds_cfg.get("names"), batch_size=batch_size, conf=conf,
            iou=iou, img_size=img_size, device=self.device)
        stats = results["coco"]
        return {"map": stats["AP"], "map_50": stats["AP50"], "map_75": stats["AP75"],
                **stats, "best_f1": results["best_f1"], "best_conf": results["best_conf"],
                "ms_per_img": results["ms_per_img"]}

    def export(self, format: str = "decoded", batch: int = 1,
               img_size: Optional[int] = None, simplify: bool = True,
               verbose: bool = False, **kw) -> str:
        """Export this object's checkpoint as a `.pt2` program
        (`deploy/export.export_model`; `kw` goes there) on this object's
        device. As in the JAX API, format="onnx" gives the "decoded"
        artifact (JAX's StableHLO one; here the `.pt2`), not an ONNX file:
        `deploy/export.export_onnx` writes ONNX."""
        from yololite_tpu_torch.deploy.export import export_model
        weights = self._src.get("weights", self._src.get("ckpt"))
        if weights is None:
            raise RuntimeError("export() needs a trained checkpoint; train first or "
                               "pass a .ckpt path.")
        fmt = {"onnx": "decoded"}.get(format, format)
        kw.setdefault("device", self.device)
        path = export_model(weights, fmt=fmt, batch=batch, img_size=img_size, **kw)
        if verbose:
            print(f"exported -> {path}")
        return path
