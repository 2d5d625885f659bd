"""Public library API: the `YoloLite` class (port of `api.py`, predict only).

    model = YoloLite("edge_n")      # model name / model yaml / checkpoint
    model = YoloLite("runs/det/1/weights/best_model_state.ckpt")   # on CUDA
    results = model.predict(frame_bgr)[0]
    results["boxes"]   # xyxy np.ndarray (original pixels)
    results["speed"]   # {"preprocess_ms", "inference_ms", ..., "total_ms"}

Sources are decoded BGR uint8 arrays (or `.npy` files of them): the package
carries no image codec. A model name or yaml resolves as in the JAX API
(configs/models, then v2_models, then custom); predicting needs a
checkpoint, as there. Training, validation and export are later slices.
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
        `(model, state_dict, meta)` triple (see `Predictor`)."""
        if task != "detect":
            raise NotImplementedError("segmentation: ROADMAP Queue 1 item 9")
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
                **_ignored) -> List[Dict[str, Any]]:
        pred = self.predictor
        frames, names = [], []
        for item in self._expand_source(source):
            if isinstance(item, str):
                if not item.endswith(".npy"):
                    raise ValueError(f"{item}: pass decoded BGR arrays or .npy "
                                     "files; this package has no image codec")
                frames.append(np.load(item))
                names.append(item)
            else:
                frames.append(np.asarray(item))
                names.append(None)
        if batch and len(frames) > 1:
            results = pred.infer_batch(frames, img_size, conf, iou, max_det)
        else:
            results = [pred.infer_image_profiled(f, img_size, conf, iou, max_det)
                       for f in frames]
        for r, name in zip(results, names):
            r["source"] = name
        return results

    @staticmethod
    def _expand_source(source):
        if isinstance(source, (list, tuple)):
            return list(source)
        if isinstance(source, np.ndarray):
            return [source]
        if isinstance(source, str) and os.path.isdir(source):
            return sorted(glob.glob(os.path.join(source, "*.npy")))
        return [source]

    def train(self, *args, **kwargs):
        raise NotImplementedError("training: ROADMAP Queue 1 item 8")

    def val(self, *args, **kwargs):
        raise NotImplementedError("evaluation: ROADMAP Queue 1 item 7")

    def export(self, *args, **kwargs):
        raise NotImplementedError("export: ROADMAP Queue 1 item 12")
