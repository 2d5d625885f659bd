"""Model export: `torch.export` artifacts (raw / decoded / nms), first-party
ONNX (raw / decoded) and first-party TFLite (raw / decoded / nms). Port of
`deploy/export.py`.

  - "raw"     : the graph emits the tuple of per-level maps [B,A,S,S,5+C(+K)]
                (and the prototypes [B,Hp,Wp,K] of a segmentation model)
  - "decoded" : {boxes_xyxy, cls_logits, obj_logits (, mask_coef, protos)}:
                decode inside the graph (fp32), NMS outside
  - "nms"     : the whole graph, class-aware NMS (pre-NMS top-k 512, the
                suppression through `torch.ops.yololite.nms_suppress`)
                included: (boxes, scores, classes, valid (, masks))

Every graph takes a uint8 NHWC batch, as the Predictor's does: the ImageNet
normalize is folded into the stem conv and the heads are fused. The
artifact is a `torch.export` program saved as `<stem>_<fmt>.pt2` (the
counterpart of JAX's serialized StableHLO) with a `.json` sidecar of JAX's
keys; it runs on the device it was exported on. `export_onnx` writes the
"raw" and "decoded" graphs in fp32 as opset-17 ONNX through the port's own
emitter (`deploy/onnx_emit.py`), which needs no `onnx` package; the port's
`deploy/onnx_run.py` (numpy) runs them on a host. `export_tflite` writes
all three formats in fp32, fp16 weights or dynamic-range int8 weights as a
`.tflite` file of builtin ops through the port's own emitter
(`deploy/tflite_emit.py`; no TensorFlow), with JAX's `serving_default`
signature (input `images`) and sidecar, so that JAX's `load_tflite` and
`tf.lite.Interpreter` run it; the port's `deploy/tflite_run.py` (numpy)
runs it on a host without TensorFlow.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from yololite_tpu_torch.deploy.fold_norm import FoldedStemConv
from yololite_tpu_torch.ops.anchors import make_anchors
from yololite_tpu_torch.ops.decode import decode_anchorfree, flatten_levels

FORMATS = ("raw", "decoded", "nms")


class _FrozenStemConv(nn.Conv2d):
    """A folded stem conv whose correction map for one input size is a
    buffer: `FoldedStemConv` caches it by `data_ptr()`, which a tracer's
    tensors do not have."""

    def __init__(self, stem: FoldedStemConv, h: int, w: int):
        super().__init__(stem.in_channels, stem.out_channels, stem.kernel_size,
                         stride=stem.stride, padding=stem.padding, groups=stem.groups,
                         bias=stem.bias is not None, device=stem.weight.device,
                         dtype=stem.weight.dtype)
        self.load_state_dict(stem.state_dict())
        self.register_buffer("correction", stem.correction(h, w).clone())

    def forward(self, x):
        return super().forward(x) + self.correction


class DeployGraph(nn.Module):
    """The Predictor's device graph in one format, as a module to export:
    uint8 [B,S,S,3] -> the format's outputs (see the module docstring)."""

    def __init__(self, pred, img_size: int, fmt: str, conf: float, iou: float,
                 max_det: int):
        super().__init__()
        if fmt not in FORMATS:
            raise ValueError(f"export format {fmt!r}: one of {FORMATS}")
        self.pred, self.fmt = pred, fmt
        self.img_size, self.conf, self.iou, self.max_det = img_size, conf, iou, max_det
        self.model = pred.model
        probe = torch.zeros((1, img_size, img_size, 3), dtype=torch.uint8,
                            device=pred.device)
        stems = [(n, m) for n, m in self.model.named_modules()
                 if isinstance(m, FoldedStemConv)]
        sizes = {}
        hooks = [m.register_forward_pre_hook(lambda m, a: sizes.update({m: a[0].shape[2:]}))
                 for _, m in stems]
        with torch.no_grad():
            out = pred.forward(probe)
        for hook in hooks:
            hook.remove()
        for name, mod in stems:
            parent, attr = name.rsplit(".", 1)
            setattr(self.model.get_submodule(parent), attr, _FrozenStemConv(mod, *sizes[mod]))
        # fill the anchor-grid cache with real tensors, which the trace then
        # holds as constants (a grid first made under the tracer would be fake)
        outs = out[0] if pred.with_masks else out
        make_anchors(flatten_levels(outs)[1], img_size, device=pred.device)

    def forward(self, images_u8: torch.Tensor):
        return graph_outputs(self.pred, self.pred.forward(images_u8), self.fmt,
                             self.img_size, self.conf, self.iou, self.max_det)


def graph_outputs(pred, out, fmt: str, img_size: int, conf: float, iou: float,
                  max_det: int):
    """A format's outputs from the Predictor's model output `out`: what an
    exported graph returns, and, called eagerly, what it is held against."""
    outs, protos = out if pred.with_masks else (out, None)
    if fmt == "raw":
        return tuple(outs) + ((protos,) if protos is not None else ())
    if fmt == "nms":
        return tuple(pred.postprocess(out, img_size, conf, iou, max_det))
    d = decode_anchorfree([o.float() for o in outs], img_size,
                          num_classes=pred.model.num_classes if pred.with_masks else None)
    # sorted keys, the order of JAX's flattened dict (and its ONNX outputs)
    res = {"boxes_xyxy": d["box"], "cls_logits": d["cls"]}
    if protos is not None:
        res["mask_coef"] = d["coef"]
    res["obj_logits"] = d["obj"]
    if protos is not None:
        res["protos"] = protos.float()
    return res


def output_names(with_masks: bool, fmt: str, n_levels: int):
    """Names of a format's flattened outputs (JAX's, for its tuple formats
    and its sorted dict keys)."""
    if fmt == "raw":
        return [f"level_{i}" for i in range(n_levels)] + (["protos"] if with_masks else [])
    if fmt == "decoded":
        return sorted(["boxes_xyxy", "obj_logits", "cls_logits"]
                      + (["mask_coef", "protos"] if with_masks else []))
    return ["boxes", "scores", "classes", "valid"] + (["masks"] if with_masks else [])


def _artifact_path(weights, out_dir: Optional[str], fmt: str, ext: str) -> str:
    src = weights if isinstance(weights, str) else "model"
    out_dir = out_dir or os.path.dirname(os.path.abspath(src))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(out_dir, f"{stem}_{fmt}{ext}")


def _sidecar(path: str, weights, pred, fmt: str, img_size: int, batch, conf: float,
             iou: float, max_det: int, **extra) -> None:
    meta = pred.meta
    with open(path + ".json", "w") as f:
        json.dump({"format": fmt, "img_size": img_size, "batch": batch,
                   "conf": conf, "iou": iou, "max_det": max_det,
                   "names": meta.get("names"), "num_classes": meta.get("num_classes"),
                   "letterbox": True, "normalize": "imagenet/on-device",
                   "source_ckpt": (os.path.abspath(weights)
                                   if isinstance(weights, str) else None),
                   **extra}, f, indent=2)


def _output_names(pred, fmt: str):
    return output_names(pred.with_masks, fmt, len(pred.model.get_num_anchors_per_level()))


def export_model(weights, out_dir: Optional[str] = None, fmt: str = "decoded",
                 batch: int = 1, img_size: Optional[int] = None, conf: float = 0.001,
                 iou: float = 0.65, max_det: int = 300, dtype=torch.bfloat16,
                 device: str = "cuda") -> str:
    """Export a checkpoint (path, or a `(model, state_dict, meta)` triple as
    the Predictor takes) as a `torch.export` program of `fmt` for a uint8
    [batch, S, S, 3] input on `device`. Returns `<stem>_<fmt>.pt2`; a `.json`
    sidecar sits next to it."""
    from yololite_tpu_torch.deploy.predictor import Predictor
    pred = Predictor(weights, device=device, dtype=dtype)
    img_size = int(img_size or pred.img_size)
    graph = DeployGraph(pred, img_size, fmt, conf, iou, max_det)
    images = torch.zeros((batch, img_size, img_size, 3), dtype=torch.uint8,
                         device=pred.device)
    with torch.no_grad():
        program = torch.export.export(graph, (images,))
    program.example_inputs = None        # else the archive holds the example batch
    path = _artifact_path(weights, out_dir, fmt, ".pt2")
    torch.export.save(program, path)
    _sidecar(path, weights, pred, fmt, img_size, batch, conf, iou, max_det,
             outputs=_output_names(pred, fmt), runtime="torch.export",
             device=str(pred.device), dtype=str(dtype).replace("torch.", ""))
    return path


def _read_sidecar(path: str) -> dict:
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            return json.load(f)
    return {}


def load_exported(path: str):
    """Load an artifact; returns (callable(images_u8), meta). `.tflite` and
    `.onnx` run on the host through `load_tflite` and `load_onnx_artifact`;
    anything else is a `torch.export`
    program, which runs on the device it was exported on and takes a uint8
    tensor or array. "decoded" returns a dict, "raw" and "nms" tuples."""
    if path.endswith(".tflite"):
        return load_tflite(path)
    if path.endswith(".onnx"):
        return load_onnx_artifact(path)
    from yololite_tpu_torch.ops import cuda_nms  # noqa: F401 registers yololite::nms_suppress
    meta = _read_sidecar(path)
    program = torch.export.load(path).module()
    device = torch.device(meta.get("device", "cpu"))

    def call(images_u8):
        x = images_u8 if isinstance(images_u8, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(images_u8, np.uint8))
        with torch.no_grad():
            out = program(x.to(device))
        return dict(out) if isinstance(out, dict) else tuple(out)

    return call, meta


def export_onnx(weights, out_dir: Optional[str] = None, fmt: str = "decoded",
                batch: int = 1, img_size: Optional[int] = None, conf: float = 0.001,
                iou: float = 0.65, max_det: int = 300, dynamic_batch: bool = False) -> str:
    """ONNX export of the fp32 "raw" or "decoded" graph, traced on the CPU and
    written by `deploy/onnx_emit.py`. As in JAX, NMS stays on the host:
    fmt="nms" raises. dynamic_batch=True declares the batch axis symbolic
    (traced at batch max(batch, 2) with a `torch.export.Dim`), so one file
    serves any batch size. Returns `<stem>_<fmt>.onnx`."""
    if fmt == "nms":
        raise ValueError("ONNX export covers fmt='raw'/'decoded' with host-side NMS "
                         "(as the JAX package gates it); use export_model for the "
                         "in-graph-NMS artifact.")
    from yololite_tpu_torch.deploy.onnx_emit import export_program_to_onnx
    from yololite_tpu_torch.deploy.predictor import Predictor
    pred = Predictor(weights, device="cpu", dtype=torch.float32)
    img_size = int(img_size or pred.img_size)
    graph = DeployGraph(pred, img_size, fmt, conf, iou, max_det)
    trace_batch = max(int(batch), 2) if dynamic_batch else int(batch)
    images = torch.zeros((trace_batch, img_size, img_size, 3), dtype=torch.uint8)
    shapes = ({"images_u8": {0: torch.export.Dim("batch", min=1, max=65536)}}
              if dynamic_batch else None)
    with torch.no_grad():
        program = torch.export.export(graph, (images,), dynamic_shapes=shapes)
    path = _artifact_path(weights, out_dir, fmt, ".onnx")
    names = _output_names(pred, fmt)
    stem = os.path.splitext(os.path.basename(path))[0]
    export_program_to_onnx(program, path, input_names=["images"], output_names=names,
                           model_name=f"{pred.meta.get('model_name', stem)}",
                           doc=f"YoloLite {fmt} deploy graph @{img_size}px")
    _sidecar(path, weights, pred, fmt, img_size, "dynamic" if dynamic_batch else batch,
             conf, iou, max_det, outputs=names, runtime="onnx",
             normalize="imagenet/in-graph")
    return path


def load_onnx_artifact(path: str):
    """Load a .onnx artifact; returns (callable(images_u8) -> numpy outputs,
    meta), run by the port's numpy executor: "decoded" gives the dict of
    outputs, "raw" the tuple of level maps."""
    from yololite_tpu_torch.deploy.onnx_run import load_onnx
    meta = _read_sidecar(path)
    graph = load_onnx(path)
    names = meta.get("outputs") or graph.output_names

    def call(images_u8):
        outs = graph(np.asarray(images_u8, np.uint8))
        return dict(zip(names, outs)) if meta.get("format") == "decoded" else tuple(outs)

    return call, meta


def export_tflite(weights, out_dir: Optional[str] = None, fmt: str = "decoded",
                  batch: int = 1, img_size: Optional[int] = None, conf: float = 0.001,
                  iou: float = 0.65, max_det: int = 300,
                  quantize: Optional[str] = None) -> str:
    """TFLite export (JAX's signature): the fp32 graph of `fmt`, traced on the
    CPU at a static [batch, S, S, 3] uint8 input and written by
    `deploy/tflite_emit.py`, the ImageNet normalize in the graph (not
    folded). quantize: None, "fp16" (float16 weights, each
    dequantized) or "dynamic" (int8 weights per output channel; the
    runtime's hybrid kernels). "nms" holds the whole class-aware NMS in
    builtin ops (a WHILE loop for the greedy scan). Returns
    `<stem>_<fmt>.tflite`; a `.json` sidecar of JAX's keys sits next to it."""
    from yololite_tpu_torch.deploy.predictor import Predictor
    from yololite_tpu_torch.deploy.tflite_emit import QUANTIZE, export_program_to_tflite
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be one of {QUANTIZE}, got {quantize!r}")
    # the normalize stays in the graph, as in JAX's file: the folded stem's
    # correction map would be a constant of the stem's output size (6.6 MB
    # for edge_n @640, three times its weights)
    pred = Predictor(weights, device="cpu", dtype=torch.float32, fold_normalize=False)
    img_size = int(img_size or pred.img_size)
    graph = DeployGraph(pred, img_size, fmt, conf, iou, max_det)
    images = torch.zeros((int(batch), img_size, img_size, 3), dtype=torch.uint8)
    with torch.no_grad():
        program = torch.export.export(graph, (images,))
    path = _artifact_path(weights, out_dir, fmt, ".tflite")
    names = _output_names(pred, fmt)
    export_program_to_tflite(program, path, input_names=["images"], output_names=names,
                             quantize=quantize,
                             description=f"YoloLite {fmt} deploy graph @{img_size}px")
    _sidecar(path, weights, pred, fmt, img_size, int(batch), conf, iou, max_det,
             outputs=names, quantize=quantize, normalize="imagenet/in-graph",
             runtime="tflite")
    return path


def load_tflite(path: str):
    """Load a .tflite artifact; returns (callable(images_u8) -> numpy
    outputs, meta), run on the host by the port's numpy executor
    (`deploy/tflite_run.py`): "decoded" gives the dict of outputs, "raw" and
    "nms" the tuple in the sidecar's `outputs` order."""
    from yololite_tpu_torch.deploy.tflite_run import TFLiteModel
    meta = _read_sidecar(path)
    model = TFLiteModel(path)
    names = meta.get("outputs") or model.output_names
    as_dict = meta.get("format") == "decoded"

    def call(images_u8):
        x = images_u8.cpu().numpy() if isinstance(images_u8, torch.Tensor) else images_u8
        out = model.run_signature(images=np.ascontiguousarray(x, np.uint8))
        return {n: out[n] for n in names} if as_dict else tuple(out[n] for n in names)

    return call, meta
