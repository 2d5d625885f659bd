"""First-party TFLite executor (numpy; convs through torch's CPU kernels).

The counterpart of the `tf.lite.Interpreter` that JAX's `load_tflite` uses,
as `deploy/onnx_run.py` stands in for onnxruntime: the card's machine has no
TensorFlow, so this is how the port runs a `.tflite` file there. It reads a
file with the port's FlatBuffers codec (`deploy/tflite_schema.py`) and runs
every builtin op that `deploy/tflite_emit.py` writes, the WHILE loop of the
"nms" graph, fp16 weights (DEQUANTIZE) and the hybrid int8 kernels of a
dynamic-range file, plus the few other builtins of JAX's own "decoded"
file (TF's converter: SLICE, SELECT). Any other op, or option, raises
`NotImplementedError` naming it; it does not run Flex (`Flex*` custom)
ops.

Hybrid kernels (an int8 weight under an fp32 activation) follow TFLite's:
the input is quantized per batch item, asymmetric int8 over its min and max
(zero point chosen so that 0.0 is exact), the integer product summed, then
scaled by input scale x weight scale of the output channel, and the bias
added in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from yololite_tpu_torch.deploy import tflite_schema as S

_ACT = {S.ACT_NONE: lambda x: x, S.ACT_RELU: lambda x: np.maximum(x, 0),
        S.ACT_RELU6: lambda x: np.clip(x, 0, 6)}
_BINARY = {"ADD": np.add, "SUB": np.subtract, "MUL": np.multiply,
           "MAXIMUM": np.maximum, "MINIMUM": np.minimum, "GREATER": np.greater,
           "GREATER_EQUAL": np.greater_equal, "LESS": np.less, "LESS_EQUAL": np.less_equal,
           "EQUAL": np.equal, "NOT_EQUAL": np.not_equal, "LOGICAL_AND": np.logical_and,
           "LOGICAL_OR": np.logical_or, "DIV": np.divide}


def _f32(x):
    return np.asarray(x, np.float32)


def _logistic(x):
    with np.errstate(over="ignore"):
        return (1.0 / (1.0 + np.exp(-x))).astype(x.dtype)


def _gelu(x, approximate: bool):
    x = _f32(x)
    if approximate:
        inner = np.float32(math.sqrt(2.0 / math.pi)) * (x + np.float32(0.044715) * x * x * x)
        return (np.float32(0.5) * x * (np.float32(1.0) + np.tanh(inner))).astype(np.float32)
    return torch.nn.functional.gelu(torch.from_numpy(np.ascontiguousarray(x))).numpy()


_UNARY = {"RELU": lambda x: np.maximum(x, 0).astype(x.dtype),
          "RELU6": lambda x: np.clip(x, 0, 6).astype(x.dtype),
          "LOGISTIC": _logistic, "TANH": np.tanh, "EXP": np.exp,
          "LOG": np.log, "ABS": np.abs, "NEG": np.negative, "SQRT": np.sqrt,
          "RSQRT": lambda x: (1.0 / np.sqrt(x)).astype(x.dtype),
          "LOGICAL_NOT": np.logical_not,
          "HARD_SWISH": lambda x: (x * np.clip(x + 3, 0, 6) / 6).astype(x.dtype)}


def _round_away(x):
    """std::round: halves away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _quantize_rows(x: np.ndarray):
    """TFLite's AsymmetricQuantizeFloats per batch item, in its arithmetic:
    min and max widened to 0, the zero point from the end with the smaller
    error, an fp32 scale and q = round(zp + x * (1 / scale)) in fp32.
    Returns (q, scale [B] fp32, zero point [B])."""
    b = x.shape[0]
    flat = x.reshape(b, -1).astype(np.float32)
    rmin = np.minimum(flat.min(1), 0).astype(np.float64)
    rmax = np.maximum(flat.max(1), 0).astype(np.float64)
    flat_range = rmin == rmax
    scale = np.where(flat_range, 1.0, (rmax - rmin) / 255.0)
    from_min, from_max = -128.0 - rmin / scale, 127.0 - rmax / scale
    zpd = np.where(128.0 + np.abs(rmin / scale) < 127.0 + np.abs(rmax / scale),
                   from_min, from_max)
    zp = np.where(flat_range, 0.0, np.clip(_round_away(zpd), -128, 127))
    scale32 = scale.astype(np.float32)
    inv = (np.float32(1.0) / scale32)[:, None]
    q = np.clip(_round_away(zp.astype(np.float32)[:, None] + flat * inv), -128, 127)
    q = np.where(flat_range[:, None], 0.0, q)
    return q.reshape(x.shape), scale32, zp


def _same_pads(size: int, k: int, s: int, d: int):
    ek = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + ek - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, opts, depthwise: bool, wq: Optional[dict], cache: dict):
    """NHWC conv (OHWI / 1HWC weights) through torch's conv2d, channels-last
    (the NHWC array viewed as NCHW, no copy); the torch weight and bias are
    made once per op (`cache`)."""
    sh, sw = opts.get("stride_h", 1), opts.get("stride_w", 1)
    dh, dw = opts.get("dilation_h_factor", 1), opts.get("dilation_w_factor", 1)
    n, h, wd, c = x.shape
    kh, kw = w.shape[1], w.shape[2]
    if opts.get("padding", S.SAME) == S.SAME:
        pt, pb = _same_pads(h, kh, sh, dh)
        pl, pr = _same_pads(wd, kw, sw, dw)
    else:
        pt = pb = pl = pr = 0
    if "w" not in cache:
        wt = np.transpose(w, (3, 0, 1, 2)) if depthwise else np.transpose(w, (0, 3, 1, 2))
        cache["w"] = torch.from_numpy(np.array(wt, np.float32)).contiguous(
            memory_format=torch.channels_last)
        cache["b"] = None if b is None else torch.from_numpy(np.array(b, np.float32))
    groups = c if depthwise else 1
    if wq is not None:
        # hybrid: the input quantized per batch item, the integer product
        # (fp32 sums of integers: exact below 2^24, within 6e-8 above), then
        # input scale x channel scale and the bias
        q, scale, zp = _quantize_rows(x)
        x = (q - zp[:, None, None, None]).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).permute(0, 3, 1, 2)
    if pt or pb or pl or pr:
        xt = torch.nn.functional.pad(xt, (pl, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
    y = torch.nn.functional.conv2d(xt, cache["w"], None if wq is not None else cache["b"],
                                   stride=(sh, sw), dilation=(dh, dw), groups=groups)
    y = y.permute(0, 2, 3, 1).contiguous().numpy()
    if wq is not None:
        y = y * _f32(wq["scale"]) * scale[:, None, None, None]
        if b is not None:
            y = y + _f32(b)
    return _ACT[opts.get("fused_activation_function", 0)](y).astype(np.float32)


def _fully_connected(x, w, b, opts, wq: Optional[dict]):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if wq is not None:
        q, scale, zp = _quantize_rows(x2)
        acc = ((q - zp[:, None]) @ w.astype(np.float64).T).astype(np.float32)
        y = acc * _f32(wq["scale"])[None, :] * scale[:, None]
    else:
        y = (torch.from_numpy(np.ascontiguousarray(x2, np.float32))
             @ torch.from_numpy(np.ascontiguousarray(w, np.float32)).T).numpy()
    if b is not None:
        y = y + _f32(b)
    y = _ACT[opts.get("fused_activation_function", 0)](y).astype(np.float32)
    return y.reshape(lead + (w.shape[0],)) if opts.get("keep_num_dims") else y


def _strided_slice(x, begin, end, strides, opts):
    """STRIDED_SLICE with shrink_axis_mask, the only mask the emitter sets."""
    if any(opts.get(m) for m in ("begin_mask", "end_mask", "ellipsis_mask",
                                 "new_axis_mask", "offset")):
        raise NotImplementedError(f"tflite run: STRIDED_SLICE with {opts}")
    idx = []
    for i in range(x.ndim):
        b, e, s = int(begin[i]), int(end[i]), int(strides[i])
        if opts.get("shrink_axis_mask", 0) >> i & 1:
            idx.append(b if b >= 0 else b + x.shape[i])      # the axis goes
        else:
            idx.append(slice(b, e, s))
    return x[tuple(idx)]


def _topk(x, k: int):
    """Descending, the lower index first on ties (a stable sort)."""
    order = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(x, order, -1), order.astype(np.int32)


def _gather(params, indices, axis: int, batch_dims: int):
    axis %= params.ndim
    if batch_dims == 0:
        return np.take(params, indices.astype(np.int64), axis=axis)
    lead = params.shape[:batch_dims]
    p = params.reshape((-1,) + params.shape[batch_dims:])
    ind = indices.reshape((-1,) + indices.shape[batch_dims:])
    out = np.stack([np.take(p[i], ind[i].astype(np.int64), axis=axis - batch_dims)
                    for i in range(p.shape[0])])
    return out.reshape(lead + out.shape[1:])


def _resize_nearest(x, size, opts):
    """Source pixel floor(dst * in / out), as the emitter writes it (both
    flags false)."""
    if opts.get("align_corners") or opts.get("half_pixel_centers"):
        raise NotImplementedError(f"tflite run: RESIZE_NEAREST_NEIGHBOR with {opts}")
    n, h, w, c = x.shape

    def src(o, i):
        s = np.floor(np.arange(o, dtype=np.float32) * np.float32(i / o))
        return np.minimum(s, i - 1).astype(np.int64)

    return x[:, src(int(size[0]), h)][:, :, src(int(size[1]), w)]


class TFLiteModel:
    """A parsed `.tflite` file; call it with the inputs of subgraph 0 (or
    `run_signature(**named)`) to get numpy outputs."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            blob = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                blob = f.read()
        self.model = S.parse_model(blob)
        self.codes = [S.op_name(c) for c in self.model["operator_codes"]]
        self.subgraphs = self.model["subgraphs"]
        self.consts: List[Dict[int, np.ndarray]] = []
        for sg in self.subgraphs:
            consts = {}
            for i, t in enumerate(sg["tensors"]):
                arr = S.tensor_array(self.model, t)
                if arr is not None:
                    consts[i] = arr
            self.consts.append(consts)
        self._cache: Dict[int, dict] = {}
        sigs = self.model.get("signature_defs") or []
        self.signature = sigs[0] if sigs else None
        main = self.subgraphs[0]
        if self.signature:
            self.input_names = [m["name"] for m in self.signature["inputs"]]
            self.output_names = [m["name"] for m in self.signature["outputs"]]
        else:
            self.input_names = [main["tensors"][i]["name"] for i in main["inputs"]]
            self.output_names = [main["tensors"][i]["name"] for i in main["outputs"]]

    def summary(self) -> dict:
        ops: Dict[str, int] = {}
        for sg in self.subgraphs:
            for op in sg["operators"]:
                name = self.codes[op["opcode_index"]]
                ops[name] = ops.get(name, 0) + 1
        return {"subgraphs": len(self.subgraphs), "ops": ops,
                "tensors": sum(len(sg["tensors"]) for sg in self.subgraphs)}

    def __call__(self, *inputs) -> List[np.ndarray]:
        return self.run_subgraph(0, list(inputs))

    def run_signature(self, **named) -> Dict[str, np.ndarray]:
        """Run by signature names; returns {output name: array}."""
        if not self.signature:
            raise ValueError("the file has no signature")
        main = self.subgraphs[0]
        pos = {t: i for i, t in enumerate(main["inputs"])}
        args: List[Optional[np.ndarray]] = [None] * len(main["inputs"])
        for m in self.signature["inputs"]:
            args[pos[m["tensor_index"]]] = named[m["name"]]
        outs = self.run_subgraph(0, args)
        opos = {t: i for i, t in enumerate(main["outputs"])}
        return {m["name"]: outs[opos[m["tensor_index"]]] for m in self.signature["outputs"]}

    def run_subgraph(self, index: int, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        sg = self.subgraphs[index]
        tensors = sg["tensors"]
        env: Dict[int, np.ndarray] = dict(self.consts[index])
        for ti, x in zip(sg["inputs"], inputs):
            want = np.dtype(S.TYPE_TO_NP[tensors[ti]["type"]])
            x = np.asarray(x)
            if x.dtype != want:
                raise ValueError(f"input {tensors[ti]['name']!r}: {x.dtype}, the file "
                                 f"takes {want}")
            if tuple(x.shape) != tuple(tensors[ti]["shape"]):
                raise ValueError(f"input {tensors[ti]['name']!r}: shape {x.shape}, the "
                                 f"file takes {tuple(tensors[ti]['shape'])}")
            env[ti] = x
        for op in sg["operators"]:
            name = self.codes[op["opcode_index"]]
            ins = [env[i] if i >= 0 else None for i in op["inputs"]]
            opts = op.get("builtin_options") or {}
            outs = self._op(name, ins, opts, op, tensors)
            for ti, v in zip(op["outputs"], outs):
                env[ti] = v
        return [env[i] for i in sg["outputs"]]

    def _op(self, name: str, ins, opts: dict, op: dict, tensors) -> list:
        x = ins[0] if ins else None
        out_t = [tensors[i] for i in op["outputs"]]
        out_dt = np.dtype(S.TYPE_TO_NP[out_t[0]["type"]]) if out_t else None
        if name in _BINARY:
            y = _BINARY[name](x, ins[1])
            if out_dt.kind == "f":
                y = _ACT[opts.get("fused_activation_function", 0)](y)
            return [np.asarray(y).astype(out_dt)]
        if name in _UNARY:
            with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
                return [np.asarray(_UNARY[name](x)).astype(out_dt)]
        if name == "GELU":
            return [_gelu(x, bool(opts.get("approximate")))]
        if name in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
            wt = tensors[op["inputs"][1]]
            w = ins[1]
            wq = wt.get("quantization") if w.dtype == np.int8 else None
            if w.dtype == np.int8 and not wq:
                raise NotImplementedError(f"tflite run: {name} with an int8 weight and "
                                          "no scale")
            if wq is None and w.dtype != np.float32:
                w = w.astype(np.float32)
            b = ins[2] if len(ins) > 2 else None
            if name == "FULLY_CONNECTED":
                return [_fully_connected(x, w, b, opts, wq)]
            return [_conv(x, w, b, opts, name == "DEPTHWISE_CONV_2D", wq,
                          self._cache.setdefault(id(op), {}))]
        if name == "DEQUANTIZE":
            if x.dtype != np.float16:
                raise NotImplementedError(f"tflite run: DEQUANTIZE of {x.dtype}")
            return [x.astype(np.float32)]
        if name == "CAST":
            return [x.astype(out_dt)]
        if name == "RESHAPE":
            return [x.reshape(out_t[0]["shape"] if len(ins) < 2 or ins[1] is None
                              else [int(d) for d in np.asarray(ins[1]).reshape(-1)])]
        if name == "TRANSPOSE":
            return [np.ascontiguousarray(np.transpose(x, [int(p) for p in ins[1]]))]
        if name == "CONCATENATION":
            y = np.concatenate(ins, axis=opts.get("axis", 0))
            return [_ACT[opts.get("fused_activation_function", 0)](y).astype(out_dt)]
        if name in ("PAD", "PADV2"):
            fill = ins[2].reshape(()) if len(ins) > 2 and ins[2] is not None else 0
            return [np.pad(x, [[int(a), int(b)] for a, b in ins[1]], constant_values=fill)]
        if name == "STRIDED_SLICE":
            return [np.ascontiguousarray(_strided_slice(x, ins[1], ins[2], ins[3], opts))]
        if name == "SLICE":
            sl = tuple(slice(int(b), None if int(s) == -1 else int(b) + int(s))
                       for b, s in zip(ins[1], ins[2]))
            return [np.ascontiguousarray(x[sl])]
        if name in ("SELECT", "SELECT_V2"):
            return [np.where(x, ins[1], ins[2]).astype(out_dt)]
        if name in ("MEAN", "SUM", "REDUCE_MAX", "REDUCE_ANY"):
            axes = tuple(int(a) % x.ndim for a in np.asarray(ins[1]).reshape(-1))
            fn = {"MEAN": np.mean, "SUM": np.sum, "REDUCE_MAX": np.max,
                  "REDUCE_ANY": np.any}[name]
            y = fn(x, axis=axes, keepdims=bool(opts.get("keep_dims")))
            return [np.asarray(y).astype(out_dt)]
        if name == "ARG_MAX":
            return [np.argmax(x, axis=int(np.asarray(ins[1]).reshape(-1)[0])).astype(out_dt)]
        if name == "TOPK_V2":
            return list(_topk(x, int(np.asarray(ins[1]).reshape(-1)[0])))
        if name == "GATHER":
            return [_gather(x, ins[1], opts.get("axis", 0), opts.get("batch_dims", 0))]
        if name == "BROADCAST_TO":
            return [np.ascontiguousarray(np.broadcast_to(x, [int(d) for d in ins[1]]))]
        if name == "RESIZE_NEAREST_NEIGHBOR":
            return [_resize_nearest(x, ins[1], opts)]
        if name == "BATCH_MATMUL":
            a = np.swapaxes(x, -1, -2) if opts.get("adj_x") else x
            b = np.swapaxes(ins[1], -1, -2) if opts.get("adj_y") else ins[1]
            return [np.matmul(_f32(a), _f32(b)).astype(out_dt)]
        if name == "WHILE":
            return self._while(ins, opts)
        raise NotImplementedError(f"tflite run: no kernel for {name} (the runner covers "
                                  "the builtins the port's emitter writes)")

    def _while(self, ins, opts) -> list:
        cond, body = opts["cond_subgraph_index"], opts["body_subgraph_index"]
        state = list(ins)
        while bool(np.asarray(self.run_subgraph(cond, state)[0]).reshape(-1)[0]):
            state = self.run_subgraph(body, state)
        return state
