"""First-party ONNX executor (numpy, torch-accelerated convs when available).

The port's own copy of `yololite_tpu/deploy/onnx_run.py`: it runs the files
that the port's `deploy/onnx_emit.py` writes, and the JAX package's, on the
host.

The environment has no `onnxruntime`; reference users run exported models with
it (reference tools/infer_onnx.py:143-233). This executor makes the ONNX
artifacts emitted by `deploy/onnx_emit.py` runnable on ANY host with numpy —
and serves as the verification oracle for the emitter (parity tests compare it
against the jitted jax graph). When onnxruntime IS installed on the user's
machine, `run_model` prefers it automatically.

Implements the op subset the emitter produces (plus a few ops common in
torch-exported files). Conv/MaxPool/AveragePool ride torch's CPU kernels when
torch is importable; a pure-numpy im2col fallback keeps the runner
dependency-free.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from yololite_tpu_torch.deploy import onnx_proto as P

try:
    import torch
    _HAS_TORCH = True
except Exception:  # pragma: no cover
    _HAS_TORCH = False


def _erf(x: np.ndarray) -> np.ndarray:
    if _HAS_TORCH:
        return torch.erf(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    v = np.vectorize(math.erf)
    return v(x).astype(x.dtype)


def _conv(x, w, b, strides, pads, dilations, group):
    # x NCHW, w OIHW, pads = [top, left, bottom, right]
    if _HAS_TORCH:
        tx = torch.from_numpy(np.ascontiguousarray(x.astype(np.float32)))
        tw = torch.from_numpy(np.ascontiguousarray(w.astype(np.float32)))
        tb = (torch.from_numpy(np.ascontiguousarray(b.astype(np.float32)))
              if b is not None else None)
        if pads[0] == pads[2] and pads[1] == pads[3]:
            y = torch.nn.functional.conv2d(
                tx, tw, tb, stride=tuple(strides),
                padding=(pads[0], pads[1]), dilation=tuple(dilations),
                groups=group)
        else:
            tx = torch.nn.functional.pad(
                tx, (pads[1], pads[3], pads[0], pads[2]))
            y = torch.nn.functional.conv2d(
                tx, tw, tb, stride=tuple(strides), dilation=tuple(dilations),
                groups=group)
        return y.numpy().astype(x.dtype)
    return _conv_np(x, w, b, strides, pads, dilations, group)


def _conv_np(x, w, b, strides, pads, dilations, group):
    N, C, H, W = x.shape
    O, I, kh, kw = w.shape  # I = C / group
    x = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])))
    eh = (kh - 1) * dilations[0] + 1
    ew = (kw - 1) * dilations[1] + 1
    Ho = (x.shape[2] - eh) // strides[0] + 1
    Wo = (x.shape[3] - ew) // strides[1] + 1
    og = O // group
    out = np.zeros((N, O, Ho, Wo), np.float32)
    xf = x.astype(np.float32)
    wf = w.astype(np.float32).reshape(group, og, I * kh * kw)
    for g in range(group):
        cols = np.empty((N, I * kh * kw, Ho * Wo), np.float32)
        xg = xf[:, g * I:(g + 1) * I]
        idx = 0
        for ci in range(I):
            for ki in range(kh):
                hi = ki * dilations[0]
                for kj in range(kw):
                    wi = kj * dilations[1]
                    patch = xg[:, ci, hi:hi + Ho * strides[0]:strides[0],
                               wi:wi + Wo * strides[1]:strides[1]]
                    cols[:, idx] = patch.reshape(N, -1)
                    idx += 1
        out[:, g * og:(g + 1) * og] = np.einsum(
            "ok,nkp->nop", wf[g], cols).reshape(N, og, Ho, Wo)
    if b is not None:
        out += b.reshape(1, -1, 1, 1).astype(np.float32)
    return out.astype(x.dtype)


def _pool(x, kind, kernel, strides, pads, count_include_pad=0):
    if _HAS_TORCH:
        tx = torch.from_numpy(np.ascontiguousarray(x.astype(np.float32)))
        if pads[0] == pads[2] and pads[1] == pads[3]:
            if kind == "max":
                y = torch.nn.functional.max_pool2d(
                    tx, kernel, stride=tuple(strides),
                    padding=(pads[0], pads[1]))
            else:
                y = torch.nn.functional.avg_pool2d(
                    tx, kernel, stride=tuple(strides),
                    padding=(pads[0], pads[1]),
                    count_include_pad=bool(count_include_pad))
            return y.numpy().astype(x.dtype)
    # numpy fallback via strided windows
    fill = -np.inf if kind == "max" else 0.0
    xp = np.pad(x.astype(np.float32),
                ((0, 0), (0, 0), (pads[0], pads[2]), (pads[1], pads[3])),
                constant_values=fill)
    N, C, H, W = xp.shape
    kh, kw = kernel
    Ho = (H - kh) // strides[0] + 1
    Wo = (W - kw) // strides[1] + 1
    out = np.full((N, C, Ho, Wo), fill, np.float32)
    acc = np.zeros((N, C, Ho, Wo), np.float32)
    for i in range(kh):
        for j in range(kw):
            win = xp[:, :, i:i + Ho * strides[0]:strides[0],
                     j:j + Wo * strides[1]:strides[1]]
            if kind == "max":
                out = np.maximum(out, win)
            else:
                acc += win
    if kind == "max":
        return out.astype(x.dtype)
    return (acc / (kh * kw)).astype(x.dtype)


class OnnxGraph:
    """Parsed + executable ONNX model."""

    def __init__(self, data: bytes):
        self.model = P.parse_model(data)
        g = self.model["graph"]
        self.nodes = g.get("node", [])
        self.inits = {t["name"]: P.tensor_to_array(t)
                      for t in g.get("initializer", [])}
        self.input_names = [v["name"] for v in g.get("input", [])
                            if v["name"] not in self.inits]
        self.output_names = [v["name"] for v in g.get("output", [])]

    # -- execution ------------------------------------------------------------
    def __call__(self, *args: np.ndarray) -> List[np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.inits)
        assert len(args) == len(self.input_names), (
            f"model wants {self.input_names}, got {len(args)} arrays")
        for name, a in zip(self.input_names, args):
            env[name] = np.asarray(a)
        for node in self.nodes:
            self._exec(node, env)
        return [env[n] for n in self.output_names]

    def _exec(self, node: dict, env: Dict[str, np.ndarray]) -> None:
        op = node["op_type"]
        ins = [env[n] if n else None for n in node.get("input", [])]
        outs = node.get("output", [])
        at = {a["name"]: P.attr_value(a) for a in node.get("attribute", [])}
        x = ins[0] if ins else None

        def out(v):
            env[outs[0]] = v

        if op == "Identity":
            out(x)
        elif op == "Cast":
            out(x.astype(P.ONNX_TO_DTYPE[at["to"]]))
        elif op in ("Add", "Sub", "Mul", "Div", "Pow"):
            f = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
                 "Div": None, "Pow": np.power}[op]
            if op == "Div":
                if np.issubdtype(x.dtype, np.integer):
                    out((x / ins[1]).astype(x.dtype))
                else:
                    out(np.divide(x, ins[1]))
            else:
                out(f(x, ins[1]).astype(np.result_type(x, ins[1])))
        elif op == "Max":
            r = ins[0]
            for o in ins[1:]:
                r = np.maximum(r, o)
            out(r)
        elif op == "Min":
            r = ins[0]
            for o in ins[1:]:
                r = np.minimum(r, o)
            out(r)
        elif op == "Mod":
            out(np.fmod(x, ins[1]) if at.get("fmod") else np.mod(x, ins[1]))
        elif op in ("And", "Or", "Xor", "Not"):
            f = {"And": np.logical_and, "Or": np.logical_or,
                 "Xor": np.logical_xor}.get(op)
            out(np.logical_not(x) if op == "Not" else f(x, ins[1]))
        elif op in ("Equal", "Less", "Greater", "LessOrEqual",
                    "GreaterOrEqual"):
            f = {"Equal": np.equal, "Less": np.less, "Greater": np.greater,
                 "LessOrEqual": np.less_equal,
                 "GreaterOrEqual": np.greater_equal}[op]
            out(f(x, ins[1]))
        elif op == "Where":
            out(np.where(x, ins[1], ins[2]))
        elif op == "Neg":
            out(np.negative(x))
        elif op == "Abs":
            out(np.abs(x))
        elif op == "Exp":
            out(np.exp(x))
        elif op == "Log":
            out(np.log(x))
        elif op == "Sqrt":
            out(np.sqrt(x))
        elif op == "Reciprocal":
            out((1.0 / x).astype(x.dtype))
        elif op == "Tanh":
            out(np.tanh(x))
        elif op == "Erf":
            out(_erf(x))
        elif op == "Sigmoid":
            out((1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(x.dtype))
        elif op == "Floor":
            out(np.floor(x))
        elif op == "Ceil":
            out(np.ceil(x))
        elif op == "Round":
            out(np.round(x))  # round-half-even, matches ONNX spec
        elif op == "Sign":
            out(np.sign(x))
        elif op == "Relu":
            out(np.maximum(x, 0))
        elif op == "Softmax":
            ax = at.get("axis", -1)
            e = np.exp(x - x.max(axis=ax, keepdims=True))
            out(e / e.sum(axis=ax, keepdims=True))
        elif op == "Reshape":
            # full ONNX semantics: 0 copies the input dim (allowzero=0
            # default), -1 infers — both appear in dynamic-batch exports
            tgt = [int(d) for d in ins[1]]
            tgt = [x.shape[i] if d == 0 else d for i, d in enumerate(tgt)]
            out(x.reshape(tgt))
        elif op == "Transpose":
            out(np.transpose(x, at.get("perm")))
        elif op == "Expand":
            # ONNX Expand = mutual broadcast (dims of 1 in the given shape
            # keep the input's extent), not one-sided broadcast_to
            shape = np.broadcast_shapes(x.shape, tuple(int(d) for d in ins[1]))
            out(np.broadcast_to(x, shape).copy())
        elif op == "Concat":
            out(np.concatenate(ins, axis=at["axis"]))
        elif op == "Slice":
            starts = [int(v) for v in ins[1]]
            ends = [int(v) for v in ins[2]]
            axes = ([int(v) for v in ins[3]] if len(ins) > 3 and
                    ins[3] is not None else list(range(len(starts))))
            steps = ([int(v) for v in ins[4]] if len(ins) > 4 and
                     ins[4] is not None else [1] * len(starts))
            sl = [slice(None)] * x.ndim
            for s, e, a, st in zip(starts, ends, axes, steps):
                if st < 0 and e < -x.shape[a]:
                    e = None  # ONNX: INT_MIN-ish end with neg step = "to start"
                sl[a] = slice(s, e, st)
            out(x[tuple(sl)].copy())
        elif op == "Pad":
            pads = [int(v) for v in ins[1]]
            nd = x.ndim
            cfg = [(pads[i], pads[i + nd]) for i in range(nd)]
            cval = (float(np.asarray(ins[2]).reshape(()))
                    if len(ins) > 2 and ins[2] is not None else 0.0)
            out(np.pad(x, cfg, constant_values=cval).astype(x.dtype))
        elif op == "ReduceSum":
            axes = ([int(v) for v in ins[1]] if len(ins) > 1 and
                    ins[1] is not None else at.get("axes"))
            out(x.sum(axis=tuple(axes) if axes else None,
                      keepdims=bool(at.get("keepdims", 1))).astype(x.dtype))
        elif op in ("ReduceMax", "ReduceMin", "ReduceMean", "ReduceProd"):
            f = {"ReduceMax": np.max, "ReduceMin": np.min,
                 "ReduceMean": np.mean, "ReduceProd": np.prod}[op]
            axes = at.get("axes")
            out(f(x, axis=tuple(axes) if axes else None,
                  keepdims=bool(at.get("keepdims", 1))).astype(x.dtype))
        elif op in ("ArgMax", "ArgMin"):
            f = np.argmax if op == "ArgMax" else np.argmin
            r = f(x, axis=at.get("axis", 0))
            if at.get("keepdims", 1):
                r = np.expand_dims(r, at.get("axis", 0))
            out(r.astype(np.int64))
        elif op == "Gather":
            out(np.take(x, ins[1].astype(np.int64), axis=at.get("axis", 0)))
        elif op == "Einsum":
            out(np.einsum(at["equation"], *ins))
        elif op == "MatMul":
            out(np.matmul(x, ins[1]))
        elif op == "Gemm":
            a = x.T if at.get("transA") else x
            b = ins[1].T if at.get("transB") else ins[1]
            y = at.get("alpha", 1.0) * (a @ b)
            if len(ins) > 2 and ins[2] is not None:
                y = y + at.get("beta", 1.0) * ins[2]
            out(y.astype(x.dtype))
        elif op == "Conv":
            b = ins[2] if len(ins) > 2 else None
            out(_conv(x, ins[1], b,
                      at.get("strides", [1, 1]), at.get("pads", [0, 0, 0, 0]),
                      at.get("dilations", [1, 1]), at.get("group", 1)))
        elif op == "MaxPool":
            env[outs[0]] = _pool(x, "max", at["kernel_shape"],
                                 at.get("strides", [1, 1]),
                                 at.get("pads", [0, 0, 0, 0]))
        elif op == "AveragePool":
            out(_pool(x, "avg", at["kernel_shape"], at.get("strides", [1, 1]),
                      at.get("pads", [0, 0, 0, 0]),
                      at.get("count_include_pad", 0)))
        elif op == "GlobalAveragePool":
            out(x.mean(axis=(2, 3), keepdims=True).astype(x.dtype))
        elif op == "Constant":
            out(at["value"])
        elif op == "Shape":
            out(np.asarray(x.shape, np.int64))
        elif op == "Resize":
            _resize(env, node, ins, at)
        else:
            raise NotImplementedError(f"onnx_run: unsupported op '{op}'")

    def summary(self) -> Dict[str, Any]:
        ops: Dict[str, int] = {}
        for n in self.nodes:
            ops[n["op_type"]] = ops.get(n["op_type"], 0) + 1
        params = sum(int(np.prod(a.shape)) for a in self.inits.values())
        return {"inputs": self.input_names, "outputs": self.output_names,
                "nodes": len(self.nodes), "ops": ops, "params": params,
                "opset": self.model["opset_import"][0].get("version")}


def _resize(env, node, ins, at):  # nearest only (FPN upsample in torch files)
    x = ins[0]
    sizes = ins[3] if len(ins) > 3 and ins[3] is not None else None
    scales = ins[2] if len(ins) > 2 and ins[2] is not None and len(
        np.atleast_1d(ins[2])) else None
    if sizes is not None:
        tgt = [int(d) for d in sizes]
    else:
        tgt = [int(round(s * d)) for s, d in zip(np.asarray(scales), x.shape)]
    if at.get("mode", "nearest") != "nearest":
        raise NotImplementedError("onnx_run: only nearest Resize")
    idxs = [np.minimum((np.arange(t) * (s / t)).astype(np.int64), s - 1)
            for t, s in zip(tgt, x.shape)]
    r = x
    for ax, ix in enumerate(idxs):
        r = np.take(r, ix, axis=ax)
    env[node["output"][0]] = r


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        return OnnxGraph(f.read())


def run_model(path: str, inputs: Sequence[np.ndarray],
              prefer_ort: bool = True) -> List[np.ndarray]:
    """Run an ONNX file: onnxruntime when installed, first-party otherwise."""
    if prefer_ort:
        try:
            import onnxruntime as ort  # noqa: F401
            sess = ort.InferenceSession(path,
                                        providers=["CPUExecutionProvider"])
            names = [i.name for i in sess.get_inputs()]
            return sess.run(None, dict(zip(names, inputs)))
        except ImportError:
            pass
    return load_onnx(path)(*inputs)
