"""First-party `torch.export` -> ONNX writer for the deploy graphs.

Counterpart of `yololite_tpu/deploy/onnx_emit.py` (which walks a jaxpr):
this module walks the ATen graph of a `torch.export.ExportedProgram` and
writes an opset-17 model through the port's own protobuf codec
(`deploy/onnx_proto.py`), with no `onnx` package. It emits only standard
opset-17 ops that the first-party runner (`deploy/onnx_run.py`) executes, so
that runner and the JAX package's run the files (onnxruntime should too; it
is not installed where the port is tested):

  - eval BatchNorm is folded into the Conv before it when it is that conv's
    only user, else written as Mul/Add; `linear` is MatMul + Add;
  - hardswish, hardsigmoid, SiLU, softplus, ReLU6 and GELU (tanh) become
    elementwise chains; LayerNorm becomes ReduceMean/Sub/Mul/Sqrt;
  - `_upsample_nearest_exact2d` at an integer factor becomes a nearest
    `Resize` (at factor 2 nearest-exact, floor and ONNX's half-pixel
    rounding pick the same source pixel), at any other ratio a `Gather` of
    constant source rows and columns;
  - lifted parameters, buffers and constants become initializers, and every
    op whose inputs are all constant is computed here (the anchor grids).

A program exported with a `torch.export.Dim` on the batch axis (export's
`dynamic_batch=True`) gives graph inputs and outputs a symbolic `batch` dim, and
reshape targets that carry the batch are rewritten (0 copies the input's
batch, -1 infers a batch multiple), as JAX's `dyn_reshape_target` does. The
emitter maps the ATen ops that every detection and segmentation config's
"raw" and "decoded" graphs produce; any other raises `NotImplementedError`
naming it.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from yololite_tpu_torch.deploy import onnx_proto as P

_UNARY = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh", "sqrt": "Sqrt"}
_BINARY = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div"}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The ONNX element type of a torch dtype (floats below 32 bits demote to
    float32: the files are host artifacts)."""
    if dtype.is_floating_point:
        return np.dtype(np.float64 if dtype == torch.float64 else np.float32)
    return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.is_floating_point() and t.dtype != torch.float64:
        t = t.float()
    return t.numpy().copy()


class _Emitter:
    def __init__(self):
        self.nodes: List[dict] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.env: Dict[torch.fx.Node, tuple] = {}   # ("t", onnx name) | ("c", array) | ("sym",)
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, arr, hint: str = "const") -> str:
        name = self.fresh(hint)
        self.inits[name] = np.ascontiguousarray(arr)
        return name

    def i64(self, values, hint: str) -> str:
        return self.init(np.asarray(values, np.int64), hint)

    def op(self, op_type: str, inputs: Sequence[str], **attrs) -> str:
        out = self.fresh(op_type.lower())
        self.nodes.append({"op_type": op_type, "input": list(inputs), "output": [out],
                           "name": f"{op_type}_{self._n}",
                           "attribute": [P.attr(k, v) for k, v in attrs.items()]})
        return out

    def const(self, a):
        """The array of a constant argument (a folded node or a Python
        value), else None."""
        if not isinstance(a, torch.fx.Node):
            return np.asarray(a)
        return self.env[a][1] if self.env[a][0] == "c" else None

    def name(self, a, dtype: Optional[np.dtype] = None) -> str:
        """ONNX tensor name of an argument; a constant becomes an
        initializer (a Python scalar takes `dtype`)."""
        if isinstance(a, torch.fx.Node) and self.env[a][0] == "t":
            return self.env[a][1]
        if isinstance(a, torch.fx.Node) and self.env[a][0] != "c":
            raise NotImplementedError("onnx export: a symbolic size used as a tensor")
        arr = self.const(a)
        return self.init(arr if isinstance(a, torch.fx.Node) or dtype is None
                         else arr.astype(dtype))

    def shape(self, node: torch.fx.Node):
        return tuple(node.meta["val"].shape)

    def reshape_target(self, in_shape, out_shape) -> List[int]:
        """A Reshape target: a symbolic (batch) leading dim becomes 0 where
        the input leads with the same batch, else -1 (a batch multiple); the
        batch anywhere else raises."""
        tgt = []
        for i, d in enumerate(out_shape):
            if isinstance(d, int):
                tgt.append(d)
            elif i == 0:
                tgt.append(0 if str(in_shape[0]) == str(d) else -1)
            else:
                raise NotImplementedError(
                    f"dynamic-batch onnx export: the batch in a non-leading dim of "
                    f"a reshape target {tuple(out_shape)}")
        return tgt


def _ints(v) -> List[int]:
    return [int(x) for x in (v if isinstance(v, (list, tuple)) else [v, v])]


def _activation(em: _Emitter, kind: str, x: str, dt: np.dtype) -> str:
    """x -> act(x) as an elementwise chain of runner ops."""
    c = lambda v: em.init(np.asarray(v, dt))                      # noqa: E731
    if kind == "silu":
        return em.op("Mul", [x, em.op("Sigmoid", [x])])
    if kind in ("hardswish", "hardsigmoid"):
        hs = em.op("Div", [em.op("Min", [em.op("Max", [em.op("Add", [x, c(3.0)]),
                                                       c(0.0)]), c(6.0)]), c(6.0)])
        return em.op("Mul", [x, hs]) if kind == "hardswish" else hs
    # GELU, tanh approximation (the zoo's: jax.nn.gelu's default)
    x3 = em.op("Mul", [em.op("Mul", [x, x]), x])
    inner = em.op("Mul", [em.op("Add", [x, em.op("Mul", [x3, c(0.044715)])]),
                          c(math.sqrt(2.0 / math.pi))])
    half = em.op("Mul", [x, c(0.5)])
    return em.op("Mul", [half, em.op("Add", [em.op("Tanh", [inner]), c(1.0)])])


def _bn_params(em: _Emitter, node: torch.fx.Node):
    """(gamma, beta, mean, var, eps) of an eval `batch_norm` node whose
    parameters are constants, else None."""
    if getattr(node.target, "_opname", None) != "batch_norm":
        return None
    _, w, b, mean, var, training, _, eps = node.args[:8]
    params = [em.const(a) if a is not None else None for a in (w, b, mean, var)]
    if training or any(p is None for p in params):
        return None
    return tuple(params) + (float(eps),)


def _emit(em: _Emitter, node: torch.fx.Node, folded: set) -> None:
    tgt = node.target
    name = getattr(tgt, "_opname", None)
    if name is None:
        raise NotImplementedError(f"onnx export: unsupported call {tgt}")
    if name == "_assert_tensor_metadata" or node in folded:   # folded: a BatchNorm
        return                                                # in its conv
    if name == "sym_size":                # the batch; shapes come from meta
        em.env[node] = ("sym",)
        return
    flat = [a for a in torch.utils._pytree.tree_leaves((node.args, node.kwargs))
            if isinstance(a, torch.fx.Node)]
    if all(em.env[a][0] == "c" for a in flat):
        # constant folding: compute the op here on the CPU (the anchor grids)
        args, kw = torch.utils._pytree.tree_map(
            lambda a: torch.from_numpy(em.env[a][1]) if isinstance(a, torch.fx.Node) else a,
            (node.args, dict(node.kwargs)))
        if "device" in kw:
            kw["device"] = torch.device("cpu")
        em.env[node] = ("c", _to_np(tgt(*args, **kw)))
        return
    args = node.args
    dt = _np_dtype(node.meta["val"].dtype)

    def out(onnx_name: str):
        em.env[node] = ("t", onnx_name)

    def arg(i: int, default=None):
        if i < len(args):
            return args[i]
        return node.kwargs.get(tgt._schema.arguments[i].name, default)

    x = args[0]
    if name in _UNARY:
        out(em.op(_UNARY[name], [em.name(x)]))
    elif name in _BINARY:
        unmapped = arg(2, 1) != 1 if name in ("add", "sub") else \
            node.kwargs.get("rounding_mode") is not None      # alpha, floor division
        if unmapped:
            raise NotImplementedError(f"onnx export: aten.{name} with {node.kwargs}")
        out(em.op(_BINARY[name], [em.name(x, dt), em.name(args[1], dt)]))
    elif name in ("silu", "hardswish", "hardsigmoid"):
        out(_activation(em, name, em.name(x), dt))
    elif name == "gelu":
        if node.kwargs.get("approximate", arg(1, "none")) != "tanh":
            raise NotImplementedError("onnx export: GELU without the tanh approximation")
        out(_activation(em, "gelu", em.name(x), dt))
    elif name == "softplus":
        if arg(1, 1) != 1:
            raise NotImplementedError("onnx export: softplus with beta != 1")
        xn = em.name(x)
        soft = em.op("Log", [em.op("Add", [em.op("Exp", [xn]), em.init(np.asarray(1.0, dt))])])
        th = em.init(np.asarray(float(arg(2, 20)), dt))
        out(em.op("Where", [em.op("Greater", [xn, th]), xn, soft]))
    elif name in ("clamp", "relu6", "hardtanh"):
        lo, hi = (0.0, 6.0) if name == "relu6" else (arg(1), arg(2))
        cur = em.name(x)
        if lo is not None:
            cur = em.op("Max", [cur, em.name(lo, dt)])
        if hi is not None:
            cur = em.op("Min", [cur, em.name(hi, dt)])
        out(cur)
    elif name == "square":
        xn = em.name(x)
        out(em.op("Mul", [xn, xn]))
    elif name in ("to", "_to_copy"):
        out(em.op("Cast", [em.name(x)], to=int(P.DTYPE_TO_ONNX[dt])))
    elif name == "conv2d":
        _emit_conv(em, node, folded)
    elif name == "batch_norm":
        p = _bn_params(em, node)
        if p is None:
            raise NotImplementedError("onnx export: aten.batch_norm in training mode")
        gamma, beta, mean, var, eps = p
        scale = (gamma / np.sqrt(var.astype(np.float64) + eps)).astype(dt)
        bshape = (-1,) + (1,) * (len(em.shape(x)) - 2)
        out(em.op("Add", [em.op("Mul", [em.name(x), em.init(scale.reshape(bshape))]),
                          em.init((beta - mean * scale).astype(dt).reshape(bshape))]))
    elif name == "linear":
        w = em.const(args[1])
        if w is None:
            raise NotImplementedError("onnx export: linear with a traced weight")
        y = em.op("MatMul", [em.name(x), em.init(np.ascontiguousarray(w.T), "weight")])
        out(em.op("Add", [y, em.name(arg(2))]) if arg(2) is not None else y)
    elif name in ("mean", "sum"):
        nd = len(em.shape(x))
        axes = [d % nd for d in _ints(arg(1))]
        keep = int(bool(arg(2, False)))
        if name == "sum":
            out(em.op("ReduceSum", [em.name(x), em.i64(axes, "axes")], keepdims=keep))
        else:                             # axes stay an attribute through opset 17
            out(em.op("ReduceMean", [em.name(x)], axes=axes, keepdims=keep))
    elif name == "layer_norm":
        shape, w, b, eps = arg(1), arg(2), arg(3), arg(4, 1e-5)
        nd = len(em.shape(x))
        axes = list(range(nd - len(shape), nd))
        xn = em.name(x)
        d = em.op("Sub", [xn, em.op("ReduceMean", [xn], axes=axes, keepdims=1)])
        var = em.op("ReduceMean", [em.op("Mul", [d, d])], axes=axes, keepdims=1)
        y = em.op("Div", [d, em.op("Sqrt", [em.op("Add", [var, em.init(
            np.asarray(eps, dt))])])])
        if w is not None:
            y = em.op("Mul", [y, em.name(w)])
        out(em.op("Add", [y, em.name(b)]) if b is not None else y)
    elif name in ("reshape", "unsqueeze"):
        target = em.reshape_target(em.shape(x), em.shape(node))
        out(em.op("Reshape", [em.name(x), em.i64(target, "shape")]))
    elif name == "permute":
        out(em.op("Transpose", [em.name(x)], perm=_ints(args[1])))
    elif name == "cat":
        nd = len(em.shape(x[0]))
        out(em.op("Concat", [em.name(t) for t in x], axis=int(arg(1, 0)) % nd))
    elif name == "slice":
        shape = em.shape(x)
        dim = int(arg(1, 0)) % len(shape)
        start, end, step = arg(2), arg(3), int(arg(4, 1))
        if not isinstance(shape[dim], int):
            raise NotImplementedError("dynamic-batch onnx export: slicing the batch")
        start = 0 if start is None else int(start)
        end = shape[dim] if end is None else min(int(end), shape[dim])
        out(em.op("Slice", [em.name(x), em.i64([start], "starts"), em.i64([end], "ends"),
                            em.i64([dim], "axes"), em.i64([step], "steps")]))
    elif name == "select":
        dim = int(args[1]) % len(em.shape(x))
        index = int(args[2]) % em.shape(x)[dim]
        out(em.op("Gather", [em.name(x), em.init(np.asarray(index, np.int64))], axis=dim))
    elif name == "_upsample_nearest_exact2d":
        in_hw, out_hw = em.shape(x)[2:], em.shape(node)[2:]
        if not any(o % i for i, o in zip(in_hw, out_hw)):
            scales = np.asarray([1.0, 1.0] + [o / i for i, o in zip(in_hw, out_hw)],
                                np.float32)
            out(em.op("Resize", [em.name(x), "", em.init(scales, "scales")]))
            return
        # another ratio (ConvNeXtV2's 21 -> 41 -> 81 maps): the source rows and
        # columns as constant indices, floor((i + 0.5) * in / out)
        y = em.name(x)
        for axis, i, o in ((2, in_hw[0], out_hw[0]), (3, in_hw[1], out_hw[1])):
            src = np.minimum(np.floor((np.arange(o) + 0.5) * (i / o)), i - 1)
            y = em.op("Gather", [y, em.init(src.astype(np.int64), "indices")], axis=axis)
        out(y)
    else:
        raise NotImplementedError(
            f"onnx export: no ONNX mapping for aten.{name} ({tgt}); the emitter "
            f"covers the deploy graphs' op set (export fmt='nms' is not ONNX)")


def _emit_conv(em: _Emitter, node: torch.fx.Node, folded: set) -> None:
    """conv2d -> Conv, with the eval BatchNorm that is its only user folded
    into its weight and bias."""
    a = list(node.args) + [None, 1, 0, 1, 1][len(node.args) - 2:]
    x, w, b, stride, pad, dil, groups = a[:7]
    if isinstance(pad, str):
        raise NotImplementedError(f"onnx export: conv padding {pad!r}")
    users = list(node.users)
    bn = _bn_params(em, users[0]) if len(users) == 1 else None
    wc, bc = em.const(w), None if b is None else em.const(b)
    if bn is not None and wc is not None and (b is None or bc is not None):
        gamma, beta, mean, var, eps = bn
        scale = gamma.astype(np.float64) / np.sqrt(var.astype(np.float64) + eps)
        b0 = np.zeros(wc.shape[0]) if bc is None else bc.astype(np.float64)
        inputs = [em.init((wc * scale[:, None, None, None]).astype(wc.dtype), "weight"),
                  em.init(((b0 - mean) * scale + beta).astype(wc.dtype), "bias")]
        folded.add(users[0])
    else:
        bn = None
        inputs = [em.name(w)] + ([] if b is None else [em.name(b)])
    p = _ints(pad)
    y = em.op("Conv", [em.name(x)] + inputs, strides=_ints(stride), pads=p + p,
              dilations=_ints(dil), group=int(groups))
    em.env[node] = ("t", y)
    if bn is not None:
        em.env[users[0]] = ("t", y)


def export_program_to_onnx(ep, out_path: str, *, input_names: Sequence[str],
                           output_names: Sequence[str], model_name: str = "yololite",
                           doc: str = "", opset: int = 17,
                           batch_dim_name: str = "batch") -> str:
    """Write the graph of `ep` (a `torch.export.ExportedProgram`) as an ONNX
    file. Parameters, buffers and constants become initializers; the user
    inputs become graph inputs named `input_names`, the flattened outputs
    graph outputs named `output_names`; a symbolic leading dim (a program
    exported with a `torch.export.Dim` on the batch) is named
    `batch_dim_name`. Returns `out_path`."""
    sig = ep.graph_signature
    values = dict(ep.state_dict)
    values.update(ep.constants)
    em = _Emitter()
    user_inputs = [s.arg.name for s in sig.input_specs
                   if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    lifted = {s.arg.name: s.target for s in sig.input_specs
              if s.kind != torch.export.graph_signature.InputKind.USER_INPUT}
    if len(user_inputs) != len(input_names):
        raise ValueError(f"{len(input_names)} names for {len(user_inputs)} graph inputs")

    def io_shape(shape):
        dims = [d if isinstance(d, int) else batch_dim_name for d in shape]
        if any(isinstance(d, str) for d in dims[1:]):
            raise NotImplementedError(f"onnx export: a symbolic non-batch dim in {shape}")
        return dims

    graph_inputs, graph_outputs, folded = [], [], set()
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            if node.name in lifted:
                em.env[node] = ("c", _to_np(values[lifted[node.name]]))
            else:
                iname = input_names[user_inputs.index(node.name)]
                em.env[node] = ("t", iname)
                val = node.meta["val"]
                graph_inputs.append(P.value_info(iname, _np_dtype(val.dtype),
                                                 io_shape(val.shape)))
        elif node.op == "call_function":
            _emit(em, node, folded)
        elif node.op == "output":
            outs = torch.utils._pytree.tree_leaves(node.args[0])
            if len(outs) != len(output_names):
                raise ValueError(f"{len(output_names)} names for {len(outs)} outputs")
            for oname, o in zip(output_names, outs):
                em.nodes.append({"op_type": "Identity", "input": [em.name(o)],
                                 "output": [oname], "name": f"out_{oname}",
                                 "attribute": []})
                val = o.meta["val"]
                graph_outputs.append(P.value_info(oname, _np_dtype(val.dtype),
                                                  io_shape(val.shape)))
    model = {
        "ir_version": 8,
        "producer_name": "yololite_tpu_torch",
        "producer_version": torch.__version__,
        "graph": {"name": model_name, "node": em.nodes,
                  "initializer": [P.tensor_proto(n, a) for n, a in em.inits.items()],
                  "input": graph_inputs, "output": graph_outputs},
        "opset_import": [{"domain": "", "version": opset}],
        "doc_string": doc,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(P.serialize_model(model))
    return out_path
