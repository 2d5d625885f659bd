"""First-party `torch.export` -> TFLite writer for the deploy graphs.

The counterpart of `deploy/onnx_emit.py` for `.tflite` files (JAX's
`export_tflite` goes through jax2tf and TF's converter): this module walks
the ATen graph of a `torch.export.ExportedProgram` and writes a TFLite model
of builtin ops only through the port's own FlatBuffers codec
(`deploy/tflite_schema.py`), with no `tensorflow` or `flatbuffers` package.
`deploy/tflite_run.py` runs the files on a host; `tf.lite.Interpreter` and
JAX's `load_tflite` run them too.

  - Layout. The ATen graph is logical NCHW; TFLite's convs, resize and
    most kernels work in NHWC. Every value carries a permutation from its
    logical axes to its stored (physical) axes, and a conv's output is
    stored NHWC. `permute` only changes the permutation; `cat`, `slice`,
    `select`, reductions, `pad` and `layer_norm` remap their axes; a reshape
    that only inserts or drops unit dims, or that keeps the stored order of
    the others, is a RESHAPE. A TRANSPOSE goes in only where an op needs
    another order. The uint8 NHWC input reaches the stem with none.
  - Convs. Eval BatchNorm is folded into the conv before it, and a ReLU or
    ReLU6 that is its only user into its activation. A conv whose
    symmetric torch padding is not TFLite's SAME (SAME puts the odd pixel
    after: a stride-2 3x3 conv on an even size pads (0, 1), torch (1, 1))
    becomes PAD + a VALID conv. Depthwise convs are DEPTHWISE_CONV_2D with
    1HWC weights, the others CONV_2D with OHWI weights.
  - Activations: RELU, RELU6, LOGISTIC, TANH, HARD_SWISH, GELU; SiLU is
    x * LOGISTIC(x); softplus is max(x, 0) + log(1 + exp(-|x|)).
  - Nearest upsampling at an integer factor is RESIZE_NEAREST_NEIGHBOR
    (floor(dst * in / out), the pixel nearest-exact picks); any other ratio
    a GATHER of constant rows and columns.
  - The "nms" graph: the stable descending sort is TOPK_V2 (ties go to the
    lower index first, as `lax.top_k`), the batched gathers GATHER with
    `batch_dims`, and `yololite::nms_suppress` becomes the IoU matrix in
    JAX's op order (`ops/boxes.box_iou_matrix`), `> iou_th` over the upper
    triangle, then a WHILE loop of the greedy fixpoint
    keep = valid & ~any_j(sup[j, i] & keep[j]) until it no longer changes
    (the exact greedy keep, as JAX's `_greedy_keep`).
  - Constants: lifted parameters and buffers (the folded stem's
    correction map included) are buffers; every op whose inputs are all
    constant is computed here (the anchor grids).

quantize="fp16" stores every float constant of two or more elements as
float16, each followed by a DEQUANTIZE; quantize="dynamic" stores the
weights of CONV_2D, DEPTHWISE_CONV_2D and FULLY_CONNECTED with at least
1024 elements as int8, per output channel, symmetric, zero point 0 (dim 0 of
OHWI, dim 3 of 1HWC), as TF's converter does, so a runtime takes its
hybrid kernels. Any ATen op without a mapping raises `NotImplementedError`
naming it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yololite_tpu_torch.deploy import tflite_schema as S
from yololite_tpu_torch.deploy.onnx_emit import _bn_params, _ints, _to_np

QUANTIZE = (None, "fp16", "dynamic")
DYNAMIC_MIN_ELEMENTS = 1024          # TF's converter leaves smaller weights in fp32
_EPS = 1e-7                          # ops/boxes.EPS

_UNARY = {"relu": "RELU", "relu6": "RELU6", "sigmoid": "LOGISTIC", "tanh": "TANH",
          "hardswish": "HARD_SWISH", "sqrt": "SQRT", "rsqrt": "RSQRT", "exp": "EXP",
          "log": "LOG", "abs": "ABS", "neg": "NEG", "logical_not": "LOGICAL_NOT",
          "bitwise_not": "LOGICAL_NOT"}
_BINARY = {"add": "ADD", "sub": "SUB", "mul": "MUL", "div": "DIV", "maximum": "MAXIMUM",
           "minimum": "MINIMUM", "gt": "GREATER", "ge": "GREATER_EQUAL", "lt": "LESS",
           "le": "LESS_EQUAL", "eq": "EQUAL", "ne": "NOT_EQUAL", "__and__": "LOGICAL_AND",
           "__or__": "LOGICAL_OR"}
_COMPARE = {"gt", "ge", "lt", "le", "eq", "ne"}
_OPTIONS = {"ADD": "AddOptions", "SUB": "SubOptions", "MUL": "MulOptions",
            "DIV": "DivOptions"}
_REDUCE = {"mean": "MEAN", "sum": "SUM", "amax": "REDUCE_MAX"}


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The TFLite element type of a torch dtype: floats are float32 (the
    files are fp32 host artifacts), integer indices int32."""
    if dtype.is_floating_point:
        return np.dtype(np.float32)
    if dtype == torch.bool:
        return np.dtype(np.bool_)
    if dtype == torch.uint8:
        return np.dtype(np.uint8)
    if dtype in (torch.int64, torch.int32, torch.int16, torch.int8):
        return np.dtype(np.int32)
    raise NotImplementedError(f"tflite export: dtype {dtype}")


def _inv(perm: Sequence[int]) -> Tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def _ident(n: int) -> Tuple[int, ...]:
    return tuple(range(n))


class _Value:
    """A tensor of a subgraph: its index, logical shape and dtype, and the
    permutation `perm` with logical = np.transpose(stored, perm)."""

    __slots__ = ("idx", "shape", "dtype", "perm")

    def __init__(self, idx: int, shape, dtype, perm=None):
        self.idx, self.shape, self.dtype = idx, tuple(int(d) for d in shape), np.dtype(dtype)
        self.perm = tuple(perm) if perm is not None else _ident(len(self.shape))

    @property
    def stored_shape(self) -> List[int]:
        inv = _inv(self.perm)
        return [self.shape[inv[j]] for j in range(len(self.shape))]


def _stored_order(shape, perm) -> List[int]:
    """The logical non-unit dims in the order they are stored."""
    dims = [i for i in range(len(shape)) if shape[i] != 1]
    return sorted(dims, key=lambda i: perm[i])


class _Model:
    def __init__(self):
        self.buffers: List[dict] = [{}]            # buffer 0: the empty sentinel
        self.codes: Dict[Tuple[str, int], int] = {}
        self.subgraphs: List["_Subgraph"] = []

    def opcode(self, name: str, version: int) -> int:
        key = (name, version)
        if key not in self.codes:
            self.codes[key] = len(self.codes)
        return self.codes[key]

    def subgraph(self, name: str) -> "_Subgraph":
        sg = _Subgraph(self, name)
        self.subgraphs.append(sg)
        return sg


class _Subgraph:
    def __init__(self, model: _Model, name: str):
        self.model, self.name = model, name
        self.tensors: List[dict] = []
        self.ops: List[dict] = []
        self.inputs: List[int] = []
        self.outputs: List[int] = []
        self._small: Dict[tuple, int] = {}

    def tensor(self, shape, dtype, name: str = "t") -> int:
        self.tensors.append({"shape": [int(d) for d in shape],
                             "type": S.NP_TO_TYPE[np.dtype(dtype)],
                             "name": f"{name}_{len(self.tensors)}"})
        return len(self.tensors) - 1

    def const(self, arr, dtype=None, name: str = "const") -> int:
        """A constant tensor (small ones shared by value)."""
        arr = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        key = (arr.dtype.str, arr.shape, arr.tobytes()) if arr.size <= 16 else None
        if key is not None and key in self._small:
            return self._small[key]
        idx = self.tensor(arr.shape, arr.dtype, name)
        self.tensors[idx]["buffer"] = len(self.model.buffers)
        self.model.buffers.append({"data": arr.tobytes()})
        if key is not None:
            self._small[key] = idx
        return idx

    def op(self, name: str, inputs: Sequence[int], outputs, options: Optional[str] = None,
           version: int = 1, **opts) -> List[int]:
        """Append builtin op `name`; `outputs` are (shape, dtype) pairs or
        tensor indices. Returns the output indices."""
        outs = [o if isinstance(o, int) else self.tensor(o[0], o[1], name.lower())
                for o in outputs]
        op = {"opcode_index": self.model.opcode(name, version),
              "inputs": [int(i) for i in inputs], "outputs": outs}
        options = options or _OPTIONS.get(name)
        if options is not None:
            op["builtin_options_type"] = S.OPTIONS_ID[options]
            op["builtin_options"] = opts
        self.ops.append(op)
        return outs

    def op1(self, name, inputs, shape, dtype, options=None, version=1, **opts) -> int:
        return self.op(name, inputs, [(shape, dtype)], options, version, **opts)[0]


# --------------------------------------------------------------------------- #
# the ATen walk
# --------------------------------------------------------------------------- #

class _Emitter:
    def __init__(self, model: _Model, sg: _Subgraph):
        self.model, self.sg = model, sg
        self.env: Dict[torch.fx.Node, object] = {}   # ("c", array) | _Value | tuple
        self.skip: set = set()

    # ------------------------------------------------------------------ values
    def const(self, a):
        """The array of a constant argument (a folded node or a Python
        value), else None."""
        if not isinstance(a, torch.fx.Node):
            return None if a is None else np.asarray(a)
        v = self.env[a]
        return v[1] if isinstance(v, tuple) and v and v[0] == "c" else None

    def value(self, a) -> _Value:
        v = self.env[a]
        if not isinstance(v, _Value):
            raise NotImplementedError(f"tflite export: {a} is not a tensor")
        return v

    def as_perm(self, v: _Value, perm) -> _Value:
        """`v` stored in the order `perm` gives: a RESHAPE where only unit
        dims move, else a TRANSPOSE."""
        perm = tuple(perm)
        if v.perm == perm:
            return v
        out = _Value(-1, v.shape, v.dtype, perm)
        if _stored_order(v.shape, v.perm) == _stored_order(v.shape, perm):
            out.idx = self.sg.op1("RESHAPE", [v.idx, self.sg.const(out.stored_shape, np.int32)],
                                  out.stored_shape, v.dtype, "ReshapeOptions",
                                  new_shape=out.stored_shape)
        else:
            inv = _inv(perm)
            t = [v.perm[inv[j]] for j in range(len(perm))]
            out.idx = self.sg.op1("TRANSPOSE", [v.idx, self.sg.const(t, np.int32)],
                                  out.stored_shape, v.dtype, "TransposeOptions",
                                  version=1 if len(perm) <= 4 else 4)
        return out

    def tensor(self, a, perm=None, dtype=None) -> _Value:
        """Argument `a` as a tensor stored in the order `perm` (its own
        order when None); a constant becomes a buffer (a Python scalar takes
        `dtype`)."""
        c = self.const(a)
        if c is None:
            v = self.value(a)
            return v if perm is None else self.as_perm(v, perm)
        if dtype is not None and (not isinstance(a, torch.fx.Node) or c.dtype != dtype):
            c = c.astype(dtype)
        perm = _ident(c.ndim) if perm is None else tuple(perm)
        stored = np.transpose(c, _inv(perm)) if c.ndim else c
        idx = self.sg.const(stored)
        return _Value(idx, c.shape, self.model_dtype(c.dtype), perm)

    @staticmethod
    def model_dtype(dt) -> np.dtype:
        dt = np.dtype(dt)
        return np.dtype(np.float32) if dt == np.float64 else \
            np.dtype(np.int32) if dt == np.int64 else dt

    def out(self, node, idx: int, perm=None) -> _Value:
        val = node.meta["val"]
        v = _Value(idx, val.shape, _np_dtype(val.dtype), perm)
        self.env[node] = v
        return v

    def new(self, node, perm=None):
        """(stored shape, dtype) of a node's output stored in `perm`."""
        val = node.meta["val"]
        v = _Value(-1, val.shape, _np_dtype(val.dtype), perm)
        return v.stored_shape, v.dtype

    # --------------------------------------------------------------- op kinds
    def broadcast(self, args, dtypes) -> Tuple[List[int], tuple]:
        """Tensors for an elementwise op over `args`, stored alike: the
        order of the first operand of the highest rank. `dtypes`, one per
        operand (or one for all; None keeps a tensor's own), is what a
        constant is made in and a tensor cast to."""
        if not isinstance(dtypes, (list, tuple)):
            dtypes = [dtypes] * len(args)
        rank = max(len(self.const(a).shape) if self.const(a) is not None
                   else len(self.value(a).shape) for a in args)
        target = next((self.value(a).perm for a in args if self.const(a) is None
                       and len(self.value(a).shape) == rank), _ident(rank))
        idx = []
        for a, dtype in zip(args, dtypes):
            c = self.const(a)
            if c is not None:
                c = np.asarray(c, dtype)
                idx.append(self.tensor_from_array(c.reshape((1,) * (rank - c.ndim) + c.shape),
                                                  target))
                continue
            v = self.value(a)
            if dtype is not None and v.dtype != np.dtype(dtype):    # type promotion
                v = _Value(self.sg.op1("CAST", [v.idx], v.stored_shape, dtype, "CastOptions",
                                       in_data_type=S.NP_TO_TYPE[v.dtype],
                                       out_data_type=S.NP_TO_TYPE[np.dtype(dtype)]),
                           v.shape, dtype, v.perm)
            if len(v.shape) < rank:
                v = self.reshape(self.as_perm(v, _ident(len(v.shape))),
                                 (1,) * (rank - len(v.shape)) + v.shape)
            idx.append(self.as_perm(v, target).idx)
        return idx, target

    def tensor_from_array(self, c: np.ndarray, perm) -> int:
        return self.sg.const(np.transpose(c, _inv(perm)) if c.ndim else c)

    def reshape(self, v: _Value, shape) -> _Value:
        """A logical reshape of `v`, without a TRANSPOSE where the stored
        order allows."""
        shape = tuple(int(d) for d in shape)
        if [d for d in v.shape if d != 1] == [d for d in shape if d != 1]:
            # only unit dims change: keep the stored order of the others
            order = _stored_order(v.shape, v.perm)
            slots = [i for i, d in enumerate(shape) if d != 1]
            new_dims = dict(zip([i for i in range(len(v.shape)) if v.shape[i] != 1], slots))
            stored_pos = {new_dims[o]: slot for o, slot in zip(order, slots)}
            perm = [stored_pos.get(i, i) for i in range(len(shape))]
            out = _Value(-1, shape, v.dtype, perm)
        else:
            if _stored_order(v.shape, v.perm) != sorted(i for i in range(len(v.shape))
                                                      if v.shape[i] != 1):
                v = self.as_perm(v, _ident(len(v.shape)))
            out = _Value(-1, shape, v.dtype)
        if out.stored_shape == list(v.stored_shape):
            out.idx = v.idx
            return out
        out.idx = self.sg.op1("RESHAPE", [v.idx, self.sg.const(out.stored_shape, np.int32)],
                              out.stored_shape, v.dtype, "ReshapeOptions",
                              new_shape=out.stored_shape)
        return out

    def slice_op(self, v: _Value, begin, end, strides, shrink: int, out_shape_stored,
                 out_dtype) -> int:
        return self.sg.op1("STRIDED_SLICE", [v.idx, self.sg.const(begin, np.int32),
                                             self.sg.const(end, np.int32),
                                             self.sg.const(strides, np.int32)],
                           out_shape_stored, out_dtype, "StridedSliceOptions",
                           shrink_axis_mask=shrink)


def _is_relu(node) -> Optional[int]:
    """The fused activation code of a ReLU/ReLU6 node, else None."""
    name = getattr(node.target, "_opname", None)
    if name == "relu":
        return S.ACT_RELU
    if name == "relu6" or (name == "clamp" and len(node.args) >= 3
                           and float(node.args[1]) == 0.0 and float(node.args[2]) == 6.0):
        return S.ACT_RELU6
    return None


def _conv_padding(size: int, k: int, s: int, d: int, p: int):
    """(mode, pad before, pad after) that reproduce torch's symmetric
    padding `p`: "SAME", "VALID", or "PAD" (an explicit PAD, then VALID)."""
    ek = (k - 1) * d + 1
    out = (size + 2 * p - ek) // s + 1
    if p == 0:
        return "VALID", 0, 0
    same_out = -(-size // s)
    total = max((same_out - 1) * s + ek - size, 0)
    if out == same_out and total // 2 == p:
        return "SAME", p, total - p
    return "PAD", p, max(0, (out - 1) * s + ek - size - p)


def _emit_conv(em: _Emitter, node) -> None:
    a = list(node.args) + [None, 1, 0, 1, 1][len(node.args) - 2:]
    x, w, b, stride, pad, dil, groups = a[:7]
    if isinstance(pad, str):
        raise NotImplementedError(f"tflite export: conv padding {pad!r}")
    wc = em.const(w)
    if wc is None or (b is not None and em.const(b) is None):
        raise NotImplementedError("tflite export: conv2d with a traced weight")
    if wc.ndim != 4:
        raise NotImplementedError(f"tflite export: conv of weight rank {wc.ndim}")
    bc = np.zeros(wc.shape[0], np.float64) if b is None else em.const(b).astype(np.float64)
    wc = wc.astype(np.float64)
    last = node
    users = list(node.users)
    bn = _bn_params(em, users[0]) if len(users) == 1 else None
    if bn is not None:                            # fold the BatchNorm
        gamma, beta, mean, var, eps = bn
        scale = gamma.astype(np.float64) / np.sqrt(var.astype(np.float64) + eps)
        wc = wc * scale[:, None, None, None]
        bc = (bc - mean) * scale + beta
        last = users[0]
        em.skip.add(last)
    chain = [node] + ([last] if last is not node else [])
    users = list(last.users)
    act = _is_relu(users[0]) if len(users) == 1 else None
    if act is not None:
        last = users[0]
        chain.append(last)
        em.skip.add(last)
    v = em.tensor(x, (0, 3, 1, 2))
    _, cin, h, wd = v.shape
    cout, cin_g, kh, kw = wc.shape
    groups = int(groups)
    sh, sw = _ints(stride)
    dh, dw = _ints(dil)
    ph, pw = _ints(pad)
    mh = _conv_padding(h, kh, sh, dh, ph)
    mw = _conv_padding(wd, kw, sw, dw, pw)
    if mh[0] == mw[0] and mh[0] in ("SAME", "VALID"):
        padding = S.SAME if mh[0] == "SAME" else S.VALID
    else:
        padding = S.VALID
        if any((mh[1], mh[2], mw[1], mw[2])):
            pads = [[0, 0], [mh[1], mh[2]], [mw[1], mw[2]], [0, 0]]
            shp = [v.stored_shape[0], h + mh[1] + mh[2], wd + mw[1] + mw[2], cin]
            v = _Value(em.sg.op1("PAD", [v.idx, em.sg.const(pads, np.int32)], shp,
                                 np.float32), (shp[0], cin, shp[1], shp[2]), np.float32,
                       (0, 3, 1, 2))
    shape, dtype = em.new(last, (0, 3, 1, 2))
    bias = em.sg.const(bc.astype(np.float32))
    if groups == 1:
        wt = em.sg.const(np.ascontiguousarray(wc.transpose(0, 2, 3, 1)).astype(np.float32))
        idx = em.sg.op1("CONV_2D", [v.idx, wt, bias], shape, dtype, "Conv2DOptions",
                        padding=padding, stride_w=sw, stride_h=sh,
                        fused_activation_function=act or 0,
                        dilation_w_factor=dw, dilation_h_factor=dh)
    elif groups == cin and cin_g == 1:
        wt = em.sg.const(np.ascontiguousarray(wc.transpose(1, 2, 3, 0)).astype(np.float32))
        idx = em.sg.op1("DEPTHWISE_CONV_2D", [v.idx, wt, bias], shape, dtype,
                        "DepthwiseConv2DOptions", padding=padding, stride_w=sw,
                        stride_h=sh, depth_multiplier=cout // cin,
                        fused_activation_function=act or 0,
                        dilation_w_factor=dw, dilation_h_factor=dh,
                        version=2 if max(dh, dw) > 1 else 1)
    else:
        raise NotImplementedError(f"tflite export: grouped conv2d (groups={groups}, "
                                  f"{cin} input channels)")
    val = em.out(last, idx, (0, 3, 1, 2))
    for n in chain:                     # the folded nodes have no other users
        em.env[n] = val


def _gather_base(em: _Emitter, index, lead: Tuple[int, ...]):
    """The [*lead] index tensor that `index` broadcasts over the trailing
    dims (through expand / unsqueeze / casts), else None."""
    node = index
    for _ in range(8):
        if not isinstance(node, torch.fx.Node):
            return None
        if tuple(node.meta["val"].shape) == lead and isinstance(em.env.get(node), _Value):
            return node
        name = getattr(node.target, "_opname", None)
        if name not in ("expand", "unsqueeze", "to", "_to_copy", "alias", "reshape"):
            return None
        node = node.args[0]
    return None


def _emit_nms(em: _Emitter, node) -> None:
    """`yololite::nms_suppress(boxes [B,k,4], valid [B,k], iou_th)` -> the
    exact greedy keep: the IoU matrix as JAX's `box_iou_matrix` orders its
    ops, then a WHILE loop of the fixpoint."""
    boxes, valid, thr = node.args[:3]
    if len(node.args) > 3 and node.args[3]:
        raise NotImplementedError("tflite export: yololite::nms_suppress in DIoU mode")
    sg, f32 = em.sg, np.float32
    vb = em.tensor(boxes, (0, 1, 2))
    vv = em.tensor(valid, (0, 1))
    bsz, k, _ = vb.shape

    def coord(i):
        return em.slice_op(vb, [0, 0, i], [bsz, k, i + 1], [1, 1, 1], 4, [bsz, k], f32)

    def as_shape(t, shape):
        return sg.op1("RESHAPE", [t, sg.const(shape, np.int32)], shape, f32,
                      "ReshapeOptions", new_shape=list(shape))

    x1, y1, x2, y2 = (coord(i) for i in range(4))
    row = lambda t: as_shape(t, [bsz, k, 1])                        # noqa: E731
    col = lambda t: as_shape(t, [bsz, 1, k])                        # noqa: E731
    kk = [bsz, k, k]
    zero = sg.const(np.float32(0.0))

    def side(lo, hi):
        d = sg.op1("SUB", [sg.op1("MINIMUM", [row(hi), col(hi)], kk, f32),
                          sg.op1("MAXIMUM", [row(lo), col(lo)], kk, f32)], kk, f32)
        return sg.op1("MAXIMUM", [d, zero], kk, f32)

    inter = sg.op1("MUL", [side(x1, x2), side(y1, y2)], kk, f32)
    w = sg.op1("MAXIMUM", [sg.op1("SUB", [x2, x1], [bsz, k], f32), zero], [bsz, k], f32)
    h = sg.op1("MAXIMUM", [sg.op1("SUB", [y2, y1], [bsz, k], f32), zero], [bsz, k], f32)
    area = sg.op1("MUL", [w, h], [bsz, k], f32)
    union = sg.op1("ADD", [sg.op1("SUB", [sg.op1("ADD", [row(area), col(area)], kk, f32),
                                          inter], kk, f32),
                           sg.const(np.float32(_EPS))], kk, f32)
    iou = sg.op1("DIV", [inter, union], kk, f32)
    over = sg.op1("GREATER", [iou, sg.const(np.float32(thr))], kk, np.bool_)
    upper = sg.const(np.triu(np.ones((k, k), np.bool_), 1))
    sup = sg.op1("LOGICAL_AND", [over, upper], kk, np.bool_)
    cond, body = _greedy_subgraphs(em.model, bsz, k)
    start = sg.op1("LOGICAL_AND", [vv.idx, vv.idx], [bsz, k], np.bool_)
    outs = sg.op("WHILE", [start, sup, vv.idx],
                 [([bsz, k], np.bool_), (kk, np.bool_), ([bsz, k], np.bool_)],
                 "WhileOptions", cond_subgraph_index=cond, body_subgraph_index=body)
    em.out(node, outs[0], (0, 1))


def _greedy_step(sg: _Subgraph, keep: int, sup: int, valid: int, bsz: int, k: int) -> int:
    """keep' = valid & ~any_j(sup[:, j, i] & keep[:, j])."""
    keep3 = sg.op1("RESHAPE", [keep, sg.const([bsz, k, 1], np.int32)], [bsz, k, 1],
                   np.bool_, "ReshapeOptions", new_shape=[bsz, k, 1])
    hit = sg.op1("LOGICAL_AND", [sup, keep3], [bsz, k, k], np.bool_)
    suppressed = sg.op1("REDUCE_ANY", [hit, sg.const([1], np.int32)], [bsz, k], np.bool_,
                        "ReducerOptions", keep_dims=False)
    return sg.op1("LOGICAL_AND", [valid, sg.op1("LOGICAL_NOT", [suppressed], [bsz, k],
                                                np.bool_)], [bsz, k], np.bool_)


def _greedy_subgraphs(model: _Model, bsz: int, k: int) -> Tuple[int, int]:
    """The WHILE loop's cond (another step would change keep) and body (one
    step); loop variables (keep, sup, valid)."""
    ids = []
    for name in ("greedy_nms_cond", "greedy_nms_body"):
        sg = model.subgraph(name)
        keep = sg.tensor([bsz, k], np.bool_, "keep")
        sup = sg.tensor([bsz, k, k], np.bool_, "sup")
        valid = sg.tensor([bsz, k], np.bool_, "valid")
        sg.inputs = [keep, sup, valid]
        new = _greedy_step(sg, keep, sup, valid, bsz, k)
        if name.endswith("cond"):
            diff = sg.op1("NOT_EQUAL", [new, keep], [bsz, k], np.bool_)
            sg.outputs = [sg.op1("REDUCE_ANY", [diff, sg.const([0, 1], np.int32)], [],
                                 np.bool_, "ReducerOptions", keep_dims=False)]
        else:
            sg.outputs = [new, sup, valid]
        ids.append(len(model.subgraphs) - 1)
    return ids[0], ids[1]


def _emit(em: _Emitter, node) -> None:
    tgt = node.target
    name = getattr(tgt, "_opname", None)
    if name is None:
        if tgt.__name__ == "getitem":
            em.env[node] = em.env[node.args[0]][node.args[1]]
            return
        raise NotImplementedError(f"tflite export: unsupported call {tgt}")
    if name == "_assert_tensor_metadata" or node in em.skip:
        return
    if name == "sym_size":
        raise NotImplementedError("tflite export: a symbolic shape (TFLite files here "
                                  "have a static batch)")
    flat = [a for a in torch.utils._pytree.tree_leaves((node.args, node.kwargs))
            if isinstance(a, torch.fx.Node)]
    if all(em.const(a) is not None for a in flat) and getattr(tgt, "namespace", "") != "yololite":
        args, kw = torch.utils._pytree.tree_map(
            lambda a: torch.from_numpy(np.array(em.const(a))) if isinstance(a, torch.fx.Node)
            else a, (node.args, dict(node.kwargs)))
        if "device" in kw:
            kw["device"] = torch.device("cpu")
        res = tgt(*args, **kw)
        em.env[node] = ("c", _to_np(res)) if isinstance(res, torch.Tensor) else \
            tuple(("c", _to_np(r)) for r in res)
        return
    if getattr(tgt, "namespace", "") == "yololite" and name == "nms_suppress":
        _emit_nms(em, node)
        return
    base = name[:-1]
    if name.endswith("_") and (base in _UNARY or base in _BINARY or base in (
            "clamp", "silu", "hardsigmoid")):
        # an in-place op (a graph exported under no_grad keeps the mask
        # assembly's sigmoid_ and mul_): its functional form, and the
        # mutated input takes the new value
        _emit_op(em, node, base)
        em.env[node.args[0]] = em.env[node]
        return
    _emit_op(em, node, name)


def _arg(node, i, default=None):
    """Argument `i` (an index or a schema name) of an ATen call, positional
    or keyword, else `default`."""
    names = [a.name for a in node.target._schema.arguments]
    i = names.index(i) if isinstance(i, str) else i
    if i < len(node.args):
        return node.args[i]
    return node.kwargs.get(names[i], default)


def _emit_op(em: _Emitter, node, name: str) -> None:
    tgt = node.target
    sg = em.sg
    args = node.args

    def arg(i: int, default=None):
        return _arg(node, i, default)

    x = args[0] if args else None
    if name == "alias":
        em.env[node] = em.env[x]
    elif name in ("to", "_to_copy"):
        v = em.value(x)
        dt = _np_dtype(node.meta["val"].dtype)
        if dt == v.dtype:
            em.env[node] = v
        else:
            shape = v.stored_shape
            em.out(node, sg.op1("CAST", [v.idx], shape, dt, "CastOptions",
                                in_data_type=S.NP_TO_TYPE[v.dtype],
                                out_data_type=S.NP_TO_TYPE[dt]), v.perm)
    elif name in _UNARY or name in ("silu", "gelu", "softplus", "hardsigmoid", "square"):
        _emit_activation(em, node, name, x)
    elif name in _BINARY:
        if name in ("add", "sub") and arg(2, 1) != 1:
            raise NotImplementedError(f"tflite export: aten.{name} with alpha")
        if name == "div" and node.kwargs.get("rounding_mode") is not None:
            raise NotImplementedError("tflite export: aten.div with a rounding mode")
        dt = _np_dtype(node.meta["val"].dtype)
        if name in _COMPARE:          # compare in the tensor operand's dtype
            dt_in = next(em.value(a).dtype for a in args[:2] if em.const(a) is None)
        else:
            dt_in = dt
        idx, perm = em.broadcast(list(args[:2]), dt_in)
        shape, _ = em.new(node, perm)
        em.out(node, sg.op1(_BINARY[name], idx, shape, dt), perm)
    elif name == "clamp":
        lo, hi = arg(1), arg(2)
        act = _is_relu(node)
        v = em.value(x)
        if act == S.ACT_RELU6:
            em.out(node, sg.op1("RELU6", [v.idx], v.stored_shape, v.dtype), v.perm)
            return
        cur = v.idx
        if lo is not None:
            cur = sg.op1("MAXIMUM", [cur, sg.const(np.asarray(lo, v.dtype))], v.stored_shape,
                         v.dtype)
        if hi is not None:
            cur = sg.op1("MINIMUM", [cur, sg.const(np.asarray(hi, v.dtype))], v.stored_shape,
                         v.dtype)
        em.out(node, cur, v.perm)
    elif name == "where":
        dt = _np_dtype(node.meta["val"].dtype)
        idx, perm = em.broadcast(list(args[:3]), [np.bool_, dt, dt])
        shape, _ = em.new(node, perm)
        em.out(node, sg.op1("SELECT_V2", idx, shape, dt), perm)
    elif name == "conv2d":
        _emit_conv(em, node)
    elif name == "batch_norm":
        p = _bn_params(em, node)
        if p is None:
            raise NotImplementedError("tflite export: aten.batch_norm in training mode")
        gamma, beta, mean, var, eps = p
        scale = (gamma / np.sqrt(var.astype(np.float64) + eps)).astype(np.float32)
        bshape = (1, -1) + (1,) * (len(em.value(x).shape) - 2)
        v = em.value(x)
        mul = sg.op1("MUL", [v.idx, em.tensor_from_array(scale.reshape(bshape), v.perm)],
                     v.stored_shape, np.float32)
        shift = (beta - mean * scale).astype(np.float32).reshape(bshape)
        em.out(node, sg.op1("ADD", [mul, em.tensor_from_array(shift, v.perm)],
                            v.stored_shape, np.float32), v.perm)
    elif name == "linear":
        w = em.const(args[1])
        if w is None:
            raise NotImplementedError("tflite export: linear with a traced weight")
        v = em.tensor(x, _ident(len(em.value(x).shape)))
        b = arg(2)
        bias = em.const(b) if b is not None else np.zeros(w.shape[0], np.float32)
        shape, dt = em.new(node)
        em.out(node, sg.op1("FULLY_CONNECTED", [v.idx, sg.const(w.astype(np.float32)),
                                                sg.const(bias.astype(np.float32))],
                            shape, dt, "FullyConnectedOptions", keep_num_dims=True,
                            version=5))
    elif name in _REDUCE or name in ("argmax",):
        _emit_reduce(em, node, name, x, arg)
    elif name == "layer_norm":
        _emit_layer_norm(em, node, x, arg(1), arg(2), arg(3), arg(4, 1e-5))
    elif name in ("reshape", "view", "unsqueeze", "squeeze", "flatten"):
        v = em.reshape(em.value(x), node.meta["val"].shape)
        em.env[node] = v
    elif name in ("permute", "transpose"):
        v = em.value(x)
        nd = len(v.shape)
        if name == "permute":
            dims = [int(d) % nd for d in args[1]]
        else:
            dims = list(range(nd))
            i, j = int(args[1]) % nd, int(args[2]) % nd
            dims[i], dims[j] = dims[j], dims[i]
        em.env[node] = _Value(v.idx, [v.shape[d] for d in dims], v.dtype,
                              [v.perm[d] for d in dims])
    elif name == "cat":
        tensors = list(x)
        ref = next(em.value(t) for t in tensors if em.const(t) is None)
        dt = _np_dtype(node.meta["val"].dtype)
        dim = int(arg(1, 0)) % len(ref.shape)
        idx = [em.tensor(t, ref.perm, dt).idx for t in tensors]
        shape, _ = em.new(node, ref.perm)
        em.out(node, sg.op1("CONCATENATION", idx, shape, dt, "ConcatenationOptions",
                            axis=ref.perm[dim]), ref.perm)
    elif name in ("slice", "select"):
        v = em.value(x)
        nd = len(v.shape)
        dim = int(arg(1, 0)) % nd
        size = v.shape[dim]
        stored = v.stored_shape
        begin, end, strides = [0] * nd, list(stored), [1] * nd
        pd = v.perm[dim]
        if name == "slice":
            start, stop, step = arg(2), arg(3), int(arg(4, 1))
            start = 0 if start is None else int(start)
            stop = size if stop is None else int(stop)
            start = min(max(start + size if start < 0 else start, 0), size)
            stop = min(max(stop + size if stop < 0 else stop, 0), size)
            begin[pd], end[pd], strides[pd] = start, stop, step
            shape, dt = em.new(node, v.perm)
            em.out(node, em.slice_op(v, begin, end, strides, 0, shape, dt), v.perm)
        else:
            index = int(args[2]) % size
            begin[pd], end[pd] = index, index + 1
            perm = [p - (p > pd) for i, p in enumerate(v.perm) if i != dim]
            shape, dt = em.new(node, perm)
            em.out(node, em.slice_op(v, begin, end, strides, 1 << pd, shape, dt), perm)
    elif name == "_upsample_nearest_exact2d":
        _emit_upsample(em, node, x)
    elif name == "gather":
        _emit_gather(em, node, x, int(args[1]), args[2])
    elif name == "sort":
        _emit_sort(em, node, x)
    elif name == "expand":
        v = em.tensor(x, _ident(len(em.value(x).shape)))
        shape, dt = em.new(node)
        if len(v.shape) < len(shape):
            v = em.reshape(v, (1,) * (len(shape) - len(v.shape)) + v.shape)
        em.out(node, sg.op1("BROADCAST_TO", [v.idx, sg.const(shape, np.int32)], shape, dt,
                            version=2))
    elif name in ("zeros_like", "full_like"):
        val = node.meta["val"]
        fill = 0 if name == "zeros_like" else arg(1)
        em.env[node] = ("c", np.full(tuple(val.shape), fill, _np_dtype(val.dtype)))
    elif name == "pad":
        _emit_pad(em, node, x, arg(1), arg(2, "constant"), arg(3, None))
    elif name == "bmm":
        _emit_bmm(em, node, x, args[1])
    else:
        raise NotImplementedError(
            f"tflite export: no TFLite mapping for aten.{name} ({tgt}); the emitter "
            f"covers the deploy graphs' op set")


def _emit_activation(em: _Emitter, node, name: str, x) -> None:
    sg = em.sg
    v = em.value(x)
    shape, dt = v.stored_shape, v.dtype
    if name in _UNARY:
        em.out(node, sg.op1(_UNARY[name], [v.idx], shape, _np_dtype(node.meta["val"].dtype)),
               v.perm)
        return
    if name == "silu":
        y = sg.op1("MUL", [v.idx, sg.op1("LOGISTIC", [v.idx], shape, dt)], shape, dt)
    elif name == "square":
        y = sg.op1("MUL", [v.idx, v.idx], shape, dt)
    elif name == "hardsigmoid":
        r6 = sg.op1("RELU6", [sg.op1("ADD", [v.idx, sg.const(np.float32(3.0))], shape, dt)],
                    shape, dt)
        y = sg.op1("DIV", [r6, sg.const(np.float32(6.0))], shape, dt)
    elif name == "gelu":
        approx = node.kwargs.get("approximate", node.args[1] if len(node.args) > 1
                                 else "none")
        y = sg.op1("GELU", [v.idx], shape, dt, "GeluOptions", approximate=approx == "tanh")
    else:                                   # softplus, beta 1: logaddexp(x, 0)
        beta = node.args[1] if len(node.args) > 1 else node.kwargs.get("beta", 1)
        if beta != 1:
            raise NotImplementedError("tflite export: softplus with beta != 1")
        e = sg.op1("EXP", [sg.op1("NEG", [sg.op1("ABS", [v.idx], shape, dt)], shape, dt)],
                   shape, dt)
        lg = sg.op1("LOG", [sg.op1("ADD", [e, sg.const(np.float32(1.0))], shape, dt)],
                    shape, dt)
        y = sg.op1("ADD", [sg.op1("MAXIMUM", [v.idx, sg.const(np.float32(0.0))], shape, dt),
                           lg], shape, dt)
    em.out(node, y, v.perm)


def _emit_reduce(em: _Emitter, node, name: str, x, arg) -> None:
    sg = em.sg
    v = em.value(x)
    nd = len(v.shape)
    if name == "argmax":
        dim = arg(1)
        if dim is None or arg(2, False):
            raise NotImplementedError("tflite export: argmax over all dims or keepdim")
        dims, keep = [int(dim) % nd], False
    else:
        d = arg(1)
        dims = sorted({int(i) % nd for i in (d if isinstance(d, (list, tuple)) else
                                             ([d] if d is not None else range(nd)))})
        keep = bool(arg(2, False))
    axes = [v.perm[d] for d in dims]
    if keep:
        perm = v.perm
    else:
        perm = [p - sum(a < p for a in axes) for i, p in enumerate(v.perm) if i not in dims]
    shape, dt = em.new(node, perm)
    if name == "argmax":
        idx = sg.op1("ARG_MAX", [v.idx, sg.const(axes, np.int32)], shape, dt,
                     "ArgMaxOptions", output_type=S.INT32)
    else:
        idx = sg.op1(_REDUCE[name], [v.idx, sg.const(axes, np.int32)], shape, dt,
                     "ReducerOptions", keep_dims=keep)
    em.out(node, idx, perm)


def _emit_layer_norm(em: _Emitter, node, x, norm_shape, w, b, eps) -> None:
    """(x - mean) * rsqrt(var + eps) * w + b over the last dims."""
    sg = em.sg
    v = em.value(x)
    nd = len(v.shape)
    axes = sorted(v.perm[d] for d in range(nd - len(norm_shape), nd))
    shape, dt = v.stored_shape, v.dtype
    red = [s if i not in axes else 1 for i, s in enumerate(shape)]
    ax = sg.const(axes, np.int32)
    mean = sg.op1("MEAN", [v.idx, ax], red, dt, "ReducerOptions", keep_dims=True)
    d = sg.op1("SUB", [v.idx, mean], shape, dt)
    var = sg.op1("MEAN", [sg.op1("MUL", [d, d], shape, dt), ax], red, dt, "ReducerOptions",
                 keep_dims=True)
    r = sg.op1("RSQRT", [sg.op1("ADD", [var, sg.const(np.float32(eps))], red, dt)], red, dt)
    y = sg.op1("MUL", [d, r], shape, dt)
    for p, op in ((w, "MUL"), (b, "ADD")):
        if p is not None:
            c = em.const(p).astype(np.float32)
            c = c.reshape((1,) * (nd - c.ndim) + c.shape)
            y = sg.op1(op, [y, em.tensor_from_array(c, v.perm)], shape, dt)
    em.out(node, y, v.perm)


def _emit_upsample(em: _Emitter, node, x) -> None:
    sg = em.sg
    v = em.tensor(x, (0, 3, 1, 2))
    in_hw, out_hw = v.shape[2:], tuple(node.meta["val"].shape[2:])
    shape, dt = em.new(node, (0, 3, 1, 2))
    if not any(o % i for i, o in zip(in_hw, out_hw)):
        # integer factor: floor(dst * in / out) is the pixel nearest-exact picks
        em.out(node, sg.op1("RESIZE_NEAREST_NEIGHBOR", [v.idx, sg.const(out_hw, np.int32)],
                            shape, dt, "ResizeNearestNeighborOptions", align_corners=False,
                            half_pixel_centers=False), (0, 3, 1, 2))
        return
    # another ratio (ConvNeXtV2's 21 -> 41 -> 81): constant source rows and
    # columns, floor((i + 0.5) * in / out)
    y, cur = v.idx, list(v.stored_shape)
    for axis, i, o in ((1, in_hw[0], out_hw[0]), (2, in_hw[1], out_hw[1])):
        src = np.minimum(np.floor((np.arange(o) + 0.5) * (i / o)), i - 1).astype(np.int32)
        cur[axis] = o
        y = sg.op1("GATHER", [y, sg.const(src)], list(cur), dt, "GatherOptions", axis=axis)
    em.out(node, y, (0, 3, 1, 2))


def _emit_gather(em: _Emitter, node, x, dim: int, index) -> None:
    sg = em.sg
    v = em.tensor(x, _ident(len(em.value(x).shape)))
    nd = len(v.shape)
    dim %= nd
    ishape = tuple(node.meta["val"].shape)
    base = _gather_base(em, index, ishape[:dim + 1])
    if base is None or ishape[dim + 1:] != v.shape[dim + 1:] or ishape[:dim] != v.shape[:dim]:
        raise NotImplementedError("tflite export: aten.gather other than a batched row "
                                  "gather (index broadcast over the trailing dims)")
    bi = em.tensor(base, _ident(dim + 1))
    shape, dt = em.new(node)
    em.out(node, sg.op1("GATHER", [v.idx, bi.idx], shape, dt, "GatherOptions", axis=dim,
                        batch_dims=dim, version=5 if dim else 1))


def _emit_sort(em: _Emitter, node, x) -> None:
    """A descending sort along the last dim -> TOPK_V2 of every element
    (TFLite's top-k puts the lower index first on ties, as a stable sort)."""
    v = em.value(x)
    nd = len(v.shape)
    if int(_arg(node, "dim", -1)) % nd != nd - 1 or not _arg(node, "descending", False):
        raise NotImplementedError("tflite export: aten.sort other than descending along "
                                  "the last dim")
    v = em.as_perm(v, _ident(nd))
    n = v.shape[-1]
    outs = em.sg.op("TOPK_V2", [v.idx, em.sg.const(np.int32(n))],
                    [(v.shape, v.dtype), (v.shape, np.int32)])
    em.env[node] = (_Value(outs[0], v.shape, v.dtype), _Value(outs[1], v.shape, np.int32))


def _emit_pad(em: _Emitter, node, x, pad, mode, value) -> None:
    if mode != "constant":
        raise NotImplementedError(f"tflite export: aten.pad mode {mode!r}")
    sg = em.sg
    v = em.value(x)
    nd = len(v.shape)
    logical = [[0, 0] for _ in range(nd)]
    for i in range(len(pad) // 2):
        logical[nd - 1 - i] = [int(pad[2 * i]), int(pad[2 * i + 1])]
    if any(p < 0 for pr in logical for p in pr):
        raise NotImplementedError("tflite export: aten.pad with a negative pad")
    pads = [logical[_inv(v.perm)[j]] for j in range(nd)]
    shape, dt = em.new(node, v.perm)
    src, work = v.idx, dt
    if dt == np.bool_:                       # PAD has no bool kernel
        work = np.dtype(np.int32)
        src = sg.op1("CAST", [src], v.stored_shape, work, "CastOptions",
                     in_data_type=S.BOOL, out_data_type=S.INT32)
    fill = 0 if value is None else value
    y = sg.op1("PADV2", [src, sg.const(pads, np.int32), sg.const(np.asarray(fill, work))],
               shape, work)
    if dt == np.bool_:
        y = sg.op1("CAST", [y], shape, dt, "CastOptions", in_data_type=S.INT32,
                   out_data_type=S.BOOL)
    em.out(node, y, v.perm)


def _emit_bmm(em: _Emitter, node, a, b) -> None:
    """bmm -> BATCH_MATMUL; an operand stored with its last two dims swapped
    uses adj_x / adj_y instead of a TRANSPOSE."""
    ops = []
    for t in (a, b):
        v = em.tensor(t)
        if v.perm == (0, 2, 1):
            ops.append((em.as_perm(v, (0, 2, 1)).idx, True))
        else:
            ops.append((em.as_perm(v, (0, 1, 2)).idx, False))
    shape, dt = em.new(node)
    em.out(node, em.sg.op1("BATCH_MATMUL", [ops[0][0], ops[1][0]], shape, dt,
                           "BatchMatMulOptions", adj_x=ops[0][1], adj_y=ops[1][1]))


# --------------------------------------------------------------------------- #
# quantization and the file
# --------------------------------------------------------------------------- #

def _quantize_dynamic(model: _Model) -> None:
    """int8 weights, per output channel, for the hybrid kernels."""
    kinds = {"CONV_2D": (0, 5), "DEPTHWISE_CONV_2D": (3, 6), "FULLY_CONNECTED": (0, 5)}
    names = {v: k for k, v in model.codes.items()}
    for sg in model.subgraphs:
        for op in sg.ops:
            kind, version = names[op["opcode_index"]]
            if kind not in kinds:
                continue
            t = sg.tensors[op["inputs"][1]]
            buf = model.buffers[t.get("buffer", 0)]
            if t["type"] != S.FLOAT32 or not buf.get("data"):
                continue
            w = np.frombuffer(buf["data"], np.float32).reshape(t["shape"])
            if w.size < DYNAMIC_MIN_ELEMENTS:
                continue
            axis = kinds[kind][0]
            red = tuple(i for i in range(w.ndim) if i != axis)
            scale = np.abs(w).max(axis=red) / 127.0
            scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
            bshape = [1] * w.ndim
            bshape[axis] = -1
            q = np.clip(np.round(w / scale.reshape(bshape)), -127, 127).astype(np.int8)
            buf["data"] = q.tobytes()
            t["type"] = S.INT8
            t["quantization"] = {"scale": scale.tolist(), "zero_point": [0] * len(scale),
                                 "quantized_dimension": axis}
            op["opcode_index"] = model.opcode(kind, kinds[kind][1])


def _quantize_fp16(model: _Model) -> None:
    """float16 buffers for every float constant of 2+ elements, each
    dequantized to fp32 at the start of its subgraph."""
    for sg in model.subgraphs:
        done: Dict[int, int] = {}
        deq = []
        for op in sg.ops:
            for j, ti in enumerate(op["inputs"]):
                if ti in done:
                    op["inputs"][j] = done[ti]
                    continue
                t = sg.tensors[ti] if ti >= 0 else None
                if t is None or t["type"] != S.FLOAT32 or not t.get("buffer"):
                    continue
                if int(np.prod(t["shape"])) < 2:
                    continue
                buf = model.buffers[t["buffer"]]
                buf["data"] = np.frombuffer(buf["data"], np.float32).astype(np.float16).tobytes()
                t["type"] = S.FLOAT16
                done[ti] = op["inputs"][j] = sg.tensor(t["shape"], np.float32, "dequantized")
                deq.append({"opcode_index": model.opcode("DEQUANTIZE", 3),
                            "inputs": [ti], "outputs": [done[ti]]})
        sg.ops[:0] = deq


def _prune(model: _Model) -> None:
    """Drop dead ops, unused tensors and unused buffers."""
    used_bufs = {0}
    for sg in model.subgraphs:
        live = set(sg.outputs)
        keep = []
        for op in reversed(sg.ops):
            if any(o in live for o in op["outputs"]):
                keep.append(op)
                live.update(i for i in op["inputs"] if i >= 0)
        sg.ops = keep[::-1]
        live.update(o for op in sg.ops for o in op["outputs"])
        used = sorted(live | set(sg.inputs) | set(sg.outputs))
        remap = {old: new for new, old in enumerate(used)}
        sg.tensors = [sg.tensors[i] for i in used]
        for op in sg.ops:
            op["inputs"] = [remap[i] if i >= 0 else i for i in op["inputs"]]
            op["outputs"] = [remap[i] for i in op["outputs"]]
        sg.inputs = [remap[i] for i in sg.inputs]
        sg.outputs = [remap[i] for i in sg.outputs]
        used_bufs.update(t.get("buffer", 0) for t in sg.tensors)
    order = sorted(used_bufs)
    bremap = {old: new for new, old in enumerate(order)}
    model.buffers = [model.buffers[i] for i in order]
    for sg in model.subgraphs:
        for t in sg.tensors:
            t["buffer"] = bremap[t.get("buffer", 0)]
    used_codes = sorted({op["opcode_index"] for sg in model.subgraphs for op in sg.ops})
    cremap = {old: new for new, old in enumerate(used_codes)}
    codes = {v: k for k, v in model.codes.items()}
    model.codes = {codes[old]: new for old, new in cremap.items()}
    for sg in model.subgraphs:
        for op in sg.ops:
            op["opcode_index"] = cremap[op["opcode_index"]]


def _serialize(model: _Model, input_names, output_names, description: str) -> bytes:
    main = model.subgraphs[0]
    codes = sorted(model.codes.items(), key=lambda kv: kv[1])
    return S.serialize_model({
        "version": S.SCHEMA_VERSION,
        "operator_codes": [S.operator_code(name, version) for (name, version), _ in codes],
        "subgraphs": [{"tensors": sg.tensors, "inputs": sg.inputs, "outputs": sg.outputs,
                       "operators": sg.ops, "name": sg.name} for sg in model.subgraphs],
        "description": description,
        "buffers": model.buffers,
        "signature_defs": [{
            "signature_key": "serving_default", "subgraph_index": 0,
            "inputs": [{"name": n, "tensor_index": i} for n, i in zip(input_names,
                                                                      main.inputs)],
            "outputs": [{"name": n, "tensor_index": i} for n, i in zip(output_names,
                                                                       main.outputs)]}],
    })


def export_program_to_tflite(ep, out_path: str, *, input_names: Sequence[str],
                             output_names: Sequence[str], quantize: Optional[str] = None,
                             description: str = "yololite_tpu_torch") -> str:
    """Write the graph of `ep` (a `torch.export.ExportedProgram` with static
    shapes) as a `.tflite` file whose `serving_default` signature takes the
    user inputs as `input_names` and gives the flattened outputs as
    `output_names`. quantize: None, "fp16" or "dynamic" (module docstring).
    Returns `out_path`."""
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be one of {QUANTIZE}, got {quantize!r}")
    sig = ep.graph_signature
    values = dict(ep.state_dict)
    values.update(ep.constants)
    user_inputs = [s.arg.name for s in sig.input_specs
                   if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    lifted = {s.arg.name: s.target for s in sig.input_specs
              if s.kind != torch.export.graph_signature.InputKind.USER_INPUT}
    if len(user_inputs) != len(input_names):
        raise ValueError(f"{len(input_names)} names for {len(user_inputs)} graph inputs")
    model = _Model()
    sg = model.subgraph("main")
    em = _Emitter(model, sg)
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            if node.name in lifted:
                em.env[node] = ("c", _to_np(values[lifted[node.name]]))
                continue
            val = node.meta["val"]
            if any(not isinstance(d, int) for d in val.shape):
                raise NotImplementedError("tflite export: a symbolic input shape")
            idx = sg.tensor(val.shape, _np_dtype(val.dtype), "input")
            sg.tensors[idx]["name"] = input_names[user_inputs.index(node.name)]
            sg.inputs.append(idx)
            em.out(node, idx)
        elif node.op == "call_function":
            _emit(em, node)
        elif node.op == "output":
            outs = torch.utils._pytree.tree_leaves(node.args[0])
            if len(outs) != len(output_names):
                raise ValueError(f"{len(output_names)} names for {len(outs)} outputs")
            for oname, o in zip(output_names, outs):
                v = em.tensor(o, _ident(len(o.meta["val"].shape)),
                              _np_dtype(o.meta["val"].dtype))
                idx = v.idx
                if idx in sg.outputs or idx in sg.inputs or sg.tensors[idx].get("buffer"):
                    idx = sg.op1("RESHAPE", [idx, sg.const(list(v.shape), np.int32)],
                                 list(v.shape), v.dtype, "ReshapeOptions",
                                 new_shape=list(v.shape))
                sg.tensors[idx]["name"] = oname
                sg.outputs.append(idx)
    _prune(model)
    if quantize == "dynamic":
        _quantize_dynamic(model)
    elif quantize == "fp16":
        _quantize_fp16(model)
    blob = _serialize(model, input_names, output_names, description)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path
