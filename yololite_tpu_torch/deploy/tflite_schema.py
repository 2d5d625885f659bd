"""First-party FlatBuffers codec for the TFLite schema (no `flatbuffers` or
`tensorflow` package).

The counterpart of `deploy/onnx_proto.py` for `.tflite` files:
`deploy/tflite_emit.py` writes through `serialize_model` and
`deploy/tflite_run.py` reads with `parse_model`. The tables, their field
slots and their defaults are those of TFLite's `schema.fbs` (schema version
3) for the subset that the emitter writes; the reader also parses files of
TF's converter far enough to list their operator codes, tensors, dtypes,
quantization and signatures.

FlatBuffers layout refresher:
  - the file starts with the uoffset (u32) of the root table, then the
    4-byte file identifier (`TFL3`);
  - a table starts with an soffset (i32) to its vtable (vtable = table -
    soffset); the vtable is u16 [vtable bytes, table bytes, field offsets]
    and a field offset 0 means "absent: the default";
  - a uoffset (u32) is relative to where it is stored and points forward;
  - a vector is a u32 length and then its elements, each aligned to its
    size; a string is a vector of bytes with a trailing NUL.

The writer lays objects out front to back in pre-order (a table, then the
objects it refers to), so every uoffset points forward; each table's
vtable sits just before it. Vectors of scalars are aligned to their element
size and buffer data to 16 bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

FILE_IDENTIFIER = b"TFL3"
SCHEMA_VERSION = 3

# TensorType
FLOAT32, FLOAT16, INT32, UINT8, INT64, BOOL, INT16, INT8, FLOAT64 = 0, 1, 2, 3, 4, 6, 7, 9, 10
TYPE_TO_NP = {FLOAT32: np.float32, FLOAT16: np.float16, INT32: np.int32, UINT8: np.uint8,
              INT64: np.int64, BOOL: np.bool_, INT16: np.int16, INT8: np.int8,
              FLOAT64: np.float64}
NP_TO_TYPE = {np.dtype(v): k for k, v in TYPE_TO_NP.items()}

# BuiltinOperator codes (the subset the emitter and the runner know)
BUILTIN = {
    "ADD": 0, "AVERAGE_POOL_2D": 1, "CONCATENATION": 2, "CONV_2D": 3,
    "DEPTHWISE_CONV_2D": 4, "DEQUANTIZE": 6, "FULLY_CONNECTED": 9, "LOGISTIC": 14,
    "MAX_POOL_2D": 17, "MUL": 18, "RELU": 19, "RELU6": 21, "RESHAPE": 22, "TANH": 28,
    "PAD": 34, "GATHER": 36, "TRANSPOSE": 39, "MEAN": 40, "SUB": 41, "DIV": 42,
    "SQUEEZE": 43, "STRIDED_SLICE": 45, "EXP": 47, "TOPK_V2": 48, "CAST": 53,
    "MAXIMUM": 55, "ARG_MAX": 56, "MINIMUM": 57, "LESS": 58, "NEG": 59, "PADV2": 60,
    "GREATER": 61, "GREATER_EQUAL": 62, "LESS_EQUAL": 63, "SELECT": 64, "SLICE": 65,
    "EQUAL": 71, "NOT_EQUAL": 72, "LOG": 73, "SUM": 74, "SQRT": 75, "RSQRT": 76,
    "REDUCE_MAX": 82, "LOGICAL_OR": 84, "LOGICAL_AND": 86, "LOGICAL_NOT": 87,
    "REDUCE_ANY": 91, "SQUARE": 92, "RESIZE_NEAREST_NEIGHBOR": 97, "ABS": 101,
    "GATHER_ND": 107, "HARD_SWISH": 117, "WHILE": 119, "SELECT_V2": 123,
    "BATCH_MATMUL": 126, "PLACEHOLDER_FOR_GREATER_OP_CODES": 127, "BROADCAST_TO": 130,
    "REDUCE_ALL": 140, "GELU": 150,
}
BUILTIN_NAME = {v: k for k, v in BUILTIN.items()}

# Padding, ActivationFunctionType
SAME, VALID = 0, 1
ACT_NONE, ACT_RELU, ACT_RELU6 = 0, 1, 3

# ---------------------------------------------------------------------------
# schema: per table, its fields in slot order as (name, kind, default);
# None marks a deprecated or unused slot. Kinds: a scalar format letter of
# `struct` ("B" u8, "b" i8, "?" bool, "i" i32, "I" u32, "q" i64, "Q" u64,
# "f" f32), "str", "[x]" a vector of scalars x, "[T]" a vector of tables T,
# "T" a table T, "union:<type field>" a union table.
# ---------------------------------------------------------------------------

_ = None
TABLES: Dict[str, List[Optional[Tuple[str, str, Any]]]] = {
    "Model": [("version", "I", 0), ("operator_codes", "[OperatorCode]", None),
              ("subgraphs", "[SubGraph]", None), ("description", "str", None),
              ("buffers", "[Buffer]", None), ("metadata_buffer", "[i]", None),
              ("metadata", "[Metadata]", None), ("signature_defs", "[SignatureDef]", None)],
    "OperatorCode": [("deprecated_builtin_code", "b", 0), ("custom_code", "str", None),
                     ("version", "i", 1), ("builtin_code", "i", 0)],
    "SubGraph": [("tensors", "[Tensor]", None), ("inputs", "[i]", None),
                 ("outputs", "[i]", None), ("operators", "[Operator]", None),
                 ("name", "str", None)],
    "Tensor": [("shape", "[i]", None), ("type", "b", FLOAT32), ("buffer", "I", 0),
               ("name", "str", None), ("quantization", "QuantizationParameters", None),
               ("is_variable", "?", False), _, ("shape_signature", "[i]", None),
               ("has_rank", "?", False)],
    "Buffer": [("data", "[B]", None), ("offset", "Q", 0), ("size", "Q", 0)],
    "Metadata": [("name", "str", None), ("buffer", "I", 0)],
    "Operator": [("opcode_index", "I", 0), ("inputs", "[i]", None), ("outputs", "[i]", None),
                 ("builtin_options_type", "B", 0),
                 ("builtin_options", "union:builtin_options_type", None),
                 ("custom_options", "[B]", None), ("custom_options_format", "b", 0),
                 ("mutating_variable_inputs", "[?]", None), ("intermediates", "[i]", None)],
    "QuantizationParameters": [("min", "[f]", None), ("max", "[f]", None),
                               ("scale", "[f]", None), ("zero_point", "[q]", None),
                               ("details_type", "B", 0), _, ("quantized_dimension", "i", 0)],
    "SignatureDef": [("inputs", "[TensorMap]", None), ("outputs", "[TensorMap]", None),
                     ("signature_key", "str", None), _, ("subgraph_index", "I", 0)],
    "TensorMap": [("name", "str", None), ("tensor_index", "I", 0)],
    # builtin options
    "Conv2DOptions": [("padding", "b", SAME), ("stride_w", "i", 0), ("stride_h", "i", 0),
                      ("fused_activation_function", "b", 0), ("dilation_w_factor", "i", 1),
                      ("dilation_h_factor", "i", 1)],
    "DepthwiseConv2DOptions": [("padding", "b", SAME), ("stride_w", "i", 0),
                               ("stride_h", "i", 0), ("depth_multiplier", "i", 0),
                               ("fused_activation_function", "b", 0),
                               ("dilation_w_factor", "i", 1), ("dilation_h_factor", "i", 1)],
    "Pool2DOptions": [("padding", "b", SAME), ("stride_w", "i", 0), ("stride_h", "i", 0),
                      ("filter_width", "i", 0), ("filter_height", "i", 0),
                      ("fused_activation_function", "b", 0)],
    "FullyConnectedOptions": [("fused_activation_function", "b", 0),
                              ("weights_format", "b", 0), ("keep_num_dims", "?", False),
                              ("asymmetric_quantize_inputs", "?", False)],
    "ConcatenationOptions": [("axis", "i", 0), ("fused_activation_function", "b", 0)],
    "AddOptions": [("fused_activation_function", "b", 0)],
    "SubOptions": [("fused_activation_function", "b", 0)],
    "MulOptions": [("fused_activation_function", "b", 0)],
    "DivOptions": [("fused_activation_function", "b", 0)],
    "ReshapeOptions": [("new_shape", "[i]", None)],
    "GatherOptions": [("axis", "i", 0), ("batch_dims", "i", 0)],
    "ReducerOptions": [("keep_dims", "?", False)],
    "StridedSliceOptions": [("begin_mask", "i", 0), ("end_mask", "i", 0),
                            ("ellipsis_mask", "i", 0), ("new_axis_mask", "i", 0),
                            ("shrink_axis_mask", "i", 0), ("offset", "?", False)],
    "ResizeNearestNeighborOptions": [("align_corners", "?", False),
                                     ("half_pixel_centers", "?", False)],
    "CastOptions": [("in_data_type", "b", 0), ("out_data_type", "b", 0)],
    "ArgMaxOptions": [("output_type", "b", 0)],
    "BatchMatMulOptions": [("adj_x", "?", False), ("adj_y", "?", False),
                           ("asymmetric_quantize_inputs", "?", False)],
    "WhileOptions": [("cond_subgraph_index", "i", 0), ("body_subgraph_index", "i", 0)],
    "GeluOptions": [("approximate", "?", False)],
    "SqueezeOptions": [("squeeze_dims", "[i]", None)],
    "Empty": [],
}

# BuiltinOptions union: type id -> table (the options tables without
# fields share the empty table)
OPTIONS = {
    1: "Conv2DOptions", 2: "DepthwiseConv2DOptions", 5: "Pool2DOptions",
    8: "FullyConnectedOptions", 10: "ConcatenationOptions", 11: "AddOptions",
    17: "ReshapeOptions", 21: "MulOptions", 22: "Empty", 23: "GatherOptions",
    26: "Empty", 27: "ReducerOptions", 28: "SubOptions", 29: "DivOptions",
    30: "SqueezeOptions", 32: "StridedSliceOptions", 33: "Empty", 34: "Empty",
    37: "CastOptions", 38: "Empty", 39: "Empty", 40: "ArgMaxOptions", 41: "Empty",
    42: "Empty", 43: "Empty", 44: "Empty", 45: "Empty", 46: "Empty", 47: "Empty",
    48: "Empty", 53: "Empty", 54: "Empty", 60: "Empty", 62: "Empty", 63: "Empty",
    66: "Empty", 74: "ResizeNearestNeighborOptions", 78: "Empty", 91: "Empty",
    93: "WhileOptions", 98: "Empty", 101: "BatchMatMulOptions", 104: "Empty",
    116: "GeluOptions",
}
OPTIONS_ID = {
    "Conv2DOptions": 1, "DepthwiseConv2DOptions": 2, "Pool2DOptions": 5,
    "FullyConnectedOptions": 8, "ConcatenationOptions": 10, "AddOptions": 11,
    "ReshapeOptions": 17, "MulOptions": 21, "PadOptions": 22, "GatherOptions": 23,
    "TransposeOptions": 26, "ReducerOptions": 27, "SubOptions": 28, "DivOptions": 29,
    "SqueezeOptions": 30, "StridedSliceOptions": 32, "ExpOptions": 33,
    "TopKV2Options": 34, "CastOptions": 37, "DequantizeOptions": 38,
    "MaximumMinimumOptions": 39, "ArgMaxOptions": 40, "LessOptions": 41,
    "NegOptions": 42, "PadV2Options": 43, "GreaterOptions": 44,
    "GreaterEqualOptions": 45, "LessEqualOptions": 46, "SelectOptions": 47,
    "SliceOptions": 48, "EqualOptions": 53, "NotEqualOptions": 54,
    "LogicalOrOptions": 60, "LogicalAndOptions": 62, "LogicalNotOptions": 63,
    "SquareOptions": 66, "ResizeNearestNeighborOptions": 74, "AbsOptions": 78,
    "HardSwishOptions": 91, "WhileOptions": 93, "SelectV2Options": 98,
    "BatchMatMulOptions": 101, "BroadcastToOptions": 104, "GeluOptions": 116,
}

_SCALAR_SIZE = {"B": 1, "b": 1, "?": 1, "h": 2, "H": 2, "i": 4, "I": 4, "f": 4,
                "q": 8, "Q": 8, "d": 8}


def _options_table(type_id: int) -> str:
    return OPTIONS.get(int(type_id), "Empty")


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def pad_to(self, align: int, extra: int = 0) -> None:
        """Zero-pad so that (len + extra) is a multiple of `align`."""
        self.buf.extend(b"\0" * ((-(len(self.buf) + extra)) % align))

    def patch_uoffset(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def table(self, name: str, obj: dict) -> int:
        """Write table `name` from dict `obj` (and then everything it refers
        to); returns the table's position."""
        fields = TABLES[name]
        scalars, refs = [], []
        for slot, f in enumerate(fields):
            if f is None:
                continue
            fname, kind, _default = f
            v = obj.get(fname)
            if v is None:
                continue
            if kind in _SCALAR_SIZE:
                scalars.append((slot, kind, v))
            else:
                refs.append((slot, _options_table(obj[kind[6:]])
                             if kind.startswith("union:") else kind, v))
        # inline layout after the soffset: 8-byte scalars, then 4-byte
        # scalars and uoffsets, then 1-byte scalars
        layout, size = {}, 4
        order = sorted(scalars, key=lambda s: -_SCALAR_SIZE[s[1]])
        big = [s for s in order if _SCALAR_SIZE[s[1]] == 8]
        if big:
            size = 8                      # the soffset, then padding to 8
        for slot, kind, _v in big:
            layout[slot] = size
            size += 8
        for slot, kind, _v in [s for s in order if _SCALAR_SIZE[s[1]] == 4]:
            layout[slot] = size
            size += 4
        for slot, _kind, _v in refs:
            layout[slot] = size
            size += 4
        for slot, kind, _v in [s for s in order if _SCALAR_SIZE[s[1]] <= 2]:
            sz = _SCALAR_SIZE[kind]
            size += (-size) % sz
            layout[slot] = size
            size += sz
        align = 8 if big else 4
        size += (-size) % align
        nslots = max(layout) + 1 if layout else 0
        vt = struct.pack("<HH", 4 + 2 * nslots, size) + b"".join(
            struct.pack("<H", layout.get(i, 0)) for i in range(nslots))
        self.pad_to(align, len(vt))
        vt_pos = len(self.buf)
        self.buf.extend(vt)
        pos = len(self.buf)
        self.buf.extend(b"\0" * size)
        struct.pack_into("<i", self.buf, pos, pos - vt_pos)
        for slot, kind, v in scalars:
            struct.pack_into("<" + kind, self.buf, pos + layout[slot], v)
        for slot, kind, v in refs:
            self.patch_uoffset(pos + layout[slot], self.value(kind, v))
        return pos

    def value(self, kind: str, v) -> int:
        """Write a referenced object; returns its position."""
        if kind == "str":
            data = v.encode() if isinstance(v, str) else bytes(v)
            self.pad_to(4)
            pos = len(self.buf)
            self.buf.extend(struct.pack("<I", len(data)) + data + b"\0")
            return pos
        if kind.startswith("[") and kind[1:-1] in _SCALAR_SIZE:
            code = kind[1:-1]
            if code == "B" and isinstance(v, (bytes, bytearray, memoryview, np.ndarray)):
                data = bytes(v) if not isinstance(v, np.ndarray) else v.tobytes()
                self.pad_to(16, 4)        # buffer data 16-byte aligned
                pos = len(self.buf)
                self.buf.extend(struct.pack("<I", len(data)))
                self.buf.extend(data)
                return pos
            arr = list(v)
            self.pad_to(max(4, _SCALAR_SIZE[code]), 4)
            pos = len(self.buf)
            self.buf.extend(struct.pack("<I", len(arr)))
            self.buf.extend(struct.pack("<%d%s" % (len(arr), code), *arr))
            return pos
        if kind.startswith("["):
            tname = kind[1:-1]
            self.pad_to(4)
            pos = len(self.buf)
            self.buf.extend(struct.pack("<I", len(v)) + b"\0" * (4 * len(v)))
            for i, item in enumerate(v):
                self.patch_uoffset(pos + 4 + 4 * i, self.table(tname, item))
            return pos
        return self.table(kind, v)


def serialize_model(model: dict) -> bytes:
    """A `.tflite` file from a Model dict (the field names of TABLES; an
    operator's options as `builtin_options_type` + `builtin_options`)."""
    w = _Writer()
    w.buf.extend(b"\0" * 4 + FILE_IDENTIFIER)
    w.patch_uoffset(0, w.table("Model", model))
    return bytes(w.buf)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.raw = buf

    def u32(self, pos: int) -> int:
        return struct.unpack_from("<I", self.buf, pos)[0]

    def table(self, name: str, pos: int) -> dict:
        vt = pos - struct.unpack_from("<i", self.buf, pos)[0]
        vt_size = struct.unpack_from("<H", self.buf, vt)[0]
        out = {}
        fields = TABLES[name]
        for slot, f in enumerate(fields):
            if f is None:
                continue
            fname, kind, default = f
            off = struct.unpack_from("<H", self.buf, vt + 4 + 2 * slot)[0] \
                if 4 + 2 * slot < vt_size else 0
            if kind in _SCALAR_SIZE:
                out[fname] = (struct.unpack_from("<" + kind, self.buf, pos + off)[0]
                              if off else default)
                continue
            if not off:
                out[fname] = default
                continue
            target = pos + off + self.u32(pos + off)
            if kind.startswith("union:"):
                tname = _options_table(out[kind[6:]])
                out[fname] = self.table(tname, target)
            else:
                out[fname] = self.value(kind, target)
        return out

    def value(self, kind: str, pos: int):
        n = self.u32(pos)
        if kind == "str":
            return bytes(self.buf[pos + 4:pos + 4 + n]).decode("utf-8", "replace")
        if kind.startswith("[") and kind[1:-1] in _SCALAR_SIZE:
            code = kind[1:-1]
            if code == "B":
                return np.frombuffer(self.raw, np.uint8, n, pos + 4)
            return list(struct.unpack_from("<%d%s" % (n, code), self.buf, pos + 4))
        if kind.startswith("["):
            tname = kind[1:-1]
            return [self.table(tname, pos + 4 + 4 * i + self.u32(pos + 4 + 4 * i))
                    for i in range(n)]
        return self.table(kind, pos)


def parse_model(buf: bytes) -> dict:
    """The Model dict of a `.tflite` file (buffer data as uint8 arrays that
    view `buf`). Raises ValueError on a file without the TFL3 identifier."""
    if len(buf) < 8 or bytes(buf[4:8]) != FILE_IDENTIFIER:
        raise ValueError("not a TFLite flatbuffer (no 'TFL3' file identifier)")
    r = _Reader(buf)
    return r.table("Model", r.u32(0))


def opcode(code: dict) -> int:
    """An OperatorCode's builtin code: the larger of `builtin_code` and
    `deprecated_builtin_code` (codes above 127 keep 127 in the latter)."""
    return max(int(code.get("builtin_code") or 0),
               int(code.get("deprecated_builtin_code") or 0))


def op_name(code: dict) -> str:
    if code.get("custom_code"):
        return "CUSTOM:" + code["custom_code"]
    c = opcode(code)
    return BUILTIN_NAME.get(c, f"BUILTIN_{c}")


def operator_code(name: str, version: int = 1) -> dict:
    """The OperatorCode of builtin `name`; a code above 127 keeps
    PLACEHOLDER_FOR_GREATER_OP_CODES in `deprecated_builtin_code`."""
    c = BUILTIN[name]
    return {"deprecated_builtin_code": min(c, 127), "builtin_code": c, "version": version}


def tensor_array(model: dict, tensor: dict) -> Optional[np.ndarray]:
    """The constant data of `tensor` (None for an activation), in its dtype
    and shape."""
    data = model["buffers"][tensor["buffer"]].get("data") if tensor["buffer"] else None
    if data is None or len(data) == 0:
        return None
    dt = np.dtype(TYPE_TO_NP[tensor["type"]])
    arr = np.frombuffer(data.tobytes() if dt.alignment > 1 else data, dt)
    return arr.reshape(tensor.get("shape") or ())
