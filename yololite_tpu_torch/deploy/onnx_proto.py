"""Minimal pure-Python ONNX protobuf codec (no `onnx` package required).

The port's own copy of `yololite_tpu/deploy/onnx_proto.py` (numpy only);
`deploy/onnx_emit.py` writes through it and `deploy/onnx_run.py` parses with it.

The environment ships neither `onnx` nor `onnxruntime`, yet the reference's
entire CPU deploy story is ONNX files (reference export/export_onnx.py:179-332,
tools/infer_onnx.py:143-233). This module implements just enough of the
protobuf wire format + the ONNX IR message schema to (a) serialize the models
`deploy/onnx_emit.py` builds and (b) parse ONNX files back for the first-party
executor (`deploy/onnx_run.py`).

Schema field numbers follow the public ONNX IR definition
(github.com/onnx/onnx, onnx/onnx.proto, IR version 8). Correctness of the
encoding is cross-validated by parsing files that the JAX package's writer
serialized (tests/test_torch_port_export.py).

Wire format refresher (protobuf encoding spec):
  tag = (field_number << 3) | wire_type
  wire 0 = varint, wire 1 = 64-bit, wire 2 = length-delimited, wire 5 = 32-bit
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ----------------------------------------------------------------------------
# low-level wire format
# ----------------------------------------------------------------------------


def _enc_varint(v: int) -> bytes:
    if v < 0:  # protobuf int64: two's complement, 10 bytes
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ----------------------------------------------------------------------------
# message specs: field number -> (name, kind[, subspec])
# kind: "varint" | "float32" | "bytes" | "string" | "msg" | list-variants "*s"
# ----------------------------------------------------------------------------

OPERATOR_SET_ID = {
    1: ("domain", "string"),
    2: ("version", "varint"),
}

STRING_STRING_ENTRY = {
    1: ("key", "string"),
    2: ("value", "string"),
}

TENSOR_SHAPE_DIM = {
    1: ("dim_value", "varint"),
    2: ("dim_param", "string"),
    3: ("denotation", "string"),
}

TENSOR_SHAPE = {
    1: ("dim", "msgs", TENSOR_SHAPE_DIM),
}

TYPE_TENSOR = {
    1: ("elem_type", "varint"),
    2: ("shape", "msg", TENSOR_SHAPE),
}

TYPE_PROTO = {
    1: ("tensor_type", "msg", TYPE_TENSOR),
    6: ("denotation", "string"),
}

VALUE_INFO = {
    1: ("name", "string"),
    2: ("type", "msg", TYPE_PROTO),
    3: ("doc_string", "string"),
}

TENSOR_PROTO = {
    1: ("dims", "varints"),
    2: ("data_type", "varint"),
    4: ("float_data", "float32s"),
    5: ("int32_data", "varints"),
    7: ("int64_data", "varints"),
    8: ("name", "string"),
    9: ("raw_data", "bytes"),
    12: ("doc_string", "string"),
}

# AttributeProto.type enum
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8

GRAPH_PROTO: Dict[int, tuple] = {}  # filled below (recursive via attribute)

ATTRIBUTE_PROTO = {
    1: ("name", "string"),
    2: ("f", "float32"),
    3: ("i", "varint"),
    4: ("s", "bytes"),
    5: ("t", "msg", TENSOR_PROTO),
    6: ("g", "msg", GRAPH_PROTO),
    7: ("floats", "float32s"),
    8: ("ints", "varints"),
    9: ("strings", "bytess"),
    13: ("doc_string", "string"),
    20: ("type", "varint"),
}

NODE_PROTO = {
    1: ("input", "strings"),
    2: ("output", "strings"),
    3: ("name", "string"),
    4: ("op_type", "string"),
    5: ("attribute", "msgs", ATTRIBUTE_PROTO),
    6: ("doc_string", "string"),
    7: ("domain", "string"),
}

GRAPH_PROTO.update({
    1: ("node", "msgs", NODE_PROTO),
    2: ("name", "string"),
    5: ("initializer", "msgs", TENSOR_PROTO),
    10: ("doc_string", "string"),
    11: ("input", "msgs", VALUE_INFO),
    12: ("output", "msgs", VALUE_INFO),
    13: ("value_info", "msgs", VALUE_INFO),
})

MODEL_PROTO = {
    1: ("ir_version", "varint"),
    2: ("producer_name", "string"),
    3: ("producer_version", "string"),
    4: ("domain", "string"),
    5: ("model_version", "varint"),
    6: ("doc_string", "string"),
    7: ("graph", "msg", GRAPH_PROTO),
    8: ("opset_import", "msgs", OPERATOR_SET_ID),
    14: ("metadata_props", "msgs", STRING_STRING_ENTRY),
}

# TensorProto.DataType enum <-> numpy
DTYPE_TO_ONNX = {
    np.dtype(np.float32): 1, np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5, np.dtype(np.int32): 6,
    np.dtype(np.int64): 7, np.dtype(np.bool_): 9, np.dtype(np.float16): 10,
    np.dtype(np.float64): 11, np.dtype(np.uint32): 12, np.dtype(np.uint64): 13,
}
ONNX_TO_DTYPE = {v: k for k, v in DTYPE_TO_ONNX.items()}


# ----------------------------------------------------------------------------
# generic encoder: a message is a plain dict {field_name: value}
# ----------------------------------------------------------------------------


def _enc_field(num: int, kind: str, value: Any, spec) -> bytes:
    key0 = _enc_varint(num << 3)        # varint
    key2 = _enc_varint((num << 3) | 2)  # length-delimited
    key5 = _enc_varint((num << 3) | 5)  # 32-bit
    if kind == "varint":
        return key0 + _enc_varint(int(value))
    if kind == "varints":  # packed repeated int64
        payload = b"".join(_enc_varint(int(v)) for v in value)
        return key2 + _enc_varint(len(payload)) + payload
    if kind == "float32":
        return key5 + struct.pack("<f", float(value))
    if kind == "float32s":  # packed repeated float
        payload = struct.pack(f"<{len(value)}f", *[float(v) for v in value])
        return key2 + _enc_varint(len(payload)) + payload
    if kind in ("bytes", "string"):
        data = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        return key2 + _enc_varint(len(data)) + data
    if kind in ("bytess", "strings"):
        out = b""
        for v in value:
            data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            out += key2 + _enc_varint(len(data)) + data
        return out
    if kind == "msg":
        data = encode_msg(value, spec)
        return key2 + _enc_varint(len(data)) + data
    if kind == "msgs":
        out = b""
        for v in value:
            data = encode_msg(v, spec)
            out += key2 + _enc_varint(len(data)) + data
        return out
    raise ValueError(f"unknown field kind {kind}")


def encode_msg(msg: Dict[str, Any], spec: Dict[int, tuple]) -> bytes:
    by_name = {entry[0]: (num, entry) for num, entry in spec.items()}
    out = b""
    for name, value in msg.items():
        if value is None:
            continue
        num, entry = by_name[name]
        kind = entry[1]
        sub = entry[2] if len(entry) > 2 else None
        out += _enc_field(num, kind, value, sub)
    return out


# ----------------------------------------------------------------------------
# generic decoder
# ----------------------------------------------------------------------------


def decode_msg(buf: bytes, spec: Dict[int, tuple]) -> Dict[str, Any]:
    msg: Dict[str, Any] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _dec_varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        entry = spec.get(num)
        # read raw payload first so unknown fields are skippable
        if wire == 0:
            raw, pos = _dec_varint(buf, pos)
        elif wire == 1:
            raw = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _dec_varint(buf, pos)
            raw = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            raw = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if entry is None:
            continue  # unknown field: skip
        name, kind = entry[0], entry[1]
        sub = entry[2] if len(entry) > 2 else None
        if kind == "varint":
            msg[name] = _signed64(raw)
        elif kind == "varints":
            if wire == 0:  # unpacked element
                msg.setdefault(name, []).append(_signed64(raw))
            else:  # packed
                vals, p = [], 0
                while p < len(raw):
                    v, p = _dec_varint(raw, p)
                    vals.append(_signed64(v))
                msg.setdefault(name, []).extend(vals)
        elif kind == "float32":
            msg[name] = struct.unpack("<f", raw)[0]
        elif kind == "float32s":
            if wire == 5:
                msg.setdefault(name, []).append(struct.unpack("<f", raw)[0])
            else:
                msg.setdefault(name, []).extend(
                    struct.unpack(f"<{len(raw) // 4}f", raw))
        elif kind == "string":
            msg[name] = raw.decode("utf-8")
        elif kind == "bytes":
            msg[name] = raw
        elif kind == "strings":
            msg.setdefault(name, []).append(raw.decode("utf-8"))
        elif kind == "bytess":
            msg.setdefault(name, []).append(raw)
        elif kind == "msg":
            msg[name] = decode_msg(raw, sub)
        elif kind == "msgs":
            msg.setdefault(name, []).append(decode_msg(raw, sub))
        else:
            raise ValueError(f"unknown field kind {kind}")
    return msg


# ----------------------------------------------------------------------------
# ONNX-level helpers
# ----------------------------------------------------------------------------


def tensor_proto(name: str, arr: np.ndarray) -> Dict[str, Any]:
    arr = np.ascontiguousarray(arr)
    return {
        "name": name,
        "dims": list(arr.shape),
        "data_type": DTYPE_TO_ONNX[arr.dtype],
        "raw_data": arr.tobytes(),
    }


def tensor_to_array(t: Dict[str, Any]) -> np.ndarray:
    dt = ONNX_TO_DTYPE[t["data_type"]]
    dims = t.get("dims", [])
    if "raw_data" in t:
        return np.frombuffer(t["raw_data"], dtype=dt).reshape(dims).copy()
    if "float_data" in t:
        return np.asarray(t["float_data"], np.float32).astype(dt).reshape(dims)
    if "int64_data" in t:
        return np.asarray(t["int64_data"], np.int64).astype(dt).reshape(dims)
    if "int32_data" in t:
        # int32_data also carries uint8/int8/int16/bool/float16 payloads
        return np.asarray(t["int32_data"], np.int64).astype(dt).reshape(dims)
    return np.zeros(dims, dt)


def value_info(name: str, dtype: np.dtype, shape) -> Dict[str, Any]:
    return {
        "name": name,
        "type": {"tensor_type": {
            "elem_type": DTYPE_TO_ONNX[np.dtype(dtype)],
            # str dims become symbolic dim_param entries (dynamic batch)
            "shape": {"dim": [{"dim_param": d} if isinstance(d, str)
                              else {"dim_value": int(d)} for d in shape]},
        }},
    }


def attr(name: str, value: Any) -> Dict[str, Any]:
    """Build an AttributeProto dict from a python value (type inferred)."""
    if isinstance(value, bool):
        return {"name": name, "type": ATTR_INT, "i": int(value)}
    if isinstance(value, int):
        return {"name": name, "type": ATTR_INT, "i": value}
    if isinstance(value, float):
        return {"name": name, "type": ATTR_FLOAT, "f": value}
    if isinstance(value, str):
        return {"name": name, "type": ATTR_STRING, "s": value.encode("utf-8")}
    if isinstance(value, bytes):
        return {"name": name, "type": ATTR_STRING, "s": value}
    if isinstance(value, np.ndarray):
        return {"name": name, "type": ATTR_TENSOR, "t": tensor_proto("", value)}
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            return {"name": name, "type": ATTR_INTS, "ints": [int(v) for v in value]}
        if all(isinstance(v, (float, np.floating)) for v in value):
            return {"name": name, "type": ATTR_FLOATS,
                    "floats": [float(v) for v in value]}
        if all(isinstance(v, str) for v in value):
            return {"name": name, "type": ATTR_STRINGS,
                    "strings": [v.encode("utf-8") for v in value]}
    raise ValueError(f"cannot infer attribute type for {name}={value!r}")


def attr_value(a: Dict[str, Any]) -> Any:
    """Extract the python value of a decoded AttributeProto."""
    t = a.get("type")
    if t == ATTR_FLOAT:
        return a.get("f", 0.0)
    if t == ATTR_INT:
        return a.get("i", 0)
    if t == ATTR_STRING:
        return a.get("s", b"").decode("utf-8")
    if t == ATTR_TENSOR:
        return tensor_to_array(a["t"])
    if t == ATTR_FLOATS:
        return list(a.get("floats", []))
    if t == ATTR_INTS:
        return list(a.get("ints", []))
    if t == ATTR_STRINGS:
        return [s.decode("utf-8") for s in a.get("strings", [])]
    raise ValueError(f"unsupported attribute type {t}")


def serialize_model(model: Dict[str, Any]) -> bytes:
    return encode_msg(model, MODEL_PROTO)


def parse_model(data: bytes) -> Dict[str, Any]:
    return decode_msg(data, MODEL_PROTO)
