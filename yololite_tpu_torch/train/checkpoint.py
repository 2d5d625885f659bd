"""Read the JAX package's checkpoints (port of `train/checkpoint.py`, loading).

A checkpoint is one msgpack file, as flax's `msgpack_serialize` writes it:
    {"state_dict": {"params": {...}, "batch_stats": {...}[, ...]},
     "meta_json": "<json of the meta dict>"}
with every array stored as msgpack ext type 1 whose payload is itself a
msgpack array (shape, dtype name, raw C-order bytes); numpy scalars are ext
type 3 with the same payload. This module carries its own decoder for that
subset of msgpack (nil, bool, int, float, str, bin, array, map, ext/fixext),
so it needs neither flax nor the msgpack package. Saving waits for the
training slice.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        simple = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in simple:
            return self.unpack(simple[t])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}            # bin
        if t in sizes:
            return bytes(self.take(self.unpack(sizes[t])))
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}            # str
        if t in sizes:
            return str(self.take(self.unpack(sizes[t])), "utf-8")
        if t in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.unpack(">b")
            return _ext(code, self.take(fixext[t]))
        sizes = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}            # ext
        if t in sizes:
            n = self.unpack(sizes[t])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ext(code: int, payload: memoryview) -> Any:
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, raw = unpackb(bytes(payload))
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()
    return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the subset flax writes)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after msgpack object")
    return out


def _check_not_chunked(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked (>1 GiB) arrays are not supported")
        for v in tree.values():
            _check_not_chunked(v)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (state_dict, meta): nested dicts of numpy arrays, and the meta
    dict (names, num_classes, img_size, arch, backbone, config, ...)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    _check_not_chunked(payload["state_dict"])
    return payload["state_dict"], json.loads(payload["meta_json"])


def model_from_meta(meta: Dict[str, Any], **overrides):
    """Rebuild the detector from checkpoint meta."""
    from yololite_tpu_torch.models.detector import build_model_from_config
    cfg = dict(meta.get("config") or {})
    cfg["model"] = dict(cfg.get("model") or {})
    cfg["model"].setdefault("arch", meta.get("arch", "YOLOLiteMS"))
    cfg["model"].setdefault("backbone", meta.get("backbone", "resnet18"))
    cfg["model"].setdefault("num_classes", meta.get("num_classes", 3))
    cfg["training"] = dict(cfg.get("training") or {})
    cfg["training"].setdefault("img_size", meta.get("img_size", 640))
    return build_model_from_config(cfg, **overrides)
