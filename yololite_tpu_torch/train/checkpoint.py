"""Read and write the JAX package's checkpoints (port of `train/checkpoint.py`).

A checkpoint is one msgpack file, as flax's `msgpack_serialize` writes it:
    {"state_dict": {"params": {...}, "batch_stats": {...}[, ...]},
     "meta_json": "<json of the meta dict>"}
with every array stored as msgpack ext type 1 whose payload is itself a
msgpack array (shape, dtype name, raw C-order bytes); numpy scalars are ext
type 3 with the same payload. This module carries its own decoder and
encoder for that subset of msgpack (nil, bool, int, float, str, bin, array,
map, ext/fixext), so it needs neither flax nor the msgpack package; the
encoder writes what `msgpack.packb` writes for the same tree (smallest
integer and container forms, float64, bin for bytes).

A checkpoint saved with `save_optimizer: true` also holds `raw_params`,
`raw_batch_stats`, `ema_params`, `ema_batch_stats`, `updates`, `micro` and
`opt_state` in optax's chain layout, so either package restores the other's
full training state.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

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


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack(">B", n)
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < hi:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= lo:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} out of msgpack range")


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes) -> bytes:
    """Header of a str/bin/array/map of length n: fix form, then 8/16/32-bit."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, hi in codes:
        if code is not None and n < hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


_STR = (0xA0, 31, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32)))
_BIN = (None, 0, ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32)))
_ARR = (0x90, 15, ((None, "", 0), (0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32)))
_MAP = (0x80, 15, ((None, "", 0), (0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32)))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext_bytes(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in _FIXEXT:
        head = bytes([_FIXEXT[n]])
    else:
        head = _pack_len(n, None, 0, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                                      (0xC9, ">I", 1 << 32)))
    return head + struct.pack(">b", code) + payload


def packb(obj: Any) -> bytes:
    """Encode one object as flax's `msgpack_serialize` does (byte for byte:
    dict keys sorted): dicts, lists and tuples, str, bytes, bool, None, int, float, numpy arrays (ext 1) and
    numpy scalars (ext 3, packed as 0-d arrays). Torch tensors are arrays."""
    out = bytearray()

    def enc(x):
        if x is None:
            out.append(0xC0)
        elif x is True or x is False:
            out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int) and not isinstance(x, np.integer):
            out.extend(_pack_int(x))
        elif isinstance(x, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", x))
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            out.extend(_pack_len(len(raw), *_STR[:2], _STR[2]) + raw)
        elif isinstance(x, (bytes, bytearray)):
            out.extend(_pack_len(len(x), *_BIN[:2], _BIN[2]) + bytes(x))
        elif isinstance(x, dict):
            out.extend(_pack_len(len(x), *_MAP[:2], _MAP[2]))
            # flax rebuilds every dict through jax.tree_util, which sorts keys
            for k, v in sorted(x.items(), key=lambda kv: kv[0]):
                enc(k)
                enc(v)
        elif isinstance(x, (list, tuple)):
            out.extend(_pack_len(len(x), *_ARR[:2], _ARR[2]))
            for v in x:
                enc(v)
        elif isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "detach"):
            code = _EXT_NPSCALAR if isinstance(x, np.generic) else _EXT_NDARRAY
            arr = _numpy(x)
            payload = packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))
            out.extend(_ext_bytes(code, payload))
        else:
            raise TypeError(f"cannot msgpack {type(x).__name__}")

    enc(obj)
    return bytes(out)


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):          # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, params, batch_stats, meta: Dict[str, Any],
                    extra_state: Optional[Dict[str, Any]] = None) -> str:
    """Write {"state_dict": {params, batch_stats[, extra]}, "meta_json"} as
    one msgpack file (atomically: a temp file, then a rename). Trees are
    nested dicts of numpy arrays (or tensors), in flax's layout."""
    state = {"params": params, "batch_stats": batch_stats}
    if extra_state:
        state.update(extra_state)
    blob = packb({"state_dict": state, "meta_json": json.dumps(meta, default=str)})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path


def build_meta(config: Dict[str, Any], metrics: Dict[str, float], metric_key: str,
               class_names, num_anchors_per_level) -> Dict[str, Any]:
    """The self-description every tool rebuilds the model from."""
    return {
        "metric_key": metric_key,
        "metric_value": float(metrics.get(metric_key, -1.0)),
        "names": list(class_names) if class_names else None,
        "num_classes": int(config["model"]["num_classes"]),
        "img_size": int(config["training"].get("img_size", 640)),
        "arch": config["model"].get("arch", "YOLOLiteMS"),
        "backbone": config["model"].get("backbone", "resnet18"),
        "num_anchors_per_level": list(num_anchors_per_level),
        "config": config,
        "framework": "yololite_tpu",
    }


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
