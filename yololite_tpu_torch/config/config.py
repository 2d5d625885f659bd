"""Model configs: the port's own YAML reader, deep merge and name resolution.

Port of the parts of `yololite_tpu/config/config.py` and `yololite_tpu/api.py`
that building a model needs. The card's machine has no PyYAML, so
`read_yaml` parses the subset of YAML that `configs/models`,
`configs/v2_models` and `configs/custom` use: block mappings nested by
indentation, plain and quoted scalars, and comments. Plain scalars resolve
as PyYAML's `safe_load` resolves them (YAML 1.1: `yes`/`off` are booleans,
`1.0e-3` is a float but `1e-3` a string). Anything else (sequences, flow
collections, anchors, tags, block scalars, multi-line scalars, octal or
sexagesimal numbers, timestamps) raises `ValueError`.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# where a bare model name is looked up, in this order (as yololite_tpu/api.py)
MODEL_DIRS = ("models", "v2_models", "custom")

_NULL = {"~", "null", "Null", "NULL"}
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                 "off", "Off", "OFF")})
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# implicit types of YAML 1.1 outside the subset: binary, octal, hex and
# sexagesimal numbers, timestamps, the merge key and the value key
_UNSUPPORTED = re.compile(r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                          r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                          r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_INDICATORS = set("[]{}&*!|>%@`,?")
_KEY = re.compile(r"([^\s'\"#:\-\[\]{}&*!|>%@`,?][^:]*?|-[^\s:][^:]*?)[ ]*:(?:[ ]+(.*))?$")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str) -> Any:
    """A plain or quoted scalar, resolved as PyYAML's safe_load does."""
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'" or "'" in text[1:-1].replace("''", ""):
            raise ValueError(f"{where}: unsupported single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[0] == '"':
        if len(text) < 2 or text[-1] != '"' or '"' in text[1:-1] or "\\" in text:
            raise ValueError(f"{where}: unsupported double-quoted scalar {text!r}")
        return text[1:-1]
    if (text[0] in _INDICATORS or text.startswith("- ") or text == "-"
            or ": " in text or text.endswith(":") or "\t" in text):
        raise ValueError(f"{where}: unsupported YAML syntax {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.lstrip("+-") == ".inf":
            return -math.inf if v[0] == "-" else math.inf
        return math.nan if v == ".nan" else float(v)
    if _UNSUPPORTED.match(text):
        raise ValueError(f"{where}: unsupported YAML 1.1 scalar {text!r}")
    return text


def parse_yaml(text: str, name: str = "<string>") -> Optional[Dict[str, Any]]:
    """Parse the YAML subset described in the module docstring. Returns None
    for a document with no content, as `yaml.safe_load` does."""
    root: Dict[str, Any] = {}
    stack = [[None, root]]      # [indent of the mapping's keys, mapping]
    pending = None              # (mapping, key, indent) of a `key:` line
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body[0] == "\t" or body.startswith(("---", "...")) and indent == 0:
            raise ValueError(f"{where}: unsupported YAML syntax {body!r}")
        if pending is not None:
            mapping, key, key_indent = pending
            pending = None
            if indent > key_indent:
                mapping[key] = {}
                stack.append([indent, mapping[key]])
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if stack[-1][0] is None:
            stack[-1][0] = indent
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: bad indentation")
        m = _KEY.match(body)
        if m is None:
            raise ValueError(f"{where}: unsupported YAML syntax {body!r}")
        key = _scalar(m.group(1), where)
        mapping = stack[-1][1]
        if m.group(2):
            mapping[key] = _scalar(m.group(2), where)
        else:
            mapping[key] = None
            pending = (mapping, key, indent)
    return root if stack[0][0] is not None else None


def read_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return parse_yaml(f.read(), path) or {}


def deep_merge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``b`` into ``a`` (b wins), returning ``a``."""
    for k, v in (b or {}).items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            deep_merge(a[k], v)
        else:
            a[k] = v
    return a


def resolve_model_arg(model: str) -> Dict[str, str]:
    """A model argument -> {'ckpt': path} or {'model_yaml': path}: an existing
    checkpoint or yaml path, else a bare name looked up under configs/models,
    then v2_models, then custom (so `yololite_n` is the models/ one; the v2
    configs are reached by path)."""
    if model.endswith((".ckpt", ".pt", ".msgpack")) and os.path.exists(model):
        return {"ckpt": model}
    if model.endswith((".yaml", ".yml")) and os.path.exists(model):
        return {"model_yaml": model}
    name = model.replace(".yaml", "")
    for sub in MODEL_DIRS:
        cand = os.path.join(REPO_ROOT, "configs", sub, f"{name}.yaml")
        if os.path.exists(cand):
            return {"model_yaml": cand}
    raise FileNotFoundError(
        f"Cannot resolve model {model!r}: not a checkpoint, yaml, or known "
        f"model name under configs/.")
