"""Configs: the port's own YAML reader and writer, the 3-way merge of model,
train and data yamls, run directories, and model-name resolution.

Port of `yololite_tpu/config/config.py` (`load_configs`, `save_merged_config`,
`next_run_dir`, `update_latest_pointer`, `deep_merge`) and of the name
resolution of `yololite_tpu/api.py`. The card's machine has no PyYAML, so
`read_yaml` parses the subset of YAML that `configs/` and a dataset's
`data.yaml` use: block mappings nested by indentation, block sequences of
scalars (`- a`), flow sequences of scalars (`[320, 416]`), the empty flow
collections `[]` and `{}`, plain and quoted scalars, empty values, and
comments. Plain scalars resolve as PyYAML's `safe_load` resolves them (YAML
1.1: `yes`/`off` are booleans, `1.0e-3` is a float but `1e-3` a string).
Anything else (nested or mapping items in sequences, non-empty flow
mappings, anchors, tags, block scalars, multi-line scalars, octal or
sexagesimal numbers, timestamps) raises `ValueError`. `dump_yaml` writes a
config so that both `read_yaml` and `yaml.safe_load` read it back equal.
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

from yololite_tpu_torch.data.coco_ingest import coco_to_yolo_labels

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
    quote, i = None, 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote == "'" and line[i + 1:i + 2] == "'":
                i += 1                    # '' escapes a quote inside '...'
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :[,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
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


def _split_flow(inner: str, where: str) -> List[str]:
    """Items of a flow sequence's inside, split at commas outside quotes."""
    items, cur, i = [], "", 0
    while i < len(inner):
        ch = inner[i]
        if ch in "'\"" and not cur.strip():         # a quoted item, '' escapes
            k = i
            while True:
                k = inner.find(ch, k + 1)
                if k < 0:
                    raise ValueError(f"{where}: unterminated quote in {inner!r}")
                if ch == "'" and inner[k + 1:k + 2] == "'":
                    k += 1
                    continue
                break
            cur += inner[i:k + 1]
            i = k + 1
            continue
        if ch == ",":
            items.append(cur.strip())
            cur = ""
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested flow collections are not supported")
        else:
            cur += ch
        i += 1
    items.append(cur.strip())
    if items[-1] == "" and len(items) > 1:      # a trailing comma
        items.pop()
    if any(i == "" for i in items):
        raise ValueError(f"{where}: empty flow sequence item in {inner!r}")
    return items


def _value(text: str, where: str) -> Any:
    """A value after `key:` or `- `: a scalar, a flow sequence of scalars,
    or an empty flow collection."""
    if text == "{}":
        return {}
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unsupported YAML syntax {text!r}")
        inner = text[1:-1].strip()
        return [] if not inner else [_scalar(i, where) for i in _split_flow(inner, where)]
    return _scalar(text, where)


def parse_yaml(text: str, name: str = "<string>") -> Optional[Dict[str, Any]]:
    """Parse the YAML subset described in the module docstring. Returns None
    for a document with no content, as `yaml.safe_load` does."""
    root: Dict[str, Any] = {}
    stack = [[None, root]]      # [indent of the mapping's keys, mapping]
    pending = None              # (mapping, key, indent) of a `key:` line
    seq = None                  # (list, indent) of the open block sequence
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body[0] == "\t" or body.startswith(("---", "...")) and indent == 0:
            raise ValueError(f"{where}: unsupported YAML syntax {body!r}")
        item = body == "-" or body.startswith("- ")
        if pending is not None:
            mapping, key, key_indent = pending
            pending = None
            if item and indent >= key_indent:
                mapping[key] = []
                seq = (mapping[key], indent)
            elif indent > key_indent:
                mapping[key] = {}
                stack.append([indent, mapping[key]])
        if seq is not None:
            if item and indent == seq[1]:
                rest = body[1:].strip()
                if not rest or rest == "-" or rest.startswith("- ") or _KEY.match(rest):
                    raise ValueError(f"{where}: only scalar sequence items are supported")
                seq[0].append(_value(rest, where))
                continue
            seq = None
        if item:
            raise ValueError(f"{where}: a sequence item outside a sequence")
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
            mapping[key] = _value(m.group(2), where)
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


# --------------------------------------------------------------------------- #
# Writer
# --------------------------------------------------------------------------- #

def _emit_scalar(v: Any) -> str:
    """One scalar that `_scalar` and `yaml.safe_load` both read back equal."""
    if v is None:
        return "null"
    if v is True or v is False:
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        # PyYAML reads `1e-05` as a string: it needs a dot in the mantissa
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(v, str):
        if "\n" in v or "\r" in v or "\t" in v:
            raise ValueError(f"cannot write a multi-line string {v!r}")
        try:
            plain_ok = (v == v.strip() and v != "" and "#" not in v and "," not in v
                        and _scalar(v, "<dump>") == v)
        except ValueError:
            plain_ok = False
        return v if plain_ok else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def _emit(obj: Dict[str, Any], indent: int, out: List[str]) -> None:
    pad = " " * indent
    for k, v in obj.items():
        key = _emit_scalar(k)
        if isinstance(v, dict) and v:
            out.append(f"{pad}{key}:")
            _emit(v, indent + 2, out)
        elif isinstance(v, dict):
            out.append(f"{pad}{key}: {{}}")
        elif isinstance(v, (list, tuple)):
            if any(isinstance(i, (dict, list, tuple)) for i in v):
                raise ValueError(f"{k}: only sequences of scalars can be written")
            out.append(f"{pad}{key}: [{', '.join(_emit_scalar(i) for i in v)}]")
        else:
            out.append(f"{pad}{key}: {_emit_scalar(v)}")


def dump_yaml(config: Dict[str, Any]) -> str:
    """A nested dict of scalars and scalar lists -> YAML text (block mappings,
    flow sequences) that `read_yaml` and `yaml.safe_load` read back equal."""
    out: List[str] = []
    _emit(config, 0, out)
    return "\n".join(out) + "\n"


# --------------------------------------------------------------------------- #
# Runs and the 3-way merge
# --------------------------------------------------------------------------- #

def next_run_dir(base: str) -> str:
    """Create and return the next free numeric run dir under ``base``
    ('runs' -> 'runs/1', 'runs/2', ...; mkdir is the atomicity guard)."""
    root = Path(base)
    root.mkdir(parents=True, exist_ok=True)
    n = 1
    while True:
        cand = root / str(n)
        try:
            cand.mkdir(parents=False, exist_ok=False)
            return str(cand.resolve())
        except FileExistsError:
            n += 1


def update_latest_pointer(parent: str, target: str) -> None:
    """Maintain a 'latest' symlink (or a latest.txt fallback) next to the runs."""
    parent_p = Path(parent)
    latest = parent_p / "latest"
    try:
        if latest.exists() or latest.is_symlink():
            latest.unlink()
        latest.symlink_to(Path(target), target_is_directory=True)
    except OSError:
        (parent_p / "latest.txt").write_text(str(Path(target)), encoding="utf-8")


def _norm(p: Optional[str]) -> Optional[str]:
    return str(Path(p).expanduser().resolve()) if p else p


def _abs_from_yaml_dir(raw: str, data_yaml: str) -> str:
    if not raw:
        return ""
    yaml_dir = Path(data_yaml).expanduser().resolve().parent
    p = Path(str(raw).replace("\\", "/")).expanduser()
    return str(p.resolve() if p.is_absolute() else (yaml_dir / p).resolve())


def _fallback_split_dir(split: str, data_yaml: str, kind: str) -> Optional[str]:
    """Try <yaml_dir>/<split>/<kind>; 'val' also tries 'valid'."""
    base = Path(data_yaml).expanduser().resolve().parent
    names = ["val", "valid"] if split == "val" else [split]
    for c in (base / n / kind for n in names):
        if c.exists():
            return str(c.resolve())
    return None


def _ensure_or_fallback(img_path: str, split: str, data_yaml: str) -> str:
    if img_path and Path(img_path).exists():
        return img_path
    return _fallback_split_dir(split, data_yaml, "images") or img_path


def _labels_or_fallback(lbl_path: str, img_path: str, split: str, data_yaml: str) -> str:
    if lbl_path and Path(lbl_path).exists():
        return lbl_path
    fb = _fallback_split_dir(split, data_yaml, "labels")
    if fb:
        return fb
    if img_path:
        parts = Path(img_path).parts
        if parts and parts[-1].lower() == "images":
            return str(Path(*parts[:-1], "labels"))
        return str((Path(img_path).parent / "labels").resolve())
    return ""


def load_configs(model_yaml: Optional[str], train_yaml: Optional[str],
                 data_yaml: Optional[str], make_run_dir: bool = True) -> Dict[str, Any]:
    """Merge model/train/data YAMLs into one config dict, as the JAX package.

    Precedence (later wins): dataset block < model.yaml < train.yaml. Adds
    `config["dataset"]` with resolved image/label dirs (with the
    `<yaml_dir>/<split>/{images,labels}` and valid<->val fallbacks) and class
    names, infers `model.num_classes` from `nc`/`names`, defaults
    `training.img_size` to 640, and (optionally) allocates
    `config["logging"]["log_dir"] = <base>/<n>`."""
    model_yaml = _norm(model_yaml) if model_yaml else None
    train_yaml = _norm(train_yaml) if train_yaml else None
    data_yaml = _norm(data_yaml) if data_yaml else None
    model_cfg = read_yaml(model_yaml) if model_yaml else {}
    train_cfg = read_yaml(train_yaml) if train_yaml else {}
    data_cfg = read_yaml(data_yaml) if data_yaml else {}
    config: Dict[str, Any] = {}

    if data_yaml:
        split_img = {s: _ensure_or_fallback(_abs_from_yaml_dir(data_cfg.get(s, ""), data_yaml),
                                            s, data_yaml) for s in ("train", "val", "test")}
        labels_cfg = data_cfg.get("labels") if isinstance(data_cfg.get("labels"), dict) else {}
        given_lbl = {s: _abs_from_yaml_dir(labels_cfg.get(s, ""), data_yaml)
                     if labels_cfg.get(s) else "" for s in ("train", "val", "test")}
        # COCO-json: train_json/val_json/test_json are converted (mtime-cached)
        # to YOLO-txt dirs, which win over the label-dir fallbacks
        coco_names = None
        for split in ("train", "val", "test"):
            jp = data_cfg.get(f"{split}_json")
            if jp:
                given_lbl[split], coco_names = coco_to_yolo_labels(
                    _abs_from_yaml_dir(jp, data_yaml))
        if coco_names and not data_cfg.get("names"):
            data_cfg["names"] = coco_names
        split_lbl = {s: _labels_or_fallback(given_lbl[s], split_img[s], s, data_yaml)
                     for s in ("train", "val", "test")}
        for tag, p in [("train_images", split_img["train"]), ("val_images", split_img["val"]),
                       ("train_labels", split_lbl["train"]), ("val_labels", split_lbl["val"])]:
            if p and not Path(p).exists():
                raise FileNotFoundError(f"{tag} path not found: {p}")
        if split_img["test"] and not Path(split_img["test"]).exists():
            raise FileNotFoundError(f"test_images path not found: {split_img['test']}")
        names = data_cfg.get("names")
        if names is not None and not isinstance(names, (list, tuple)):
            raise ValueError("data.yaml 'names' must be a list of class names.")
        nc = data_cfg.get("nc", len(names) if names else None)
        if nc is None:
            raise ValueError("Unable to infer 'nc'. Set 'nc' or provide 'names' in data.yaml.")
        config["dataset"] = {
            "train_images": split_img["train"],
            "val_images": split_img["val"],
            "train_labels": split_lbl["train"],
            "val_labels": split_lbl["val"],
            **({"test_images": split_img["test"]} if split_img["test"] else {}),
            **({"test_labels": split_lbl["test"]} if split_lbl["test"] else {}),
            "names": list(names) if names else [str(i) for i in range(int(nc))],
        }
        model_block = model_cfg.setdefault("model", {})
        if model_block.get("num_classes") is None:
            model_block["num_classes"] = int(nc)

    train_cfg.setdefault("training", {})
    if "img_size" not in train_cfg["training"]:
        ds_img = (model_cfg.get("dataset", {}) or {}).get("img_size") or \
                 (train_cfg.get("dataset", {}) or {}).get("img_size")
        train_cfg["training"]["img_size"] = int(ds_img) if ds_img else 640

    deep_merge(config, model_cfg)
    deep_merge(config, train_cfg)

    base_log_dir = (config.get("logging", {}) or {}).get("log_dir") or "runs"
    if make_run_dir:
        run_dir = next_run_dir(base_log_dir)
        config["logging"] = {"log_dir": run_dir}
        update_latest_pointer(parent=str(Path(run_dir).parent), target=run_dir)
    else:
        config.setdefault("logging", {})["log_dir"] = str(base_log_dir)
    return config


def save_merged_config(config: Dict[str, Any], run_dir: Optional[str] = None) -> str:
    """Write the merged config as `<run_dir>/merged_config.yaml`."""
    run_dir = run_dir or config.get("logging", {}).get("log_dir", ".")
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "merged_config.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(dump_yaml(config))
    return path
