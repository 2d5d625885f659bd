"""The port's dataset generators (`yololite_tpu_torch/tools/make_*.py`)
beside the JAX package's tools (`tools/make_*.py`, imported by path) on the
same seeds, at small sizes:

  - HardSynth-20 (`make_hard_synth`, boxes and --seg polygons): boxes,
    classes and polygons exactly equal; the canvases before encoding within
    1 level and equal on at least CANVAS_EQUAL_SHARE of the values (the
    blotch map's cubic resize is within 2 ulp of cv2's, so a float
    background may truncate to the next level: ~5e-6 of the values differ
    at bases 160-640);
  - `make_synth_dataset` (plain and --seg_polygons): canvases exactly
    equal; `make_cls_corpus`'s `render_one` as HardSynth's canvases;
  - label files byte-equal; each JPEG within `test_torch_port_imwrite.py`'s
    bounds (PSNR, size) of cv2's file of the same canvas at the tool's
    quality; data.yaml read back equal by `yaml.safe_load` and the port's
    `read_yaml`;
  - `make_crop_corpus`: the same file names and per-class counts as JAX's
    on the same dataset (box rows and polygon rows);
  - all four tools run with cv2, PIL and yaml blocked in `sys.modules`.
"""

import importlib.util
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import yaml

from tests.test_torch_port_imwrite import JPEG_PSNR_DB, JPEG_SIZE_REL, psnr
from yololite_tpu_torch.config import read_yaml
from yololite_tpu_torch.data.codecs import imread_bgr
from yololite_tpu_torch.tools import make_cls_corpus as P_CLS
from yololite_tpu_torch.tools import make_crop_corpus as P_CROP
from yololite_tpu_torch.tools import make_hard_synth as P_HS
from yololite_tpu_torch.tools import make_synth_dataset as P_SD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS_EQUAL_SHARE = 0.999


def _jax_tool(name: str):
    """tools/<name>.py as a module (make_cls_corpus imports make_hard_synth
    from its own directory)."""
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_HS, J_SD, J_CLS, J_CROP = (_jax_tool(n) for n in (
    "make_hard_synth", "make_synth_dataset", "make_cls_corpus", "make_crop_corpus"))


def _run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()


def _assert_canvas_close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    share = float((d == 0).mean())
    assert d.max() <= 1 and share >= CANVAS_EQUAL_SHARE, (what, int(d.max()), share)


def _assert_jpeg_like_cv2(path, rgb, quality, ref_path):
    """The port's JPEG of the RGB canvas against cv2.imwrite's file of the
    same canvas at `quality`: decodes alike in cv2 and the port, PSNR and
    size within test_torch_port_imwrite.py's bounds."""
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    got = cv2.imread(path)
    np.testing.assert_array_equal(imread_bgr(path), got)
    assert cv2.imwrite(ref_path, bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
    want = cv2.imread(ref_path)
    assert abs(psnr(got, bgr) - psnr(want, bgr)) <= JPEG_PSNR_DB, path
    size, ref = os.path.getsize(path), os.path.getsize(ref_path)
    assert abs(size - ref) <= JPEG_SIZE_REL * ref, (path, size, ref)


def _capture(monkeypatch, module, name="write_jpeg"):
    """Record (path, RGB canvas) of each image a port tool writes."""
    seen = {}
    real = getattr(module, name)
    if name == "write_jpeg":
        def write(path, rgb, quality=90):
            seen[path] = (np.array(rgb), quality)
            real(path, rgb, quality)
    else:                                           # imwrite_bgr: BGR, q95
        def write(path, bgr):
            seen[path] = (np.array(bgr)[..., ::-1], 95)
            real(path, bgr)
    monkeypatch.setattr(module, name, write)
    return seen


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), root)] = os.path.join(d, n)
    return out


def _same_labels(a_root, b_root):
    a, b = _files(a_root), _files(b_root)
    assert sorted(a) == sorted(b)
    for rel in a:
        if rel.endswith(".txt"):
            with open(a[rel], "rb") as fa, open(b[rel], "rb") as fb:
                assert fa.read() == fb.read(), rel


def _same_data_yaml(port_out, jax_out):
    with open(os.path.join(port_out, "data.yaml")) as f:
        port = yaml.safe_load(f)
    with open(os.path.join(jax_out, "data.yaml")) as f:
        want = yaml.safe_load(f)
    assert read_yaml(os.path.join(port_out, "data.yaml")) == port
    assert port == {k: (v.replace(jax_out, port_out) if isinstance(v, str) else v)
                    for k, v in want.items()}


@pytest.mark.parametrize("seg", [False, True], ids=["boxes", "seg"])
@pytest.mark.parametrize("base,n,seed", [(160, 4, 7), (320, 3, 8), (640, 2, 7)])
def test_hard_synth_images_match_jax(base, n, seed, seg):
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    for i in range(n):
        img_j, boxes_j, labels_j, polys_j = J_HS.make_image(rj, base, seg=seg)
        img_p, boxes_p, labels_p, polys_p = P_HS.make_image(rp, base, seg=seg)
        np.testing.assert_array_equal(boxes_p, boxes_j)
        np.testing.assert_array_equal(labels_p, labels_j)
        if seg:
            assert len(polys_p) == len(polys_j)
            for a, b in zip(polys_p, polys_j):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        else:
            assert polys_p is None and polys_j is None
        _assert_canvas_close(img_p, img_j, f"base {base} image {i}")


@pytest.mark.parametrize("seg", [False, True], ids=["boxes", "seg"])
def test_hard_synth_files_match_jax(tmp_path, monkeypatch, capsys, seg):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--n_train", "3", "--n_val", "2", "--base", "160", "--seed", "11"] + \
        (["--seg"] if seg else [])
    _run_jax_main(J_HS, ["--out", jax_out] + argv, monkeypatch)
    jax_printed = capsys.readouterr().out
    seen = _capture(monkeypatch, P_HS)
    P_HS.main(["--out", port_out] + argv)
    assert capsys.readouterr().out == jax_printed
    _same_labels(port_out, jax_out)
    _same_data_yaml(port_out, jax_out)
    assert len(seen) == 5
    for path, (rgb, quality) in seen.items():
        assert quality == 92
        _assert_jpeg_like_cv2(path, rgb, quality, str(tmp_path / "ref.jpg"))


@pytest.mark.parametrize("seg", [False, True], ids=["boxes", "seg_polygons"])
def test_synth_dataset_matches_jax(tmp_path, monkeypatch, capsys, seg):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--n_train", "6", "--n_val", "2", "--img", "160", "--seed", "3"] + \
        (["--seg_polygons"] if seg else [])
    canvases = {}
    real = cv2.imwrite

    def jax_write(path, bgr, *a):
        canvases[path.replace(jax_out, port_out)] = bgr[..., ::-1].copy()
        return real(path, bgr, *a)
    monkeypatch.setattr(cv2, "imwrite", jax_write)
    _run_jax_main(J_SD, ["--out", jax_out] + argv, monkeypatch)
    monkeypatch.setattr(cv2, "imwrite", real)
    capsys.readouterr()
    seen = _capture(monkeypatch, P_SD)
    assert P_SD.main(["--out", port_out] + argv) == os.path.join(port_out, "data.yaml")
    assert capsys.readouterr().out.strip() == os.path.join(port_out, "data.yaml")
    _same_labels(port_out, jax_out)
    _same_data_yaml(port_out, jax_out)
    assert sorted(seen) == sorted(canvases)
    for path, (rgb, quality) in seen.items():
        np.testing.assert_array_equal(rgb, canvases[path])
        assert quality == 95
        _assert_jpeg_like_cv2(path, rgb, quality, str(tmp_path / "ref.jpg"))


def test_cls_corpus_matches_jax(tmp_path, monkeypatch):
    rj, rp = np.random.RandomState(77), np.random.RandomState(77)
    for cls_id in range(len(P_HS.CLASSES)):
        _assert_canvas_close(P_CLS.render_one(rp, cls_id, 96), J_CLS.render_one(rj, cls_id, 96),
                             f"class {cls_id}")
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--per_class", "1", "--val_per_class", "1", "--img", "64", "--seed", "5"]
    _run_jax_main(J_CLS, ["--out", jax_out] + argv, monkeypatch)
    seen = _capture(monkeypatch, P_CLS, "imwrite_bgr")
    assert P_CLS.main(["--out", port_out] + argv) == port_out
    assert sorted(_files(port_out)) == sorted(_files(jax_out))
    assert len(seen) == 2 * len(P_HS.CLASSES)
    for path, (rgb, quality) in list(seen.items())[::5]:
        _assert_jpeg_like_cv2(path, rgb, quality, str(tmp_path / "ref.jpg"))


@pytest.mark.parametrize("seg", [False, True], ids=["boxes", "polygons"])
def test_crop_corpus_matches_jax(tmp_path, monkeypatch, capsys, seg):
    data = str(tmp_path / "data")
    P_HS.main(["--out", data, "--n_train", "3", "--n_val", "2", "--base", "160",
               "--seed", "13"] + (["--seg"] if seg else []))
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--data", data, "--min_px", "12", "--max_per_class", "3"]
    capsys.readouterr()
    _run_jax_main(J_CROP, ["--out", jax_out] + argv, monkeypatch)
    jax_printed = capsys.readouterr().out
    counts = P_CROP.main(["--out", port_out] + argv)
    assert capsys.readouterr().out == jax_printed
    assert sorted(_files(port_out)) == sorted(_files(jax_out))
    assert sum(int(c.sum()) for c in counts.values()) == len(_files(port_out)) > 0
    for rel, path in _files(port_out).items():
        want = cv2.imread(os.path.join(jax_out, rel))
        assert imread_bgr(path).shape == want.shape, rel


def test_tools_run_without_cv2_or_yaml(tmp_path):
    """The four tools end to end in a process where importing cv2, PIL or
    yaml fails, as on the card's machine."""
    out = str(tmp_path)
    code = f"""
import sys
for name in ("cv2", "PIL", "yaml"):
    sys.modules[name] = None
from yololite_tpu_torch.tools import (make_cls_corpus, make_crop_corpus, make_hard_synth,
                                      make_synth_dataset)
make_hard_synth.main(["--out", "{out}/hs", "--n_train", "2", "--n_val", "1", "--base", "96"])
make_synth_dataset.main(["--out", "{out}/sd", "--n_train", "2", "--n_val", "1", "--img", "64",
                         "--seg_polygons"])
make_cls_corpus.main(["--out", "{out}/cls", "--per_class", "1", "--val_per_class", "0",
                      "--img", "48"])
counts = make_crop_corpus.main(["--data", "{out}/hs", "--out", "{out}/crops"])
assert sum(int(c.sum()) for c in counts.values()) > 0
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-2000:]
    assert len(_files(os.path.join(out, "cls"))) == len(P_HS.CLASSES)
