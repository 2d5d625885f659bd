"""The port's command-line tools (`yololite_tpu_torch/tools/`) and the
training CLI's argparser and overrides, against the JAX package's CLIs
(`tools/*.py`, run through `runpy` with `sys.argv` set) on one checkpoint
written by the JAX package (edge_n at 64 px, randomized BatchNorm, obj/cls
head kernels scaled by 100 so that scores spread over 0.01-0.16) and one
PNG set of `chip_smoke.make_synth_set` at 80x60 (8 train / 4 val).

Both packages serve bf16 by default; where detections are compared, both
Predictors are made fp32 (the port's through the `Predictor` name its tools
look up, JAX's through
`yololite_tpu.deploy.predictor.Predictor`, which its CLIs import at call
time), and the checkpoint's recipe has `amp: false`, so that evaluate's
Trainer runs fp32 in both packages. Frames of 80x60 are letterboxed at 80,
which only pads, so both packages see the same pixels.

Tolerances and their reasons:
  - merged configs: equal, except `training.device` (JAX names TPUs);
  - evaluate, on the val images labelled with the fp32 detections (COCO
    stats far from 0): fp32 within 1e-6 (the same detections up to fp32
    rounding); int8 within 1e-2 (one-level rounding flips between the
    packages, < 1e-3 of the values in test_torch_port_quant.py, can reorder
    near-tied scores of this random model);
  - infer: the same detections one to one, classes equal, boxes within
    1e-3 px and scores within 1e-5 (fp32 forward rounding, as
    test_torch_port_stream.py);
  - export -> infer_exported: the port's ONNX "decoded" file against JAX's
    of the same checkpoint, both through the port's CLI: 1e-3 (the ONNX
    bound of test_torch_port_onnx.py); the `.pt2` "nms" artifact against
    the fp32 Predictor: equal classes, 1e-3;
  - tracker: frames 48x64: track ids and classes equal, boxes within 1e-2
    px (as test_torch_port_stream.py).
"""

import functools
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from yololite_tpu.config import apply_overrides as jax_apply_overrides
from yololite_tpu.config import build_argparser as jax_build_argparser
from yololite_tpu.config import load_configs as jax_load_configs
from yololite_tpu.deploy import predictor as jax_predictor
from yololite_tpu.eval import evaluate as jax_evaluate
from yololite_tpu.track import KalmanSortTracker as JaxTracker
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint
from yololite_tpu.utils.viz import draw_detections

import chip_smoke
from tests.test_torch_port_export import one_torch_thread  # noqa: F401 fixture
from tests.test_torch_port_models import edge_cfg, jax_edge
from yololite_tpu_torch.config import (
    apply_overrides, build_argparser, load_configs, read_yaml,
)
from yololite_tpu_torch.data.codecs import UnsupportedImage
from yololite_tpu_torch.data.video import UnsupportedVideo
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.tools import evaluate as evaluate_tool
from yololite_tpu_torch.tools import export as export_tool
from yololite_tpu_torch.tools import infer as infer_tool
from yololite_tpu_torch.tools import infer_exported as infer_exported_tool
from yololite_tpu_torch.tools import tracker as tracker_tool
from yololite_tpu_torch.tools import train as train_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
FRAME_IMG = 80          # 80x60 frames letterboxed at 80 are only padded
HEAD_SCALE = 100.0
NAMES = ["c0", "c1", "c2"]
MODEL = os.path.join(ROOT, "configs", "models", "edge_n.yaml")
RECIPE = os.path.join(ROOT, "configs", "train", "standard_train.yaml")
BACKBONE = os.path.join(ROOT, "weights", "mnv4_050_cls20.ckpt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(data.yaml, checkpoint): the PNG set and the JAX-written checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    data = chip_smoke.make_synth_set(str(root / "synth"), 8, 4, w=80, h=60)
    _, params, bs = jax_edge(IMG)
    params = dict(params)
    for head in ("head3", "head4", "head5"):
        params[head] = dict(params[head])
        for part in ("obj", "cls"):
            params[head][part] = dict(params[head][part],
                                      kernel=params[head][part]["kernel"] * HEAD_SCALE)
    cfg = edge_cfg(IMG)
    cfg["training"]["amp"] = False      # evaluate's Trainer in fp32, as JAX's here
    meta = build_meta(cfg, {}, "AP", NAMES, (1, 1, 1))
    ckpt = save_checkpoint(str(root / "edge_n.ckpt"), params, bs, meta)
    return data, ckpt


@pytest.fixture(scope="module")
def labelled(world, tmp_path_factory):
    """The val images labelled with the fp32 Predictor's three best
    detections each, so that COCO stats are far from 0 and move with
    either package's detections; returns the images folder."""
    data, ckpt = world
    root = tmp_path_factory.mktemp("labelled")
    os.makedirs(root / "images")
    os.makedirs(root / "labels")
    pred = Predictor(ckpt, device="cpu", dtype=torch.float32)
    for name in sorted(os.listdir(_val_dir(data))):
        img = cv2.imread(os.path.join(_val_dir(data), name))
        cv2.imwrite(str(root / "images" / name), img)
        r = pred.infer_image_profiled(img, FRAME_IMG, conf=0.05, iou=0.45)
        h, w = img.shape[:2]
        with open(root / "labels" / (os.path.splitext(name)[0] + ".txt"), "w") as f:
            for (x1, y1, x2, y2), c in zip(r["boxes"][:3], r["classes"][:3]):
                f.write(f"{int(c)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                        f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}\n")
    return str(root / "images")


def _val_dir(data):
    return os.path.join(os.path.dirname(data), "valid", "images")


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py"] + [str(a) for a in argv])
    runpy.run_path(os.path.join(ROOT, "tools", f"{name}.py"), run_name="__main__")


def _fp32(monkeypatch, *tools):
    """fp32 Predictors in the JAX package's CLIs and in these port tools."""
    monkeypatch.setattr(jax_predictor, "Predictor",
                        functools.partial(jax_predictor.Predictor, dtype=jnp.float32))
    for tool in tools:
        monkeypatch.setattr(tool, "Predictor",
                            functools.partial(Predictor, dtype=torch.float32))


# --------------------------------------------------------------------------- #
# The training CLI's argparser and overrides
# --------------------------------------------------------------------------- #

TRAIN_ARGV = ["--epochs", "1", "--batch_size", "4", "--img_size", str(IMG),
              "--workers", "0", "--no-augment", "--pretrained_backbone", BACKBONE,
              "--device", "cpu"]

ARGVS = [
    [],
    TRAIN_ARGV,
    ["--epochs", "3", "--batch_size", "16", "--lr", "0.002", "--save_every", "5"],
    ["--augment", "--use_p6", "--use_p2", "--use_resize"],
    ["--no-augment", "--no-use_p6", "--no-use_p2", "--no-use_resize"],
    ["--resume", "runs/train/1/weights/last_model_state.ckpt", "--start_epoch", "7"],
    ["--save_by", "AP50", "--anchors_per_level", "2"],
    ["--save_by", "APL", "--img_size", "320", "--workers", "2"],
    ["--data_parallel", "1", "--spatial_parallel", "1"],
    ["--data_parallel", "4", "--spatial_parallel", "2", "--device", "cpu"],
    ["--pretrained_backbone", "weights/mnv4_050_cls20.ckpt", "--lr", "1e-4"],
    ["--device", "cpu", "--use_p6", "--no-use_p2", "--save_by", "AR"],
    ["--no-train"],
    ["--save_by", "mAP"],
]


def _merged(build, load, apply, argv, data):
    train = [] if "--no-train" in argv else ["--train", RECIPE]
    argv = [a for a in argv if a != "--no-train"]
    opt = build().parse_args(["--model", MODEL, "--data", data] + train + argv)
    cfg = load(model_yaml=opt.model, train_yaml=opt.train, data_yaml=opt.data,
               make_run_dir=False)
    return apply(cfg, opt)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_argv_parity(world, argv):
    data, _ = world
    if "mAP" in argv:
        for build, load, apply in ((jax_build_argparser, jax_load_configs,
                                    jax_apply_overrides),
                                   (build_argparser, load_configs, apply_overrides)):
            with pytest.raises(ValueError, match="Invalid --save_by"):
                _merged(build, load, apply, argv, data)
        return
    want = _merged(jax_build_argparser, jax_load_configs, jax_apply_overrides, argv, data)
    got = _merged(build_argparser, load_configs, apply_overrides, argv, data)
    if "--device" in argv:
        assert got["training"].pop("device") == want["training"].pop("device") == "cpu"
    assert got == want


def test_argparsers_have_the_same_flags():
    flags = lambda ap: sorted(o for a in ap._actions for o in a.option_strings)
    assert flags(build_argparser()) == flags(jax_build_argparser())
    for flag in ("--epochs", "--device", "--save_by", "--augment", "--lr"):
        assert build_argparser().get_default(flag.lstrip("-")) is None


def test_train_cli_one_epoch(world, tmp_path, monkeypatch):
    data, _ = world
    monkeypatch.chdir(tmp_path)
    results = train_tool.main(["--model", MODEL, "--train", RECIPE, "--data", data]
                              + TRAIN_ARGV)
    log_dir = results["log_dir"]
    assert log_dir == str(tmp_path / "runs" / "train" / "1")
    for name in ("metrics.csv", "eval_results.json", "weights/best_no_aug.ckpt",
                 "weights/last_model_state.ckpt"):
        assert os.path.exists(os.path.join(log_dir, name)), name
    written = read_yaml(os.path.join(log_dir, "merged_config.yaml"))
    assert written.pop("logging") == {"log_dir": log_dir}
    want = _merged(build_argparser, load_configs, apply_overrides, TRAIN_ARGV, data)
    want.pop("logging")
    assert written == want
    assert np.isfinite(results["history"]["train_loss"]).all()


def test_train_cli_rejects_data_parallel(world, tmp_path, monkeypatch):
    """More GPUs than are visible raise, for the data axis and for a data x
    spatial mesh, as JAX's make_mesh refuses one (both axes train:
    test_torch_port_ddp_loop.py, test_torch_port_spatial.py)."""
    data, _ = world
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="CUDA devices"):
        train_tool.main(["--model", MODEL, "--data", data, "--data_parallel",
                         str(torch.cuda.device_count() + 2), "--device", "cuda"])
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=f"mesh 1x{n} needs {n} devices.*CUDA devices"):
        train_tool.main(["--model", MODEL, "--data", data, "--spatial_parallel", str(n),
                         "--device", "cuda"])


def test_clis_fail_without_a_card(world, tmp_path, monkeypatch):
    """--device cuda (the default) with no card raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data, ckpt = world
    monkeypatch.chdir(tmp_path)
    frame = os.path.join(_val_dir(data), "0000.png")
    pattern = _write_sequence(str(tmp_path / "seq"), range(2))
    for main, argv in (
            (train_tool.main, ["--model", MODEL, "--data", data, "--epochs", "1"]),
            (evaluate_tool.main, ["--weights", ckpt, "--test_folder", _val_dir(data)]),
            (infer_tool.main, ["--weights", ckpt, "--img", frame]),
            (export_tool.main, ["--weights", ckpt, "--out_dir", str(tmp_path)]),
            (tracker_tool.main, ["--weights", ckpt, "--video", pattern])):
        with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
            main(argv)


# --------------------------------------------------------------------------- #
# evaluate
# --------------------------------------------------------------------------- #

COCO_TOL, COCO_TOL_INT8 = 1e-6, 1e-2


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_evaluate_matches_jax(world, labelled, tmp_path, monkeypatch, capsys, quantize):
    _, ckpt = world
    _fp32(monkeypatch, evaluate_tool)
    # JAX's latency bench compiles a forward of its own; its number is
    # never compared
    monkeypatch.setattr(jax_evaluate, "bench_forward_ms_per_img",
                        lambda *a, **kw: 0.0)
    argv = ["--weights", ckpt, "--test_folder", labelled, "--batch_size", "4",
            "--img_size", str(FRAME_IMG)]
    argv += ["--quantize", quantize] if quantize else []
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    _run_jax_tool("evaluate", argv, monkeypatch)
    jax_out = capsys.readouterr().out
    with open(tmp_path / "jax" / "runs" / "evaluate" / "1" / "eval_results.json") as f:
        want = json.load(f)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = evaluate_tool.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert os.path.exists(tmp_path / "port" / "runs" / "evaluate" / "1" / "eval_results.json")
    assert sorted(got["coco"]) == sorted(want["coco"])
    for k, v in want["coco"].items():
        assert np.isfinite(got["coco"][k])
        assert abs(got["coco"][k] - v) <= (COCO_TOL_INT8 if quantize else COCO_TOL), \
            (k, got["coco"][k], v)
    # the same lines, up to the numbers
    strip = lambda out: [line.split(":")[0].split(" ->")[0] for line in out.splitlines()
                         if line.startswith(("Results", "  "))]
    assert strip(port_out) == strip(jax_out)


def test_evaluate_int8_bf16_with_amp_off(world, labelled, tmp_path, monkeypatch):
    """The int8 Predictor's model is bf16 (the default, as JAX's); a
    checkpoint whose recipe has amp off evaluates it too (its Trainer feeds
    the model images in the model's dtype, as flax casts its input)."""
    _, ckpt = world
    monkeypatch.chdir(tmp_path)
    got = evaluate_tool.main(["--weights", ckpt, "--test_folder", labelled, "--device",
                              "cpu", "--img_size", str(FRAME_IMG), "--quantize", "int8"])
    assert all(np.isfinite(v) for v in got["coco"].values()) and got["coco"]["AR"] > 0


def test_evaluate_seg_checkpoint_reads_polygons(tmp_path, monkeypatch):
    """A seg checkpoint is evaluated as task="segment": segm stats too."""
    from tests.test_torch_port_seg_model import jax_seg, seg_cfg
    _, params, bs = jax_seg()
    ckpt = save_checkpoint(str(tmp_path / "seg.ckpt"), params, bs,
                           build_meta(seg_cfg(), {}, "AP", NAMES, (1, 1, 1)))
    data = chip_smoke.make_seg_set(str(tmp_path / "g"), 2, 2, w=80, h=60)
    monkeypatch.chdir(tmp_path)
    got = evaluate_tool.main(["--weights", ckpt, "--data", data, "--split", "val",
                              "--device", "cpu", "--img_size", str(IMG)])
    assert "coco_segm" in got and np.isfinite(got["coco_segm"]["AP"])


# --------------------------------------------------------------------------- #
# infer
# --------------------------------------------------------------------------- #

def _read_outputs(out_dir):
    res = {}
    for name in sorted(os.listdir(out_dir)):
        stem, ext = os.path.splitext(name)
        if ext == ".json":
            with open(os.path.join(out_dir, name)) as f:
                res.setdefault(stem, {})["json"] = json.load(f)
        elif ext == ".txt":
            with open(os.path.join(out_dir, name)) as f:
                res.setdefault(stem, {})["txt"] = [line.split() for line in f]
    return res


BOX_TOL, SCORE_TOL = 1e-3, 1e-5


def _match(got, want, box_tol, score_tol):
    """Indices into `want` of each detection of `got`, one to one: same
    class, box and score within the tolerances."""
    wb, ws, wc = (np.asarray(want[k]) for k in ("boxes", "scores", "classes"))
    assert len(got["boxes"]) == len(wb)
    order, free = [], list(range(len(wb)))
    for b, s, c in zip(got["boxes"], got["scores"], got["classes"]):
        hit = [j for j in free if wc[j] == c and np.abs(wb[j] - b).max() <= box_tol
               and abs(ws[j] - s) <= score_tol]
        assert hit, f"no JAX detection matches class {c} box {b} score {s}"
        order.append(hit[0])
        free.remove(hit[0])
    return order


def test_infer_matches_jax(world, tmp_path, monkeypatch, capsys):
    data, ckpt = world
    _fp32(monkeypatch, infer_tool)
    argv = ["--weights", ckpt, "--img", _val_dir(data), "--img_size", str(FRAME_IMG),
            "--conf", "0.05", "--save_txt", "--save_json"]
    _run_jax_tool("infer", argv + ["--out_dir", tmp_path / "jax"], monkeypatch)
    got = infer_tool.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    want_files, got_files = _read_outputs(tmp_path / "jax"), _read_outputs(tmp_path / "port")
    assert sorted(got_files) == sorted(want_files) and len(got) == 4
    n = 0
    for stem, w in want_files.items():
        g = got_files[stem]
        assert g["json"]["source"] == w["json"]["source"]
        assert sorted(g["json"]["speed"]) == sorted(w["json"]["speed"])
        assert len(g["txt"]) == len(w["txt"]) == len(g["json"]["boxes"])
        # one to one: near-equal scores may come in either order
        order = _match(g["json"], w["json"], box_tol=BOX_TOL, score_tol=SCORE_TOL)
        np.testing.assert_allclose(np.array(g["txt"], float),
                                   np.array(w["txt"], float)[order], atol=BOX_TOL / 60)
        n += len(order)
    assert n > 0
    out = capsys.readouterr().out
    assert "Saved to" in out
    # the drawings: JAX's files of JAX's boxes, the port's of its own
    for stem in want_files:
        for side in ("jax", "port"):
            assert (tmp_path / side / f"{stem}_pred.jpg").exists()


def test_infer_skips_what_cv2_cannot_read(world, tmp_path, monkeypatch, capsys):
    _, ckpt = world
    bad = tmp_path / "in" / "broken.png"
    bad.parent.mkdir()
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    _run_jax_tool("infer", ["--weights", ckpt, "--img", bad.parent, "--out_dir",
                            tmp_path / "jax"], monkeypatch)
    jax_out = capsys.readouterr().out
    infer_tool.main(["--weights", ckpt, "--img", str(bad.parent), "--out_dir",
                     str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    line = f"[skip] cannot read {bad}"
    assert line in jax_out.splitlines() and line in port_out.splitlines()
    gif = tmp_path / "frame.gif"          # a format cv2 reads and the codecs do not
    assert cv2.imwrite(str(gif), np.zeros((8, 8, 3), np.uint8))
    assert cv2.imread(str(gif)) is not None
    with pytest.raises(UnsupportedImage, match="GIF"):
        infer_tool.main(["--weights", ckpt, "--img", str(gif), "--out_dir",
                         str(tmp_path / "port"), "--device", "cpu"])


# --------------------------------------------------------------------------- #
# export -> infer_exported
# --------------------------------------------------------------------------- #

def test_onnx_export_and_infer_exported_match_jax(world, tmp_path, monkeypatch, capsys):
    data, ckpt = world
    frame = os.path.join(_val_dir(data), "0001.png")
    argv = ["--weights", ckpt, "--format", "decoded", "--runtime", "onnx"]
    _run_jax_tool("export", argv + ["--out_dir", tmp_path / "jax"], monkeypatch)
    jax_path = str(tmp_path / "jax" / "edge_n_decoded.onnx")
    assert os.path.exists(jax_path)
    port_path = export_tool.main(argv + ["--out_dir", str(tmp_path / "port")])
    assert "Sanity run OK; output tree: dict" in capsys.readouterr().out
    kw = ["--img", frame, "--conf", "0.05"]
    _run_jax_tool("infer_exported", ["--artifact", jax_path] + kw, monkeypatch)
    jax_lines = capsys.readouterr().out.splitlines()
    got = infer_exported_tool.main(["--artifact", port_path] + kw)
    port_lines = capsys.readouterr().out.splitlines()
    want = infer_exported_tool.main(["--artifact", jax_path] + kw)
    capsys.readouterr()
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-3, atol=1e-3)
    # JAX's CLI prints the same detections (rounded to 0.1 px)
    assert port_lines[0].split("|")[0] == jax_lines[0].split("|")[0]
    cls_of = lambda lines: [line.split()[1] for line in lines[1:]]
    assert cls_of(port_lines) == cls_of(jax_lines)


def test_pt2_nms_through_infer_exported(world, tmp_path, capsys):
    data, ckpt = world
    frame_path = os.path.join(_val_dir(data), "0002.png")
    path = export_tool.main(["--weights", ckpt, "--format", "nms", "--fp32", "--device",
                             "cpu", "--out_dir", str(tmp_path), "--iou", "0.45"])
    assert path.endswith("edge_n_nms.pt2")
    assert "Sanity run OK; output tree: tuple" in capsys.readouterr().out
    got = infer_exported_tool.main(["--artifact", path, "--img", frame_path,
                                    "--conf", "0.05", "--iou", "0.5"])
    out = capsys.readouterr().out
    assert "[warn] --iou is fixed at export time for 'nms' artifacts (artifact iou=0.45)" \
        in out
    pred = Predictor(ckpt, device="cpu", dtype=torch.float32)
    want = pred.infer_image_profiled(cv2.imread(frame_path), conf=0.05, iou=0.45)
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-3, atol=1e-3)
    out_path = str(tmp_path / "drawn.png")
    drawn = infer_exported_tool.main(["--artifact", path, "--img", frame_path,
                                      "--conf", "0.05", "--out", out_path])
    assert f"saved {out_path}" in capsys.readouterr().out
    frame = cv2.imread(frame_path)
    want_plot = draw_detections(frame[..., ::-1], drawn["boxes"], drawn["scores"],
                                drawn["classes"], NAMES)
    np.testing.assert_array_equal(cv2.imread(out_path), want_plot[..., ::-1])
    path = export_tool.main(["--weights", ckpt, "--runtime", "tflite", "--quantize",
                             "dynamic", "--out_dir", str(tmp_path / "tflite")])
    assert path.endswith("edge_n_decoded.tflite")
    assert "Sanity run OK; output tree: dict" in capsys.readouterr().out
    assert json.load(open(path + ".json"))["quantize"] == "dynamic"


def test_tflite_nms_through_infer_exported_matches_jax_cli(world, tmp_path, monkeypatch,
                                                           capsys):
    """The port's "nms" `.tflite` through the port's infer_exported (its
    numpy runner) and JAX's tools/infer_exported.py (tf.lite.Interpreter)."""
    data, ckpt = world
    frame = os.path.join(_val_dir(data), "0003.png")
    path = export_tool.main(["--weights", ckpt, "--format", "nms", "--runtime", "tflite",
                             "--out_dir", str(tmp_path), "--iou", "0.5"])
    assert "Sanity run OK; output tree: tuple" in capsys.readouterr().out
    kw = ["--img", frame, "--conf", "0.05"]
    _run_jax_tool("infer_exported", ["--artifact", path] + kw, monkeypatch)
    jax_lines = capsys.readouterr().out.splitlines()
    got = infer_exported_tool.main(["--artifact", path] + kw)
    port_lines = capsys.readouterr().out.splitlines()
    pred = Predictor(ckpt, device="cpu", dtype=torch.float32)
    want = pred.infer_image_profiled(cv2.imread(frame), conf=0.05, iou=0.5)
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-3, atol=1e-3)
    assert port_lines[0].split("|")[0] == jax_lines[0].split("|")[0]
    for mine, theirs in zip(port_lines[1:], jax_lines[1:]):   # class, score, box
        a, b = mine.split(maxsplit=3), theirs.split(maxsplit=3)
        assert a[1] == b[1] and a[3] == b[3] and abs(float(a[2]) - float(b[2])) < 2e-3


# --------------------------------------------------------------------------- #
# tracker
# --------------------------------------------------------------------------- #

def _write_sequence(root, indices, frames=None):
    os.makedirs(root, exist_ok=True)
    for k, i in enumerate(indices):
        img = frames[k] if frames is not None else np.full((6, 8, 3), 10 * i, np.uint8)
        chip_smoke.write_png(os.path.join(root, "%04d.png" % i), img[..., ::-1])
    return os.path.join(root, "%04d.png")


def _cv2_frames(pattern):
    cap = cv2.VideoCapture(pattern)
    frames = []
    while cap.isOpened():
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.mark.parametrize("indices,broken", [
    ((0, 1, 2, 3), None), ((1, 2, 3), None), ((0, 1, 3, 4), None), ((4, 5, 6), None),
    ((0, 1, 2, 3), 2),
])
def test_sequence_reader_matches_cv2(tmp_path, indices, broken):
    pattern = _write_sequence(str(tmp_path), indices)
    if broken is not None:
        (tmp_path / ("%04d.png" % broken)).write_bytes(b"garbage")
    want = _cv2_frames(pattern)
    got = list(tracker_tool.read_frames(pattern))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(list(tracker_tool.read_frames(pattern, max_frames=2))) == min(2, len(want))


def test_sequence_reader_rejects_what_it_cannot_open(tmp_path):
    pattern = _write_sequence(str(tmp_path), (5, 6))
    assert not cv2.VideoCapture(pattern).isOpened()
    with pytest.raises(SystemExit, match="Cannot open video source"):
        list(tracker_tool.read_frames(pattern))
    missing = str(tmp_path / "clip.mp4")
    assert not cv2.VideoCapture(missing).isOpened()
    with pytest.raises(SystemExit, match="Cannot open video source"):
        list(tracker_tool.read_frames(missing))
    with pytest.raises(NotImplementedError, match="camera 0"):
        list(tracker_tool.read_frames("0"))
    stub = tmp_path / "h264.mp4"                    # an mp4v clip relabelled avc1
    clip = str(tmp_path / "mp4v.mp4")
    vw = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    vw.write(np.zeros((48, 64, 3), np.uint8))
    vw.release()
    stub.write_bytes(open(clip, "rb").read().replace(b"mp4v\x00\x00", b"avc1\x00\x00"))
    with pytest.raises(UnsupportedVideo, match="H.264"):
        list(tracker_tool.read_frames(str(stub)))
    one = str(tmp_path / "0005.png")                # one image: a clip of one frame, as cv2
    np.testing.assert_array_equal(list(tracker_tool.read_frames(one)), _cv2_frames(one))


@pytest.mark.parametrize("source", ["sequence", "mp4v", "h264"])
def test_tracker_matches_jax(world, tmp_path, monkeypatch, capsys, source):
    """The port's tracker against JAX's Predictor + KalmanSortTracker fed
    with cv2's frames of the same source: a PNG sequence, an mp4v .mp4
    written by cv2, or a High/CABAC/B-frame H.264 .mp4 written by libx264
    (each of which the port decodes as cv2 does, exactly)."""
    _, ckpt = world
    frames = chip_smoke.make_clip(12, h=48, w=64, seed=3)
    if source == "sequence":
        video = _write_sequence(str(tmp_path / "seq"), range(1, 13), frames)
    elif source == "h264":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import h264_fixtures
        if not h264_fixtures.available():
            pytest.skip("no system libavcodec 59 with libx264")
        video = str(tmp_path / "clip.mp4")
        h264_fixtures.write_mp4(video, h264_fixtures.encode(
            frames, profile="high", params="bframes=3:b-pyramid=normal"))
    else:
        video = str(tmp_path / "clip.mp4")
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
        for f in frames:
            vw.write(f)
        vw.release()
    _fp32(monkeypatch, tracker_tool)
    kw = dict(conf=0.05, iou=0.45)
    out = str(tmp_path / "o.mp4")
    got = tracker_tool.main(["--weights", ckpt, "--video", video, "--device", "cpu",
                             "--conf", "0.05", "--min_hits", "1", "--out", out])
    assert capsys.readouterr().out.splitlines()[-1].startswith("Processed 12 frames @ ")
    pred = jax_predictor.Predictor(ckpt)
    tracker = JaxTracker(iou_threshold=0.3, max_age=15, min_hits=1)
    want = [tracker.update(r["boxes"], r["scores"], r["classes"])
            for r in pred.infer_stream(_cv2_frames(video), **kw)]
    assert len(got) == len(want) == 12 and sum(map(len, want)) > 0
    for g_frame, w_frame in zip(got, want):
        assert [(t["track_id"], t["cls"]) for t in g_frame] == \
            [(t["track_id"], t["cls"]) for t in w_frame]
        for g, w in zip(g_frame, w_frame):
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-2)
    cap = cv2.VideoCapture(out)          # mp4v at the source's rate, as JAX's writer
    assert cap.get(cv2.CAP_PROP_FPS) == {"sequence": tracker_tool.SEQUENCE_FPS, "mp4v": 30.0,
                                         "h264": 25.0}[source]
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 12
