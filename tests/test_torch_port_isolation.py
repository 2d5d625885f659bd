"""The PyTorch port stands alone: no JAX, flax, optax, orbax or yololite_tpu
import anywhere in yololite_tpu_torch/ or chip_smoke.py, and none of the
libraries the card's machine lacks (cv2, PIL, PyYAML, msgpack; TensorFlow
and flatbuffers on the export path, where the TFLite writer and runner are
the port's own); its entry points default to the card."""

import ast
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yololite_tpu",
             "cv2", "PIL", "yaml", "msgpack"}
# train/writers.py's optional TensorBoard backend imports tensorflow, as JAX's does
EXPORT_PATH = ("deploy/export.py", "deploy/tflite_schema.py", "deploy/tflite_emit.py",
               "deploy/tflite_run.py", "deploy/infer_exported.py", "tools/export.py",
               "tools/infer_exported.py")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "yololite_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_found():
    files = _port_files()
    assert os.path.exists(files[0]), "chip_smoke.py is missing"
    assert any(f.endswith("cuda_nms.py") for f in files)


@pytest.mark.parametrize("rel", [os.path.relpath(p, ROOT) for p in _port_files()])
def test_no_jax_or_reference_imports(rel):
    bad = sorted(set(_imported_roots(os.path.join(ROOT, rel))) & FORBIDDEN)
    assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("rel", EXPORT_PATH)
def test_export_path_needs_no_tensorflow(rel):
    path = os.path.join(ROOT, "yololite_tpu_torch", rel)
    bad = sorted(set(_imported_roots(path)) & {"tensorflow", "tflite_runtime", "flatbuffers"})
    assert not bad, f"{rel} imports {bad}"


def test_entry_points_default_to_cuda():
    from yololite_tpu_torch.api import YoloLite
    from yololite_tpu_torch.deploy.predictor import Predictor
    from yololite_tpu_torch.train.loop import train_from_config
    from yololite_tpu_torch.train.steps import Trainer
    for fn in (Predictor.__init__, YoloLite.__init__, Trainer.__init__, train_from_config):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_training_modules_are_covered():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("losses/simota.py", "train/steps.py", "train/optim.py", "train/loop.py",
                "data/png.py", "data/codecs.py", "data/dataset.py", "data/loader.py", "eval/coco.py",
                "eval/evaluate.py", "data/imgops.py", "data/augment.py", "data/weather.py",
                "data/device_augment.py", "data/coco_ingest.py"):
        assert os.path.join("yololite_tpu_torch", rel) in files


def test_deploy_variant_modules_are_covered():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("ops/quant.py", "ops/cuda_int8.py", "deploy/s2d.py", "native.py"):
        assert os.path.join("yololite_tpu_torch", rel) in files


def test_deploy_and_track_modules_are_covered():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("deploy/export.py", "deploy/onnx_emit.py", "deploy/onnx_proto.py",
                "deploy/onnx_run.py", "deploy/infer_exported.py", "deploy/predictor.py",
                "deploy/tflite_schema.py", "deploy/tflite_emit.py", "deploy/tflite_run.py",
                "track/__init__.py", "track/kalman.py"):
        assert os.path.join("yololite_tpu_torch", rel) in files


CLI_TOOLS = ("train", "evaluate", "infer", "export", "infer_exported", "tracker",
             "import_backbone")


def test_cli_and_import_modules_are_covered():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ["config/config.py", "models/backbones/torch_import.py", "tools/__init__.py"] + \
            [f"tools/{name}.py" for name in CLI_TOOLS]:
        assert os.path.join("yololite_tpu_torch", rel) in files


def test_cli_devices_default_to_cuda(monkeypatch):
    """Each CLI that runs a model defaults to the card; infer_exported runs
    an artifact where it was exported, import_backbone on the host."""
    import importlib
    tools = {name: importlib.import_module(f"yololite_tpu_torch.tools.{name}")
             for name in CLI_TOOLS}
    for name in ("evaluate", "infer", "export", "tracker"):
        assert tools[name].build_parser().get_default("device") == "cuda", name
    for name in ("infer_exported", "import_backbone"):
        assert "--device" not in tools[name].build_parser()._option_string_actions
    # train: --device (default None) over the recipe's training.device, else cuda
    seen = []
    monkeypatch.setattr(tools["train"], "load_configs",
                        lambda **kw: {"training": {}, "model": {}})
    monkeypatch.setattr(tools["train"], "train_from_config",
                        lambda cfg, device: seen.append(device) or {})
    for argv, want in (([], "cuda"), (["--device", "cuda:1"], "cuda:1")):
        tools["train"].main(["--model", "m.yaml", "--data", "d.yaml"] + argv)
        assert seen[-1] == want


USER_TOOLS = ("model_info", "pretrain_backbone", "benchmark")


def test_user_tools_and_utils_are_covered():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ["utils/__init__.py", "utils/profiling.py"] + \
            [f"tools/{name}.py" for name in USER_TOOLS]:
        assert os.path.join("yololite_tpu_torch", rel) in files


def test_user_tools_default_to_cuda():
    import importlib
    for name in USER_TOOLS:
        mod = importlib.import_module(f"yololite_tpu_torch.tools.{name}")
        assert mod.build_parser().get_default("device") == "cuda", name
    from yololite_tpu_torch.tools import model_info, pretrain_backbone
    for fn in (model_info.analyze, pretrain_backbone.pretrain):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_parallel_modules_are_covered():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("parallel/__init__.py", "parallel/dist.py", "parallel/spatial.py"):
        assert os.path.join("yololite_tpu_torch", rel) in files


def test_drawing_and_weather_modules_are_covered():
    """Drawing, the writers and the weather tool are host work: the tool
    takes no --device."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("utils/viz.py", "data/imwrite.py", "data/font_simplex.py",
                "tools/augment_weather.py"):
        assert os.path.join("yololite_tpu_torch", rel) in files
    from yololite_tpu_torch.tools import augment_weather
    assert "--device" not in augment_weather.build_parser()._option_string_actions


GENERATOR_TOOLS = ("make_hard_synth", "make_synth_dataset", "make_cls_corpus",
                   "make_crop_corpus")


def test_dataset_generators_are_covered():
    """The four dataset generators are host tools: covered by the import
    check, each `main(argv)` taking no --device."""
    import importlib
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in GENERATOR_TOOLS:
        assert os.path.join("yololite_tpu_torch", "tools", f"{name}.py") in files
        mod = importlib.import_module(f"yololite_tpu_torch.tools.{name}")
        assert "--device" not in mod.build_parser()._option_string_actions
        assert "argv" in inspect.signature(mod.main).parameters
