"""The port's training loop end to end on the CPU (edge_n at 64 px on a tiny
PNG set written from a seed, and its JPEG copy): artifacts, exact resume, host augmentation
with its taper (also across a chunked resume), device augmentation on a
COCO-json dataset, one QAT epoch, and the options that still raise. Port only, apart from
JAX's CSV header, which the port's must equal."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from yololite_tpu.train.loop import CSV_HEADER as JAX_CSV_HEADER

from chip_smoke import make_synth_set
from test_torch_port_coco_ingest import make_coco_set
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.data.dataset import YoloDataset
from yololite_tpu_torch.config import load_configs
from yololite_tpu_torch.train.checkpoint import load_checkpoint
from yololite_tpu_torch.train.loop import CSV_HEADER, train_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = dict(epochs=2, batch_size=4, img_size=64, augment=False, amp=False,
                 freeze_backbone_epochs=1, save_optimizer=True, num_workers=2,
                 pretrained_backbone=os.path.join(ROOT, "weights", "mnv4_050_cls20.ckpt"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs: the test files run in
    parallel processes, and torch's default of one thread a core in each of
    them oversubscribes the machine (this file took 763 s so, ~65 s alone)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("set"))
    return make_synth_set(root, n_train=8, n_val=6, w=80, h=60)


def _config(data, log_dir, **training):
    cfg = load_configs(os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                       os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
                       data, make_run_dir=False)
    cfg["training"].update(dict(OVERRIDES, **training))
    cfg["logging"] = {"log_dir": str(log_dir)}
    return cfg


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def jpeg_data(tmp_path_factory):
    """The same set as `data`, its images written as baseline JPEGs."""
    root = str(tmp_path_factory.mktemp("jpgset"))
    return make_synth_set(root, n_train=8, n_val=6, w=80, h=60, fmt="jpg")


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_two_epochs_make_every_artifact(request, tmp_path, fmt):
    """Two epochs through YoloLite.train on the PNG set and on its JPEG copy
    (read by the port's codec)."""
    data = request.getfixturevalue("data" if fmt == "png" else "jpeg_data")
    model = YoloLite("edge_n", device="cpu")
    res = model.train(data=data, run_dir=str(tmp_path / "runs"), workers=2,
                      **{k: v for k, v in OVERRIDES.items() if k != "num_workers"})
    log_dir = res["log_dir"]
    for name in ("merged_config.yaml", "metrics.csv", "last_metrics.json",
                 "best_metrics.json", "eval_results.json", "p_r_f1_curves.csv",
                 "confusion_stats.txt", "weights/best_no_aug.ckpt",
                 "weights/last_model_state.ckpt"):
        assert os.path.exists(os.path.join(log_dir, name)), name
    # without augmentation the JAX loop never writes best_model_state.ckpt
    assert not os.path.exists(os.path.join(log_dir, "weights", "best_model_state.ckpt"))
    assert CSV_HEADER == JAX_CSV_HEADER
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        assert f.readline().strip().split(",") == JAX_CSV_HEADER
    rows = _rows(log_dir)
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert float(rows[0]["lr_g0"]) > 0                  # lr_g0 logs the schedule
    hist = res["history"]
    assert len(hist["step_loss"]) == 4 and np.isfinite(hist["step_loss"]).all()
    sd, meta = load_checkpoint(os.path.join(log_dir, "weights", "last_model_state.ckpt"))
    assert {"raw_params", "ema_params", "opt_state", "updates", "micro"} <= set(sd)
    assert int(sd["updates"]) == 4 and meta["num_classes"] == 3
    with open(os.path.join(log_dir, "eval_results.json")) as f:
        assert set(json.load(f)) >= {"coco", "best_f1", "best_conf", "ms_per_img"}
    # the object now serves and validates the best checkpoint
    assert model._src["ckpt"].endswith("best_no_aug.ckpt")
    frame = np.zeros((60, 80, 3), np.uint8)
    assert model.predict(frame, conf=0.001)[0]["boxes"].shape[1] == 4
    stats = model.val(data=data, out_dir=str(tmp_path / "val"))
    assert {"map", "map_50", "AP", "best_f1"} <= set(stats)


def _leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _leaves(v) if isinstance(v, dict) else [np.asarray(v)]
    return out


def test_exact_resume_equals_uninterrupted(data, tmp_path):
    straight = train_from_config(_config(data, tmp_path / "a"), device="cpu")
    train_from_config(_config(data, tmp_path / "b", epochs=1), device="cpu")
    last = str(tmp_path / "b" / "weights" / "last_model_state.ckpt")
    # freeze_backbone_epochs: 1 -> epoch 1 trains at backbone LR 0, so the
    # raw backbone weights are still the pretrained checkpoint's
    sd, _ = load_checkpoint(last)
    bb, _ = load_checkpoint(OVERRIDES["pretrained_backbone"])
    bb = bb["params"].get("backbone", bb["params"])
    for g, w in zip(_leaves(sd["raw_params"]["backbone"]), _leaves(bb)):
        np.testing.assert_array_equal(g, w)
    assert not all(np.array_equal(g, w) for g, w in
                   zip(_leaves(sd["raw_params"]["head3"]), _leaves(sd["params"]["head3"])))
    resumed = train_from_config(_config(data, tmp_path / "c", resume=last, start_epoch=1),
                                device="cpu")
    # the CPU is deterministic: epoch 2's steps and the LR schedule repeat exactly
    assert resumed["history"]["step_loss"] == straight["history"]["step_loss"][2:]
    assert [r["epoch"] for r in _rows(tmp_path / "c")] == ["2"]
    assert _rows(tmp_path / "c")[0]["lr_g1"] == _rows(tmp_path / "a")[1]["lr_g1"]
    a, _ = load_checkpoint(str(tmp_path / "a" / "weights" / "last_model_state.ckpt"))
    c, _ = load_checkpoint(str(tmp_path / "c" / "weights" / "last_model_state.ckpt"))
    for x, y in zip(_leaves(a["params"]), _leaves(c["params"])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("training,want", [
    ({"data_parallel": 2, "spatial_parallel": 2}, "mesh 2x2 needs 4 devices"),
    ({"spatial_parallel": 2}, "mesh 1x2 needs 2 devices"),
])
def test_spatial_mesh_needs_a_card_a_rank(data, tmp_path, training, want):
    """The spatial axis is ported (test_torch_port_spatial.py); on cuda a
    data x spatial mesh needs as many cards as ranks, as JAX's make_mesh
    needs devices (the CPU tests run with no card)."""
    with pytest.raises(ValueError, match=want):
        train_from_config(_config(data, tmp_path / "x", **training), device="cuda")


@pytest.mark.parametrize("training,model,item", [
    ({"checkpoint_backend": "orbax_async"}, {}, "item 8c"),
    ({"dataset": "tiff"}, {}, "TIFF"),
])
def test_unported_options_raise_naming_their_item(data, tmp_path, training, model, item):
    training = dict(training)
    tiff = training.pop("dataset", None) == "tiff"
    cfg = _config(data, tmp_path / "x", **training)
    cfg["model"].update(model)
    if tiff:        # a train split of TIFFs in a variant the codec leaves out (CCITT)
        from codec_fixtures import write_tiff
        img_dir = tmp_path / "tif"
        img_dir.mkdir()
        for i in range(4):       # a whole batch: the first step reads them
            (img_dir / f"{i:04d}.tif").write_bytes(write_tiff(
                np.zeros((8, 8), np.uint8), bps=1, extra={259: (3, [4])}))
        cfg["dataset"]["train_images"] = str(img_dir)
    # a sample's UnsupportedImage reaches the loop wrapped by the loader's
    # worker error, as any sample's exception does
    with pytest.raises((NotImplementedError, RuntimeError)) as e:
        train_from_config(cfg, device="cpu")
    err = e.value if isinstance(e.value, NotImplementedError) else e.value.__cause__
    assert isinstance(err, NotImplementedError) and item in str(err), e.value


def test_qat_epoch_through_the_api(data, tmp_path, monkeypatch):
    """training.qat: true through YoloLite.train: the train steps and the
    epoch's validation run fake-quant convs; the checkpoint holds plain
    weights (the same tree as a plain run's), which an int8 Predictor
    serves."""
    from yololite_tpu_torch.deploy.predictor import Predictor
    from yololite_tpu_torch.ops import quant
    modes = []
    real = quant.FakeQuantConv2d.forward
    monkeypatch.setattr(quant.FakeQuantConv2d, "forward",
                        lambda self, x: modes.append(self.training) or real(self, x))
    res = YoloLite("edge_n", device="cpu").train(
        data=data, run_dir=str(tmp_path / "runs"), workers=2, qat=True,
        **dict({k: v for k, v in OVERRIDES.items() if k != "num_workers"}, epochs=1))
    assert True in modes and False in modes
    assert np.isfinite(res["history"]["step_loss"]).all()
    last = os.path.join(res["log_dir"], "weights", "last_model_state.ckpt")
    sd, meta = load_checkpoint(last)
    assert meta["config"]["training"]["qat"] is True
    plain, _ = load_checkpoint(os.path.join(ROOT, "weights", "mnv4_050_cls20.ckpt"))
    assert set(sd["params"]["backbone"]) == set(plain["params"])
    pred = Predictor(last, device="cpu", dtype=torch.float32, quantize="int8")
    frame = (np.random.RandomState(0).rand(60, 80, 3) * 255).astype(np.uint8)
    boxes, scores, _ = pred.infer_image(frame, img_size=64, conf=0.001)
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()


def test_augmented_run_writes_best_model_state(data, tmp_path):
    """augment: true (the recipe's default): mosaic and cutmix in epoch 1,
    tapered off in epoch 2 (int(0.7 * 2) = 1); the best checkpoint while
    augmenting is best_model_state.ckpt, as in the JAX loop."""
    res = YoloLite("edge_n", device="cpu").train(
        data=data, run_dir=str(tmp_path / "runs"), workers=2,
        **dict({k: v for k, v in OVERRIDES.items() if k != "num_workers"}, augment=True))
    weights = os.path.join(res["log_dir"], "weights")
    assert os.path.exists(os.path.join(weights, "best_model_state.ckpt"))
    assert not os.path.exists(os.path.join(weights, "best_no_aug.ckpt"))
    assert np.isfinite(res["history"]["step_loss"]).all()
    sd, meta = load_checkpoint(os.path.join(weights, "last_model_state.ckpt"))
    assert int(sd["updates"]) == 4


class _SpyDataset(YoloDataset):
    """Records the taper state each training sample is drawn under."""
    seen = []

    def get(self, idx, rng=None):
        if self.is_train:
            _SpyDataset.seen.append((self.mosaic_p, self.cutmix_p, self.augment_enabled))
        return super().get(idx, rng)


def _taper_states(epochs, start):
    """JAX loop.py's taper: mosaic and cutmix off from int(0.7 * epochs), all
    augmentation off after int(0.9 * epochs)."""
    return [(0.0 if e >= int(0.7 * epochs) else 0.2,) * 2 + (e <= int(0.9 * epochs),)
            for e in range(start, epochs)]


class _ChunkEnd(Exception):
    pass


def test_taper_schedule_and_chunked_resume(tmp_path, monkeypatch):
    """12 epochs (taper at 8, augmentation off in 11) straight, and chunked
    as tools/run_chunked_train.sh runs them: a process killed after epoch 9
    (emulated by raising after its last checkpoint), then one resumed at
    epoch 9 from that full state. The taper states follow JAX's schedule and
    the chunks' steps repeat the straight run's exactly (the CPU is
    deterministic)."""
    import yololite_tpu_torch.train.loop as loop
    monkeypatch.setattr(loop, "YoloDataset", _SpyDataset)
    data = make_synth_set(str(tmp_path / "set"), n_train=4, n_val=2, w=80, h=60)
    kw = dict(epochs=12, batch_size=4, num_workers=0, augment=True, eval_every=100,
              freeze_backbone_epochs=0, pretrained_backbone=None)
    last1 = str(tmp_path / "chunk1" / "weights" / "last_model_state.ckpt")
    history = {}
    real_curve = loop._save_loss_curve
    for name, extra, stop in (("straight", {}, None), ("chunk1", {}, 9),
                              ("chunk2", dict(start_epoch=9, resume=last1), None)):
        _SpyDataset.seen = []

        def end_of_epoch(train_losses, *a, stop=stop):
            real_curve(train_losses, *a)
            if len(train_losses) == stop:
                raise _ChunkEnd

        monkeypatch.setattr(loop, "_save_loss_curve", end_of_epoch)
        cfg = _config(data, tmp_path / name, **dict(kw, **extra))
        try:
            history[name] = train_from_config(cfg, device="cpu")["history"]["step_loss"]
        except _ChunkEnd:
            history[name] = [float(r["train_loss"]) for r in _rows(tmp_path / name)]
        # the first batch is the sanity image's, drawn before any epoch's
        # taper under the recipe's settings; then 4 samples per epoch
        sanity, per_epoch = _SpyDataset.seen[:4], _SpyDataset.seen[4::4]
        assert sanity == [_taper_states(12, 0)[0]] * 4
        want = _taper_states(12, extra.get("start_epoch", 0))
        assert per_epoch == want[:len(per_epoch)] and len(per_epoch) == (stop or len(want))
    straight = history["straight"]
    assert history["chunk2"] == straight[9:]
    epoch_loss = [float(r["train_loss"]) for r in _rows(tmp_path / "straight")]
    assert history["chunk1"] == epoch_loss[:9]


def test_device_augment_on_a_coco_json_set(tmp_path, monkeypatch):
    """hardsynth_device_aug.yaml as written (device_augment: true) on a
    data.yaml with train_json/val_json: the host pipeline drops its colour
    and noise ops, every train step runs the device augmentation."""
    import yololite_tpu_torch.train.steps as steps
    calls = []
    real = steps.photometric_augment

    def counted(images, gen, *a, **k):
        calls.append(tuple(images.shape))
        return real(images, gen, *a, **k)

    monkeypatch.setattr(steps, "photometric_augment", counted)
    data = make_coco_set(str(tmp_path / "coco"), n=8, w=80, h=60)
    res = YoloLite("edge_n", device="cpu").train(
        data=data, epochs=1, batch_size=4, img_size=64, workers=2,
        run_dir=str(tmp_path / "runs"),
        train_yaml=os.path.join(ROOT, "configs", "train", "hardsynth_device_aug.yaml"),
        amp=False, cache_images=False)
    assert calls == [(4, 64, 64, 3)] * 2
    assert np.isfinite(res["history"]["step_loss"]).all()
    cfg_text = open(os.path.join(res["log_dir"], "merged_config.yaml")).read()
    assert "device_augment: true" in cfg_text and "labels_from_coco" in cfg_text
