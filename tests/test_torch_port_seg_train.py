"""PyTorch port parity, segmentation training end to end on the CPU: a
2-epoch run of the port's `train_from_config` against the JAX package's on
one polygon PNG set (written from a seed), both resumed from the same
weights-only checkpoint; and `YoloLite.train` / `.val` on a seg model.

Tolerance for the trajectory: per-epoch train and val losses within 1e-3
relative, at 128 px (the train-mode BatchNorm gap of
tests/test_torch_port_train.py: flax's E[x^2] - E[x]^2 batch variance parts
the trajectories at 64 px). The images are 128x128, so the letterbox is the
identity and both packages see the same pixels; augmentation is off (the
augmented samples are held in tests/test_torch_port_seg_data.py). Each
epoch starts from JAX's state and each validation runs on JAX's EMA
weights of that epoch, while the port's own state after each epoch is
held to JAX's (why: the test's docstring).
"""

import csv
import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp

from yololite_tpu.config import load_configs as jax_load_configs
from yololite_tpu.models.detector import build_model_from_config as jax_build
from yololite_tpu.train import loop as jax_loop
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint
from yololite_tpu.train.loop import train_from_config as jax_train_from_config

from chip_smoke import make_seg_set
from tests.test_torch_port_zoo import nhwc, random_vars
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.config import load_configs
from yololite_tpu_torch.train import loop as port_loop
from yololite_tpu_torch.train.checkpoint import load_checkpoint
from yololite_tpu_torch.train.loop import train_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_YAML = os.path.join(ROOT, "configs", "models", "edge_n_seg.yaml")
TRAIN_YAML = os.path.join(ROOT, "configs", "train", "standard_train.yaml")
OVERRIDES = dict(epochs=2, batch_size=4, img_size=128, augment=False, amp=False,
                 num_workers=0, max_boxes=8, save_optimizer=False)


@pytest.fixture(scope="module")
def segdata(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    return {"square": make_seg_set(str(root / "sq"), 8, 4, w=128, h=128, seed=3),
            "small": make_seg_set(str(root / "small"), 8, 4, w=80, h=60, seed=4)}


def _cfg(loader, data, log_dir, **training):
    cfg = loader(MODEL_YAML, TRAIN_YAML, data, make_run_dir=False)
    cfg["training"].update(dict(OVERRIDES, **training))
    cfg["logging"] = {"log_dir": str(log_dir)}
    return cfg


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


# tolerance of _drift, the port's state after an epoch against JAX's: the
# params part by 1.5e-2 (all threads) to 5.7e-2 (1 thread) of the epoch's
# change, because Adam's first steps are +-lr for any gradient and a
# near-zero gradient's sign follows the rounding; BN statistics by 1.4e-4.
# The EMA decay without its warm-up ramp parts the EMA by 0.99.
DRIFT = {"raw_params": 0.2, "ema_params": 0.2, "raw_batch_stats": 2e-3, "ema_batch_stats": 2e-3}


def _keep_epoch_states(monkeypatch, loop, prefix):
    """Copies of each last_model_state.ckpt `loop` writes, one an epoch."""
    kept, real_save = [], loop.save_checkpoint

    def keep(path, *args, **kw):
        out = real_save(path, *args, **kw)
        if os.path.basename(path) == "last_model_state.ckpt":
            kept.append(shutil.copy(path, f"{prefix}{len(kept) + 1}.ckpt"))
        return out
    monkeypatch.setattr(loop, "save_checkpoint", keep)
    return kept


def _flat(tree, name=""):
    """{path: float64 array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{name}/{k}"))
        else:
            out[f"{name}/{k}"] = np.asarray(v, np.float64)
    return out


def _drift(got, want, before):
    """|got - want| / |want - before| over all arrays of one layout."""
    got, want, before = _flat(got), _flat(want), _flat(before)
    assert set(got) == set(want) == set(before)
    d = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    m = sum(float(((want[k] - before[k]) ** 2).sum()) for k in want)
    return (d / m) ** 0.5


def test_two_epoch_seg_trajectory_matches_jax(segdata, tmp_path, monkeypatch):
    """The port's 2-epoch loop against JAX's, with JAX's state carried into
    each epoch: epoch 1 from the shared start, epoch 2 resumed from JAX's
    full state after epoch 1 (`resume` + `start_epoch`, the chunked exact
    resume), and each epoch's validation on JAX's EMA weights of that epoch
    (swapped in for the port's at `collect_coco`).

    A free-running trajectory is ill-posed here in both packages. Two
    training steps amplify fp32 rounding about a thousandfold: the port on
    1 thread and on 8 (oneDNN's convolutions and torch's reductions split
    their sums by thread) predicts IoUs 0.3061 and 0.3039 for one anchor of
    image 2 at epoch 1's validation. There SimOTA's dynamic k is 1 for that
    image's GT 0, and its two cheapest anchors (290, 329) cost less apart
    than that drift, so the assignment flips with the thread count and the
    epoch's val loss moves 3.6e-3 (12.9705 on 1 thread; 13.0179 on 8, JAX
    13.0174 on both). From a carried state only one forward's rounding
    parts the packages, and the losses hold at 1e-3. The port's own state
    after each epoch (raw weights, EMA, BN statistics) is held to JAX's at
    DRIFT, so a fault in its optimizer or EMA still fails here."""
    data = segdata["square"]
    jcfg = _cfg(jax_load_configs, data, tmp_path / "jax", save_optimizer=True)
    m = jax_build(jcfg, dtype=jnp.float32)
    params, stats = random_vars(m, nhwc(2, 64, 3))
    start = save_checkpoint(str(tmp_path / "start.ckpt"), params, stats,
                            build_meta(jcfg, {}, "AP", None, (1, 1, 1)))
    jcfg["training"]["resume"] = start
    states = _keep_epoch_states(monkeypatch, jax_loop, tmp_path / "jax_epoch")
    jax_train_from_config(jcfg)
    assert len(states) == 2
    port_states = _keep_epoch_states(monkeypatch, port_loop, tmp_path / "port_epoch")
    real_collect = port_loop.collect_coco

    def on_jax_ema(trainer, variables, *args, **kw):
        epoch = int(port_epoch[0])
        port_epoch[0] += 1
        sd, _ = load_checkpoint(states[epoch])
        return real_collect(trainer, trainer.variables_from_flax(sd["ema_params"],
                                                                 sd["ema_batch_stats"]), *args, **kw)
    monkeypatch.setattr(port_loop, "collect_coco", on_jax_ema)
    port_epoch = [0]
    train_from_config(_cfg(load_configs, data, tmp_path / "port1", resume=start,
                           save_optimizer=True), device="cpu")
    port_epoch = [1]
    got = train_from_config(_cfg(load_configs, data, tmp_path / "port2", resume=states[0],
                                 start_epoch=1, save_optimizer=True), device="cpu")
    # the port's own training state (raw weights, EMA, BN statistics) after
    # epoch 1 and after the carried epoch 2, against JAX's
    for got_ckpt, want_ckpt, before_ckpt in ((port_states[0], states[0], start),
                                             (port_states[2], states[1], states[0])):
        got_sd, want_sd, before_sd = (load_checkpoint(p)[0] for p in (got_ckpt, want_ckpt, before_ckpt))
        for part, tol in DRIFT.items():
            before = before_sd.get(part, before_sd[part.split("_", 1)[1]])
            drift = _drift(got_sd[part], want_sd[part], before)
            assert drift < tol, (want_ckpt, part, drift)
    want_rows = _rows(tmp_path / "jax")
    got_rows = [_rows(tmp_path / "port1")[0], _rows(tmp_path / "port2")[0]]
    assert len(want_rows) == 2 and [r["epoch"] for r in got_rows] == ["1", "2"]
    for g, w in zip(got_rows, want_rows):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-3, err_msg=k)
    assert set(got["coco_segm"]) == set(got["coco"])
    assert float(got_rows[1]["val_loss"]) < float(got_rows[0]["val_loss"])


def test_yololite_trains_and_validates_a_seg_model(segdata, tmp_path, monkeypatch):
    """Seg training and validation through the API; per-epoch COCO gets the
    detections without their masks (bbox only, as in the JAX loop), the
    final evaluate_model gets them with their masks and adds coco_segm."""
    from yololite_tpu_torch.eval import evaluate as port_evaluate
    data = segdata["small"]
    seen = []
    real = port_evaluate.dets_to_coco
    monkeypatch.setattr(port_evaluate, "dets_to_coco",
                        lambda dets, *a, **k: seen.append(sorted(dets)) or real(dets, *a, **k))
    model = YoloLite("edge_n_seg", device="cpu", task="segment")
    res = model.train(data=data, epochs=2, batch_size=4, img_size=64, workers=2,
                      run_dir=str(tmp_path / "runs"), augment=True, amp=False)
    assert len(seen) == 3 and all("masks" not in keys for keys in seen[:2])
    assert "masks" in seen[2]
    assert np.isfinite(res["history"]["step_loss"]).all()
    assert "coco_segm" in res and all(np.isfinite(v) for v in res["coco_segm"].values())
    stats = model.val(data=data, batch_size=4, out_dir=str(tmp_path / "val"))
    assert "map" in stats and np.isfinite(stats["map"])
    r = model.predict(np.zeros((60, 80, 3), np.uint8), conf=0.0)[0]
    assert r["masks"].dtype == np.uint8 and r["masks"].shape[1:] == (60, 80)
