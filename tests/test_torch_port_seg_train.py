"""PyTorch port parity, segmentation training end to end on the CPU: a
2-epoch run of the port's `train_from_config` against the JAX package's on
one polygon PNG set (written from a seed), both resumed from the same
weights-only checkpoint; and `YoloLite.train` / `.val` on a seg model.

Tolerance for the trajectory: per-epoch train and val losses within 1e-3
relative, at 128 px (the train-mode BatchNorm gap of
tests/test_torch_port_train.py: flax's E[x^2] - E[x]^2 batch variance parts
the trajectories at 64 px). The images are 128x128, so the letterbox is the
identity and both packages see the same pixels; augmentation is off (the
augmented samples are held in tests/test_torch_port_seg_data.py).
"""

import csv
import os

import numpy as np
import pytest

import jax.numpy as jnp

from yololite_tpu.config import load_configs as jax_load_configs
from yololite_tpu.models.detector import build_model_from_config as jax_build
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint
from yololite_tpu.train.loop import train_from_config as jax_train_from_config

from chip_smoke import make_seg_set
from tests.test_torch_port_zoo import nhwc, random_vars
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.config import load_configs
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


def test_two_epoch_seg_trajectory_matches_jax(segdata, tmp_path):
    data = segdata["square"]
    jcfg = _cfg(jax_load_configs, data, tmp_path / "jax")
    m = jax_build(jcfg, dtype=jnp.float32)
    params, stats = random_vars(m, nhwc(2, 64, 3))
    start = save_checkpoint(str(tmp_path / "start.ckpt"), params, stats,
                            build_meta(jcfg, {}, "AP", None, (1, 1, 1)))
    jcfg["training"]["resume"] = start
    jax_train_from_config(jcfg)
    got = train_from_config(_cfg(load_configs, data, tmp_path / "port", resume=start),
                            device="cpu")
    want_rows, got_rows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(got_rows) == len(want_rows) == 2
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
