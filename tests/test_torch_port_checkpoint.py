"""PyTorch port: the package's own msgpack checkpoint reader against flax's."""

import json

import msgpack
import numpy as np
import pytest

import jax
from flax import serialization

from yololite_tpu.train.checkpoint import build_meta, save_checkpoint

from tests.test_torch_port_models import edge_cfg, jax_edge
from yololite_tpu_torch.train.checkpoint import load_checkpoint, model_from_meta, unpackb
from yololite_tpu_torch.convert import load_flax

BUNDLED = "weights/mnv4_050_cls20.ckpt"


def _flax_read(path):
    with open(path, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    return payload["state_dict"], json.loads(payload["meta_json"])


def _assert_same_tree(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_reader_matches_flax_on_bundled_backbone():
    sd, meta = load_checkpoint(BUNDLED)
    want_sd, want_meta = _flax_read(BUNDLED)
    _assert_same_tree(sd, want_sd)
    assert meta == want_meta
    assert meta["backbone"] == "mobilenetv4_conv_small_050"


def test_reader_matches_flax_on_detector_checkpoint(tmp_path):
    m_jax, params, bs = jax_edge(64)
    cfg = edge_cfg(64)
    meta = build_meta(cfg, {"map": 0.5}, "map", ["a", "b", "c"], (1, 1, 1))
    path = save_checkpoint(str(tmp_path / "det.ckpt"), params, bs, meta)
    sd, got_meta = load_checkpoint(path)
    want_sd, want_meta = _flax_read(path)
    _assert_same_tree(sd, want_sd)
    assert got_meta == want_meta
    model = load_flax(model_from_meta(got_meta), sd["params"], sd["batch_stats"])
    assert model.num_classes == 3 and model.cpu_variant


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
    -1, -32, -33, -129, -32769, -2**31 - 1, 1.5, -2.25e300, "", "x" * 31,
    "y" * 32, "z" * 300, "w" * 70000, b"", b"\x00" * 300, b"\x01" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
])
def test_unpackb_matches_msgpack(value):
    assert unpackb(msgpack.packb(value, use_bin_type=True)) == value


def test_unpackb_float32_and_ext_scalars():
    assert unpackb(msgpack.packb(np.float32(0.25).item(), use_single_float=True)) == 0.25
    blob = serialization.msgpack_serialize({"s": np.float32(3.5),
                                            "a": np.arange(6, dtype=np.int8).reshape(2, 3)})
    out = unpackb(blob)
    assert out["s"] == np.float32(3.5) and out["s"].dtype == np.float32
    np.testing.assert_array_equal(out["a"], np.arange(6, dtype=np.int8).reshape(2, 3))
    with pytest.raises(ValueError, match="trailing"):
        unpackb(msgpack.packb(1) + b"\x00")


# --------------------------------------------------------------------------- #
# Writing: the port's encoder, meta and full training state, both ways
from yololite_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from yololite_tpu.train.steps import Trainer as JaxTrainer  # noqa: E402
from yololite_tpu.models.detector import build_model_from_config as jax_build  # noqa: E402

from yololite_tpu_torch.convert import to_flax  # noqa: E402
from yololite_tpu_torch.models.detector import build_model_from_config  # noqa: E402
from yololite_tpu_torch.train.checkpoint import build_meta as port_build_meta  # noqa: E402
from yololite_tpu_torch.train.checkpoint import packb  # noqa: E402
from yololite_tpu_torch.train.checkpoint import save_checkpoint as port_save  # noqa: E402
from yololite_tpu_torch.train.steps import Trainer  # noqa: E402


@pytest.mark.parametrize("value", [
    {"a": None, "b": [1, -1, 300, -300, 70000, 2**40, 1.5, True, "é" * 40, b"xy"]},
    {"z": {str(i): i for i in range(20)}, "a": np.float32(2.5), "c": [1, [2]]},
    {"arr": np.arange(12, dtype=np.float32).reshape(3, 4).T, "s": np.asarray(7, np.int32),
     "big": np.zeros(70000, np.float32), "e": {}},
])
def test_packb_writes_flax_bytes(value):
    """Byte for byte what flax's msgpack_serialize writes (sorted keys,
    smallest forms, 0-d arrays as ext 1, numpy scalars as ext 3)."""
    assert packb(value) == serialization.msgpack_serialize(value)


def _train_cfg():
    return {"model": dict(edge_cfg(64)["model"]), "training": {"img_size": 64, "amp": False,
            "optimizer": "adamw", "grad_clip": 1.0, "weight_decay": 1e-4,
            "save_optimizer": True}, "dataset": {"names": ["a", "b", "c"]}}


def _random_like(tree, rng):
    return jax.tree.map(lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), tree)


def test_port_checkpoint_with_full_state_restores_in_jax(tmp_path):
    """A port `save_optimizer` checkpoint: JAX's load_checkpoint reads equal
    trees and meta, and JAX's Trainer.state_from_full restores the raw and
    EMA weights, the Adam moments and the counters."""
    _, params, bs = jax_edge(64)
    cfg = _train_cfg()
    pt = Trainer(build_model_from_config(cfg), cfg, device="cpu")
    st = pt.state_from_weights(params, bs)
    rng = np.random.RandomState(0)
    with torch_no_grad():
        for t in st.opt.mu + st.opt.nu + list(st.ema.parameters()):
            t.copy_(torch_tensor(rng.normal(0, 1, tuple(t.shape))))
    st.opt.count, st.updates, st.micro = 5, 5, 6
    meta = port_build_meta(cfg, {"AP": 0.25}, "AP", ["a", "b", "c"], (1, 1, 1))
    assert meta == build_meta(cfg, {"AP": 0.25}, "AP", ["a", "b", "c"], (1, 1, 1))
    ema_p, ema_bs = to_flax(st.ema)
    path = port_save(str(tmp_path / "last.ckpt"), ema_p, ema_bs, meta,
                     extra_state=pt.full_state(st))
    sd, got_meta = jax_load_checkpoint(path)
    assert got_meta == json.loads(json.dumps(meta))
    _assert_same_tree(sd["params"], ema_p)
    _assert_same_tree(sd["raw_params"], params)
    jt = JaxTrainer(jax_build(cfg), cfg)
    js = jt.state_from_full(sd)
    assert int(js.updates) == 5 and int(js.micro) == 6
    adam = js.opt_state[1]
    assert int(adam.count) == 5
    want_mu = to_flax_params_of(st, st.opt.mu)
    _assert_same_tree(jax.tree.map(np.asarray, adam.mu), want_mu)
    _assert_same_tree(jax.tree.map(np.asarray, js.ema_params), ema_p)


def test_jax_full_state_checkpoint_restores_in_port(tmp_path):
    _, params, bs = jax_edge(64)
    cfg = _train_cfg()
    jt = JaxTrainer(jax_build(cfg), cfg)
    js = jt.state_from_weights(params, bs)
    rng = np.random.RandomState(1)
    adam = js.opt_state[1]._replace(count=np.asarray(9, np.int32),
                                    mu=_random_like(js.params, rng),
                                    nu=jax.tree.map(np.abs, _random_like(js.params, rng)))
    js = js.replace(opt_state=(js.opt_state[0], adam, js.opt_state[2]),
                    ema_params=_random_like(js.params, rng),
                    updates=np.asarray(9, np.int32), micro=np.asarray(9, np.int32))
    meta = build_meta(cfg, {"AP": 0.5}, "AP", ["a", "b", "c"], (1, 1, 1))
    extra = {"raw_params": js.params, "raw_batch_stats": js.batch_stats,
             "ema_params": js.ema_params, "ema_batch_stats": js.ema_batch_stats,
             "updates": js.updates, "micro": js.micro,
             "opt_state": serialization.to_state_dict(js.opt_state)}
    path = save_checkpoint(str(tmp_path / "j.ckpt"), js.ema_params, js.ema_batch_stats,
                           meta, extra_state=extra)
    sd, _ = load_checkpoint(path)
    pt = Trainer(build_model_from_config(cfg), cfg, device="cpu")
    st = pt.state_from_full(sd)
    assert st.updates == 9 and st.micro == 9 and st.opt.count == 9
    _assert_same_tree(to_flax_params_of(st, st.opt.mu), jax.tree.map(np.asarray, adam.mu))
    _assert_same_tree(to_flax_params_of(st, st.opt.nu), jax.tree.map(np.asarray, adam.nu))
    _assert_same_tree(to_flax(st.ema)[0], jax.tree.map(np.asarray, js.ema_params))
    _assert_same_tree(to_flax(st.model)[0], params)


def to_flax_params_of(state, tensors):
    from yololite_tpu_torch.convert import to_flax_params
    return to_flax_params(state.model, dict(zip(state.opt.names, tensors)))


def torch_no_grad():
    import torch
    return torch.no_grad()


def torch_tensor(x):
    import torch
    return torch.tensor(x, dtype=torch.float32)
