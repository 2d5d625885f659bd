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
