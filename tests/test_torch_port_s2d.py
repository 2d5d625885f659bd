"""PyTorch port parity, the space-to-depth stem (`deploy/s2d.py`) and the
s2d Predictor, against the JAX package's `deploy/s2d.py` and s2d Predictor
(CPU, fp32).

Tolerances, each with its reason:
  - the rewritten kernel and the packed bytes: exact (a tap permutation and
    a byte shuffle);
  - the s2d Predictor's level maps: within 1e-4 of their scale against JAX's
    s2d Predictor (fp32 convolutions summed in another order, as
    tests/test_torch_port_models.py), and within 1e-5 of the port's folded
    Predictor (JAX's own `test_s2d.py` bound: the same products, the 2x2
    conv sums them in another order); detections one to one (boxes 1e-3
    px, scores 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yololite_tpu.deploy.predictor import Predictor as JaxPredictor
from yololite_tpu.deploy.s2d import pack_s2d as jax_pack_s2d
from yololite_tpu.deploy.s2d import rewrite_stem_kernel as jax_rewrite
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint

from tests.test_torch_port_models import edge_cfg, jax_edge
from yololite_tpu_torch.deploy import predictor as predictor_module
from yololite_tpu_torch.deploy import s2d
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.models.detector import build_model_from_config, init_weights

IMG = 64


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    _, params, bs = jax_edge(IMG)
    meta = build_meta(edge_cfg(IMG), {}, "map", ["a", "b", "c"], (1, 1, 1))
    return save_checkpoint(str(tmp_path_factory.mktemp("ck") / "edge.ckpt"), params, bs, meta)


def _batch(n=2, seed=0):
    return (np.random.RandomState(seed).rand(n, IMG, IMG, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("cin,cout", [(3, 8), (6, 5)])
def test_rewrite_stem_kernel_equals_jax(cin, cout):
    w = np.random.RandomState(cin).randn(3, 3, cin, cout).astype(np.float32)
    got = s2d.rewrite_stem_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got.numpy(), jax_rewrite(w).transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="3x3"):
        s2d.rewrite_stem_kernel(torch.zeros(4, 3, 2, 2))


@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (32, 16, 3), (1, 8, 8, 3)])
def test_pack_s2d_equals_jax(shape):
    x = (np.random.RandomState(1).rand(*shape) * 255).astype(np.uint8)
    got = s2d.pack_s2d(x)
    np.testing.assert_array_equal(got, jax_pack_s2d(x))
    xf = x.astype(np.float32)
    np.testing.assert_array_equal(s2d.pack_s2d(xf), jax_pack_s2d(xf))
    if x.ndim == 4:
        dev = s2d.pack_s2d_device(torch.from_numpy(x))
        np.testing.assert_array_equal(dev.numpy(), got)


def _maps(pred, batch):
    with torch.inference_mode():
        return [o.numpy() for o in pred.forward(pred._upload(batch))]


def test_s2d_predictor_matches_jax_and_folded(ckpt):
    port = Predictor(ckpt, device="cpu", dtype=torch.float32, s2d_stem=True)
    folded = Predictor(ckpt, device="cpu", dtype=torch.float32)
    ref = JaxPredictor(ckpt, dtype=jnp.float32, s2d_stem=True)
    assert port.s2d and port.folded and ref.s2d
    stem = port.model.backbone.ConvBNAct_0.Conv_0
    assert isinstance(stem, s2d.S2DStemConv) and stem.weight.shape[1:] == (12, 2, 2)
    batch = _batch()
    got, base = _maps(port, batch), _maps(folded, batch)
    from yololite_tpu.deploy.fold_norm import raw_cast
    from yololite_tpu.deploy.s2d import s2d_stem
    with s2d_stem():
        want = ref.model.apply(ref.variables, raw_cast(jnp.asarray(jax_pack_s2d(batch)),
                                                        jnp.float32), train=False)
    for g, b, w in zip(got, base, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(g, b, rtol=0, atol=1e-5 * np.abs(b).max())
    g = [t.numpy() for t in port._run(IMG, 0.001, 0.45, 100, batch)]
    w = [np.asarray(t) for t in ref._run(IMG, 0.001, 0.45, 100, batch)]
    for b in range(len(batch)):
        gv, wv = g[3][b], w[3][b]
        assert gv.sum() == wv.sum() > 0
        free = list(range(int(wv.sum())))
        wb, ws, wc = w[0][b][wv], w[1][b][wv], w[2][b][wv]
        for box, sc, c in zip(g[0][b][gv], g[1][b][gv], g[2][b][gv]):
            hit = [j for j in free if wc[j] == c and np.abs(wb[j] - box).max() <= 1e-3
                   and abs(ws[j] - sc) <= 1e-5]
            assert hit, (box, sc, c)
            free.remove(hit[0])


def test_focus_stem_keeps_s2d_off():
    cfg = {"model": {"arch": "YOLOLiteMS_CPU", "backbone": "cs3darknet_focus_s",
                     "width_multiple": 0.25, "depth_multiple": 0.33, "fpn_channels": 32,
                     "num_classes": 3}}
    model = init_weights(build_model_from_config(cfg), 0).eval()
    meta = {"img_size": IMG, "names": ["a", "b", "c"]}
    pred = Predictor((model, model.state_dict(), meta), device="cpu",
                     dtype=torch.float32, s2d_stem=True)
    assert pred.folded and not pred.s2d
    sd, ok = s2d.rewrite_stem_to_s2d(model.state_dict())
    assert not ok
    out = pred.infer_batch([_batch(1)[0]], conf=0.001)
    assert len(out) == 1 and np.isfinite(out[0]["boxes"]).all()


def test_int8_keeps_s2d_off(ckpt):
    pred = Predictor(ckpt, device="cpu", dtype=torch.float32, quantize="int8", s2d_stem=True)
    assert not pred.s2d and not pred.folded


def test_every_entry_point_packs(ckpt, monkeypatch):
    """infer_image, infer_batch, infer_stream, infer_batched_stream (frames,
    prepared host arrays and prepared tensors) and warmup all feed the s2d
    model a packed batch, and give the folded Predictor's detections."""
    port = Predictor(ckpt, device="cpu", dtype=torch.float32, s2d_stem=True)
    folded = Predictor(ckpt, device="cpu", dtype=torch.float32)
    packed = []
    real = predictor_module.pack_s2d
    monkeypatch.setattr(predictor_module, "pack_s2d",
                        lambda b: packed.append(b.shape) or real(b))
    frames = [f[..., ::-1] for f in _batch(3, seed=4)]
    kw = dict(conf=0.001)
    seen = []

    def same(a, b):
        assert len(a["boxes"]) == len(b["boxes"])
        seen.append(len(a["boxes"]))
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3)
        np.testing.assert_array_equal(a["classes"], b["classes"])

    same(port.infer_image_profiled(frames[0], **kw), folded.infer_image_profiled(frames[0], **kw))
    for a, b in zip(port.infer_batch(frames, **kw), folded.infer_batch(frames, **kw)):
        same(a, b)
    for a, b in zip(port.infer_stream(iter(frames), **kw), folded.infer_stream(iter(frames), **kw)):
        same(a, b)
    canv = _batch(2, seed=5)
    for items, prepared in (([frames[:2]], False), ([canv], True),
                            ([torch.from_numpy(canv)], True)):
        got = list(port.infer_batched_stream(items, prepared=prepared, **kw))
        want = list(folded.infer_batched_stream(items, prepared=prepared, **kw))
        for a, b in zip(got[0], want[0]):
            same(a, b)
    assert min(seen[:6]) > 0        # the frames have detections
    n = len(packed)
    port.warmup()
    assert len(packed) == n + 1
    # image, batch (bucket 4), 3 stream frames, 3 batched-stream items, warmup
    assert n == 1 + 1 + 3 + 3
    assert all(s[-1] == 3 for s in packed)
