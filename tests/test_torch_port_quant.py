"""PyTorch port parity, int8 inference and quantization-aware training
(`ops/quant.py`, `ops/cuda_int8.py`'s plain versions on the CPU) against the
JAX package's `int8_inference` and `fake_quant_training` (XLA on the CPU).

The JAX side's intermediates are read by wrapping `jax.lax.conv_general_dilated`
(its int8 operands and int32 result) and `ops/quant.py`'s `jnp.maximum` (the
scales it guards) for the duration of one eager call.

Tolerances, each with its reason:
  - one conv: x_q, w_q, s_x, s_w and the int32 accumulators equal; the
    output within rtol 1e-6 (the same fp32 epilogue in the same order);
  - a narrow edge_n (FPN 32, 64 px, fp32) under int8: the inputs of its
    quantized convs differ by at most one level, at fewer than 1e-3 of the
    values (a "flip": the non-quantized layers, BatchNorm and the
    activations, are fp32 in another operation order, so a value within an
    ulp of a rounding midpoint x/s = k + 1/2 rounds to the other side); the
    level maps equal to 1e-4 of their scale except where a flip reached
    them, at most 2% of the values, each within a few quanta. Measured: 0
    flips in 203,520 quantized values here (maps 1.3e-8 apart); the same
    model at FPN 160 flips 50 values in 7 of its 62 quantized convs, the
    first where a BatchNorm output sits within an ulp of a midpoint;
  - the port's int8 against its own fp32: JAX's own bound (raw logits within
    0.15 of max(1, |max|), correlation > 0.99);
  - fake-quant: forward 1e-5 of the scale, gradients 1e-4 of the scale
    (fp32 convolutions in another order; the STE passes the same gradient);
  - QAT on the whole model, BatchNorm on running statistics: output and
    gradients 1e-5 of their scale; the 3-step QAT Trainer trajectory, each
    step from JAX's state: losses at twice their measured spread (train-mode
    fake-quant amplifies the last bit in both packages; see the test), the
    update norms 2%;
  - the int8 Predictor: equal counts of valid detections and equal classes;
    boxes within 1e-3 px and scores 1e-5 for at least 90% of them, the rest
    (touched by a flip) within 0.5 px and 1e-3; seg masks of the matched
    detections differ on at most 1e-3 of their pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax import serialization

import yololite_tpu.ops.quant as jax_quant
from yololite_tpu.deploy.predictor import Predictor as JaxPredictor
from yololite_tpu.models.detector import build_model_from_config as jax_build
from yololite_tpu.train.checkpoint import build_meta, save_checkpoint
from yololite_tpu.train.steps import Trainer as JaxTrainer
from yololite_tpu.train.steps import normalize_images as jax_normalize

from tests.test_torch_port_models import edge_cfg, jax_edge
from tests.test_torch_port_train import (EDGE_N, _batches, _flat, _train_cfg,
                                         jax_edge_variables)
from yololite_tpu_torch.convert import load_flax, to_flax, to_flax_params
from yololite_tpu_torch.deploy.predictor import Predictor
from yololite_tpu_torch.models.detector import build_model_from_config
from yololite_tpu_torch.ops import cuda_int8, quant
from yololite_tpu_torch.train.steps import Trainer

IMG = 64
NARROW = {"fpn_channels": 54}        # FPN 32 after width_multiple 0.6


class _Capture:
    """Wraps the JAX int8 path for one eager call: records the int8 operands
    and int32 result of every conv, and the scales `jnp.maximum` guards
    (s_w, then s_x, per conv)."""

    def __init__(self):
        self.convs, self.scales = [], []

    def __enter__(self):
        self._conv, self._jnp = jax.lax.conv_general_dilated, jax_quant.jnp
        cap = self

        def conv(*a, **k):
            out = cap._conv(*a, **k)
            if a[0].dtype == jnp.int8:
                cap.convs.append(tuple(np.asarray(t) for t in (a[0], a[1], out)))
            return out

        class Jnp:
            def __getattr__(self, name):
                if name == "maximum":
                    return lambda a, b: (cap.scales.append(np.asarray(a)), jnp.maximum(a, b))[1]
                return getattr(jnp, name)

        jax.lax.conv_general_dilated, jax_quant.jnp = conv, Jnp()
        return self

    def __exit__(self, *exc):
        jax.lax.conv_general_dilated, jax_quant.jnp = self._conv, self._jnp


class _PortCapture:
    """Records the port's x_q per quantized conv (NHWC numpy)."""

    def __init__(self, monkeypatch):
        self.xq = []
        real = cuda_int8.quantize

        def wrapped(x):
            q, s = real(x)
            self.xq.append(q.permute(0, 2, 3, 1).numpy())
            return q, s
        monkeypatch.setattr(cuda_int8, "quantize", wrapped)


def _conv_pair(rng, cin, cout, k, s, groups, bias):
    w = (rng.randn(k, k, cin // groups, cout) * 0.2).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    mod = fnn.Conv(cout, (k, k), strides=s, padding=[(k // 2, k // 2)] * 2,
                   feature_group_count=groups, use_bias=bias)
    params = {"kernel": jnp.asarray(w)}
    if bias:
        params["bias"] = jnp.asarray(b)
    conv = torch.nn.Conv2d(cin, cout, k, s, k // 2, groups=groups, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
    return mod, params, conv


CONVS = {"dense1x1": (32, 48, 1, 1, 1, False), "dense3x3s2": (16, 32, 3, 2, 1, False),
         "dw3x3": (48, 48, 3, 1, 48, False), "dw5x5s2": (24, 24, 5, 2, 24, False),
         "dw7x7bias": (40, 40, 7, 1, 40, True), "focus12": (12, 16, 3, 1, 1, False),
         "bias3x3": (20, 36, 3, 1, 1, True)}


@pytest.mark.parametrize("name", list(CONVS))
def test_int8_conv_equals_jax(name):
    cin, cout, k, s, groups, bias = CONVS[name]
    rng = np.random.RandomState(len(name))
    x = (rng.randn(2, 9, 11, cin) * 3).astype(np.float32)
    mod, params, conv = _conv_pair(rng, cin, cout, k, s, groups, bias)
    with _Capture() as cap, jax_quant.int8_inference():
        want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    (jx_q, jw_q, jacc), = cap.convs
    js_w, js_x = cap.scales
    quant.quantize_int8(conv)
    assert isinstance(conv, quant.Int8Conv2d) and conv.depthwise == (groups > 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    x_q, s_x = cuda_int8.quantize(xt)
    np.testing.assert_array_equal(x_q.permute(0, 2, 3, 1).numpy(), jx_q)
    assert s_x.item() == js_x and x_q.dtype == torch.int8
    np.testing.assert_array_equal(conv.s_w.numpy(), js_w)
    if conv.depthwise:
        w_q = conv.w_packed.numpy()[:, :, None, :]
        acc = cuda_int8.conv_depthwise(x_q, s_x, conv.w_packed, conv.s_w, None, conv.stride,
                                       conv.padding, torch.int32)
    else:
        w_q = cuda_int8.unpack_dense(conv.w_packed, cin, k, k).permute(2, 3, 1, 0).numpy()
        acc = cuda_int8.conv_dense(x_q, s_x, conv.w_packed, conv.s_w, None, conv.kernel_size,
                                   conv.stride, conv.padding, torch.int32)
    np.testing.assert_array_equal(w_q, jw_q)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), jacc)
    with torch.no_grad():
        got = conv(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_skip_rule_leaves_small_and_pooled_convs(monkeypatch):
    rng = np.random.RandomState(3)
    calls = []
    monkeypatch.setattr(cuda_int8, "quantize", lambda x: calls.append(x) or None)
    for cin, shape in ((3, (2, 3, 16, 16)), (4, (1, 4, 8, 8)), (32, (2, 32, 1, 1))):
        _, _, conv = _conv_pair(rng, cin, 8, 1 if shape[2] == 1 else 3, 1, 1, True)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        with torch.no_grad():
            want = conv(x)
            got = quant.quantize_int8(conv)(x)
        assert torch.equal(got, want) and not quant.should_quantize(x)
    assert not calls
    assert quant.should_quantize(torch.zeros(1, 5, 1, 2))


def test_grouped_conv_that_is_not_depthwise_raises():
    conv = torch.nn.Conv2d(32, 64, 3, groups=2)
    with pytest.raises(ValueError, match="groups=2"):
        quant.quantize_int8(conv)


def _narrow_pair(img, **overrides):
    m, params, bs = jax_edge(img, **dict(NARROW, **overrides))
    port = load_flax(build_model_from_config(edge_cfg(img, **NARROW, **overrides)), params,
                     bs).eval()
    return m, params, bs, port


def test_int8_model_skips_like_jax_at_32px(monkeypatch):
    """At 32 px the stride-32 level is 1x1: its head convs stay float in
    both packages. JAX also computes the P6 branch that the model discards
    (`p6_down` on the 1x1 P5 is skipped as well)."""
    m, params, bs, port = _narrow_pair(32)
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    with _Capture() as cap, jax_quant.int8_inference():
        m.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), train=False)
    pc = _PortCapture(monkeypatch)
    with torch.no_grad():
        quant.quantize_int8(port)(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = [q.shape for q in pc.xq]
    want = [c[0].shape for c in cap.convs]
    assert got == want and min(s[1] * s[2] for s in got) > 1
    assert 1 in {o.shape[2] for o in port(torch.from_numpy(x).permute(0, 3, 1, 2))}


def test_int8_level_maps_match_jax_narrow(monkeypatch):
    m, params, bs, port = _narrow_pair(IMG)
    u8 = (np.random.RandomState(1).rand(2, IMG, IMG, 3) * 255).astype(np.uint8)
    with _Capture() as cap, jax_quant.int8_inference():
        want = m.apply({"params": params, "batch_stats": bs},
                       jax_normalize(jnp.asarray(u8), jnp.float32), train=False)
    pc = _PortCapture(monkeypatch)
    from yololite_tpu_torch.train.steps import normalize_images
    with torch.no_grad():
        got = quant.quantize_int8(port)(normalize_images(torch.from_numpy(u8)))
    assert len(pc.xq) == len(cap.convs) - 1          # JAX's discarded p6_down
    flips = total = 0
    for a, (b, _, _) in zip(pc.xq, cap.convs):
        d = np.abs(a.astype(np.int32) - b)
        assert d.max() <= 1
        flips += int(d.sum())
        total += d.size
    assert flips <= 1e-3 * total, (flips, total)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        scale = np.abs(w).max()
        off = np.abs(g - w) > 1e-4 * scale
        assert off.mean() <= 0.02 and (flips or not off.any()), (flips, off.sum())
        assert np.abs(g - w).max() <= 0.05 * scale


def test_int8_outputs_close_to_fp32():
    _, _, _, port = _narrow_pair(IMG)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, IMG, IMG).astype(np.float32))
    with torch.no_grad():
        ref = port(x)
        q = quant.quantize_int8(port)(x)
    for r, o in zip(ref, q):
        r, o = r.numpy(), o.numpy()
        assert r.shape == o.shape
        assert np.abs(r - o).max() / max(1.0, np.abs(r).max()) < 0.15
        assert np.corrcoef(r.ravel(), o.ravel())[0, 1] > 0.99


@pytest.mark.parametrize("name", ["dense3x3s2", "dw5x5s2", "dw7x7bias"])
def test_fake_quant_conv_and_grads_equal_jax(name):
    cin, cout, k, s, groups, bias = CONVS[name]
    rng = np.random.RandomState(7)
    x = (rng.randn(2, 9, 11, cin) * 3).astype(np.float32)
    mod, params, conv = _conv_pair(rng, cin, cout, k, s, groups, bias)
    up = None

    def f(p, x):
        with jax_quant.fake_quant_training():
            out = mod.apply({"params": p}, x)
        return jnp.sum(out * up), out

    up = rng.randn(*mod.apply({"params": params}, jnp.asarray(x)).shape).astype(np.float32)
    (_, jout), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    quant.fake_quant(conv)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = conv(xt)
    v = (out * torch.from_numpy(up).permute(0, 3, 1, 2)).sum()
    grads = torch.autograd.grad(v, [conv.weight, xt] + ([conv.bias] if bias else []))

    def close(a, b, tol):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())

    close(out.detach().permute(0, 2, 3, 1).numpy(), jout, 1e-5)
    close(grads[0].permute(2, 3, 1, 0).numpy(), jgp["kernel"], 1e-4)
    close(grads[1].permute(0, 2, 3, 1).numpy(), jgx, 1e-4)
    if bias:
        close(grads[2].numpy(), jgp["bias"], 1e-4)


def test_fake_quant_runs_fp32_under_autocast():
    """Under autocast the fake-quant conv computes in fp32 and returns the
    autocast type, as JAX computes in f32 and casts to the module's bf16."""
    conv = quant.fake_quant(torch.nn.Conv2d(16, 8, 3, padding=1))
    x = torch.randn(1, 16, 8, 8)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = conv(x)
    assert out.dtype == torch.bfloat16
    with torch.no_grad():
        want = conv(x)
    assert want.dtype == torch.float32
    assert torch.equal(out, want.to(torch.bfloat16))


def test_qat_model_forward_and_grads_equal_jax():
    """The whole edge_n at 128 px under fake-quant, BatchNorm on its running
    statistics: the output and every parameter's gradient agree with
    `jax.grad` under `fake_quant_training` to 1e-5 of their scale
    (measured 4e-7)."""
    img = 128
    cfg = {"model": dict(EDGE_N), "training": {"img_size": img}}
    params, stats = jax_edge_variables()
    m = jax_build(cfg, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, img, img, 3)).astype(np.float32)
    shapes = [o.shape for o in m.apply({"params": params, "batch_stats": stats},
                                       jnp.asarray(x), train=False)]
    ws = [rng.normal(0, 1, sh).astype(np.float32) for sh in shapes]

    def jax_f(p):
        with jax_quant.fake_quant_training():
            outs = m.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=False)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    pm = quant.fake_quant(load_flax(build_model_from_config(cfg), params, stats).eval())
    outs = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    v = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws))
    names = [n for n, _ in pm.named_parameters()]
    g = torch.autograd.grad(v, [p for _, p in pm.named_parameters()], allow_unused=True,
                            materialize_grads=True)
    got = _flat(to_flax_params(pm, dict(zip(names, [t.detach() for t in g]))))
    want = _flat(jax.jit(jax.grad(jax_f))(params))
    np.testing.assert_allclose(float(v.detach()), float(jax.jit(jax_f)(params)), rtol=1e-5)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _jax_full_state(js):
    """JAX's Trainer state in the layout `Trainer.state_from_full` reads (a
    `save_optimizer` checkpoint's)."""
    return jax.tree.map(np.asarray, {
        "params": js.params, "batch_stats": js.batch_stats,
        "raw_params": js.params, "raw_batch_stats": js.batch_stats,
        "ema_params": js.ema_params, "ema_batch_stats": js.ema_batch_stats,
        "updates": js.updates, "micro": js.micro,
        "opt_state": serialization.to_state_dict(js.opt_state)})


def test_qat_trainer_trajectory_tracks_jax():
    """Three QAT steps of the Trainer against JAX's Trainer with qat: True
    (edge_n, 128 px, batch 2), each step from JAX's state carried into the
    port.

    Train-mode fake-quant is ill-conditioned in both packages, so the two
    trajectories cannot be compared as the plain ones are. An fp32 rounding
    difference flips one quantized value a level; with BatchNorm on batch
    statistics and a max-based scale per tensor the flip spreads (the port
    on 1 and 6 threads: 1e-6 of the scale after the first two convs, 4e-3
    after the third, 10% at the backbone's end), and the gradient grows
    from ~1 at the heads to ~150 at the stem. Measured on one state, the step-0 gradient of one
    package against itself: the port on 1 and 6 threads 113% apart (norm of
    the difference over the norm), its signs equal at 57% of the elements
    with |g| > 1; JAX eager against jit 72% apart, 87%; the port against
    JAX 159%, 57-64%. The loss at one state: JAX's train step against its own
    forward 3.5% apart in the total and 21% in cls (step 1); the port on 1
    and 6 threads 1.5%, npos 8 against 7. So the state is carried across
    (loaded through `state_from_full` and held equal to JAX's) and each
    step's losses are held at about twice the spread measured from carried
    states (torch on 1-12 threads with oneDNN on and off, against JAX's
    states from XLA's multi- and single-threaded CPU): total 6.1%, box 4.5%,
    obj 12.9%, cls 36.5% (a mean over 6-8 positives), npos 1 apart.
    What does not depend on the rounding is held exactly or closely: the
    carried state (equal), Adam's step size (each step's update norm within
    2%; measured within 0.53%), and the QAT step differing from the plain
    one from the same state."""
    img, lr = 128, 1e-3
    params, stats = jax_edge_variables()
    cfg = _train_cfg(img_size=img, qat=True)
    pt = Trainer(build_model_from_config(cfg), cfg, total_updates=30, device="cpu")
    plain_cfg = _train_cfg(img_size=img)
    plain = Trainer(build_model_from_config(plain_cfg), plain_cfg, total_updates=30,
                    device="cpu")
    jt = JaxTrainer(jax_build(cfg, dtype=jnp.float32), cfg, total_updates=30)
    assert pt.qat and jt.qat and not plain.qat
    js = jt.state_from_weights(params, stats)
    tol = {"total": 0.12, "box": 0.1, "obj": 0.25, "cls": 0.6}
    for i, batch in enumerate(_batches(img=img)):
        full = _jax_full_state(js)
        ps = pt.state_from_full(full)
        start = _flat(js.params)
        assert ps.updates == int(js.updates) == i and ps.opt.count == i
        assert np.array_equal(_flat(to_flax(ps.model)[0]), start)
        assert np.array_equal(_flat(to_flax(ps.ema)[0]), _flat(js.ema_params))
        ps, pm = pt.train_step(ps, pt.put_batch(batch), pt.lr_vector(lr))
        js, jm = jt.train_step(js, jt.put_batch(batch), jt.lr_vector(lr))
        for k, rtol in tol.items():
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
        assert abs(float(pm["npos"]) - float(jm["npos"])) <= 2, (i, pm["npos"], jm["npos"])
        d_port = _flat(to_flax(ps.model)[0]) - start
        d_jax = _flat(js.params) - start
        np.testing.assert_allclose(np.linalg.norm(d_port), np.linalg.norm(d_jax), rtol=0.02,
                                   err_msg=f"step {i} update norm")
        qs = plain.state_from_full(full)
        qs, _ = plain.train_step(qs, plain.put_batch(batch), plain.lr_vector(lr))
        d_plain = _flat(to_flax(qs.model)[0]) - start
        assert np.linalg.norm(d_port - d_plain) > 0.05 * np.linalg.norm(d_plain)


def test_qat_keeps_state_dict_keys_and_plain_checkpoints():
    cfg = _train_cfg(img_size=IMG, qat=True)
    plain = build_model_from_config(_train_cfg(img_size=IMG))
    pt = Trainer(build_model_from_config(cfg), cfg, total_updates=3, device="cpu")
    st = pt.init_state(0)
    assert list(st.model.state_dict()) == list(plain.state_dict())
    assert list(st.ema.state_dict()) == list(plain.state_dict())
    kinds = {type(m) for m in st.model.modules() if isinstance(m, torch.nn.Conv2d)}
    assert kinds == {quant.FakeQuantConv2d}
    p, bs = to_flax(st.model)
    back = load_flax(build_model_from_config(_train_cfg(img_size=IMG)), p, bs)
    for a, b in zip(back.state_dict().values(), st.model.state_dict().values()):
        assert torch.equal(a, b)
    assert pt.full_state(st)["raw_params"].keys() == p.keys()


# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    _, params, bs = jax_edge(IMG, **NARROW)
    meta = build_meta(edge_cfg(IMG, **NARROW), {}, "map", ["a", "b", "c"], (1, 1, 1))
    return save_checkpoint(str(tmp_path_factory.mktemp("ck") / "edge.ckpt"), params, bs, meta)


def _match_slots(got, want, with_masks=False):
    """Per image: equal valid counts and classes (as multisets); returns
    (matched within 1e-3 px / 1e-5, all, worst box gap of the rest)."""
    exact = total = 0
    worst = 0.0
    for b in range(len(got[3])):
        gv, wv = got[3][b], want[3][b]
        assert gv.sum() == wv.sum() > 0
        gb, gs, gc = got[0][b][gv], got[1][b][gv], got[2][b][gv]
        wb, ws, wc = want[0][b][wv], want[1][b][wv], want[2][b][wv]
        assert sorted(gc) == sorted(wc)
        free = list(range(len(wb)))
        for i in range(len(gb)):
            hit = [j for j in free if wc[j] == gc[i] and np.abs(wb[j] - gb[i]).max() <= 1e-3
                   and abs(ws[j] - gs[i]) <= 1e-5]
            if hit:
                exact += 1
                free.remove(hit[0])
                continue
            near = [j for j in free if wc[j] == gc[i] and abs(ws[j] - gs[i]) <= 1e-3]
            gap = min(np.abs(wb[j] - gb[i]).max() for j in near)
            worst = max(worst, gap)
        total += len(gb)
    return exact, total, worst


def test_int8_predictor_matches_jax(ckpt):
    port = Predictor(ckpt, device="cpu", dtype=torch.float32, quantize="int8")
    ref = JaxPredictor(ckpt, dtype=jnp.float32, quantize="int8")
    assert not port.folded and not port.s2d and port.model.head3.fused_out is not None
    kinds = {type(m) for m in port.model.modules() if isinstance(m, torch.nn.Conv2d)}
    assert kinds == {quant.Int8Conv2d}
    batch = (np.random.RandomState(2).rand(4, IMG, IMG, 3) * 255).astype(np.uint8)
    got = [t.numpy() for t in port._run(IMG, 0.001, 0.45, 100, batch)]
    want = [np.asarray(t) for t in ref._run(IMG, 0.001, 0.45, 100, batch)]
    exact, total, worst = _match_slots(got, want)
    assert exact >= 0.9 * total and worst <= 0.5, (exact, total, worst)


def test_quantize_other_than_int8_raises(ckpt):
    with pytest.raises(ValueError, match="fp8"):
        Predictor(ckpt, device="cpu", quantize="fp8")
    with pytest.raises(ValueError):
        JaxPredictor(ckpt, quantize="fp8")


def test_int8_seg_predictor_masks_match_jax(tmp_path):
    from tests.test_torch_port_seg_model import _frames, jax_seg, seg_cfg
    _, params, bs = jax_seg()
    meta = build_meta(seg_cfg(), {}, "map", ["a", "b", "c"], (1, 1, 1))
    ck = save_checkpoint(str(tmp_path / "seg.ckpt"), params, bs, meta)
    port = Predictor(ck, device="cpu", dtype=torch.float32, quantize="int8")
    ref = JaxPredictor(ck, dtype=jnp.float32, quantize="int8")
    assert isinstance(port.model.protonet.proto_out, quant.Int8Conv2d)
    for f in _frames():
        g = port.infer_image_profiled(f, conf=0.3)
        w = ref.infer_image_profiled(f, conf=0.3)
        wb, ws, wc = (np.asarray(w[k]) for k in ("boxes", "scores", "classes"))
        assert len(g["boxes"]) == len(wb) > 0 and sorted(g["classes"]) == sorted(wc)
        free, pixels, n_px = list(range(len(wb))), 0, 0
        for i in range(len(g["boxes"])):
            hit = [j for j in free if wc[j] == g["classes"][i]
                   and np.abs(wb[j] - g["boxes"][i]).max() <= 1e-3
                   and abs(ws[j] - g["scores"][i]) <= 1e-5]
            if hit:
                free.remove(hit[0])
                pixels += int((g["masks"][i] != w["masks"][hit[0]]).sum())
                n_px += g["masks"][i].size
        assert n_px >= 0.9 * len(wb) * g["masks"][0].size
        assert pixels <= 1e-3 * n_px
