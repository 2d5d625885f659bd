"""PyTorch port parity: `yololite_tpu_torch/tools/pretrain_backbone.py`
against the JAX package's `tools/pretrain_backbone.py`, on the CPU.

Tolerances, each with its reason:
  - the imagefolder listing, the crops' random draws, shapes and labels:
    equal (the same code over one RandomState);
  - make_batch's pixels within one level of JAX's (cv2.resize's uint8
    bilinear is matched within one level, not reproduced);
  - the smoothed cross-entropy and its gradient against optax: 1e-6
    relative (fp32 log-softmax in another order);
  - the LR schedule against optax's warmup_cosine_decay_schedule: within
    1e-6 of the peak LR (float32 cos of numpy against XLA's differ by an
    ulp of 1, and 1 + cos cancels at the schedule's end);
  - clip + AdamW: each step's update (the change of the parameters, not the
    weights after many steps) within 1e-6 of lr per element of optax's, from
    the same gradients, plus the two roundings of the new float32 value;
  - the EMA decay equal, the EMA update 1e-7 relative;
  - the fp32 classifier against JAX's `build_classifier(..., jnp.float32)`
    with the same weights: logits and the loss's gradient of every
    parameter within 1e-4 of their scale in eval mode (fp32 convolutions
    in another order), and the train-mode logits and new BatchNorm
    statistics within 1e-3 of their scale (flax's E[x^2] - E[x]^2 batch
    variance cancels on the 2x2 maps of a 64 px input);
  - a `pretrain()` checkpoint: JAX's `load_checkpoint` reads it and its tree
    has the shapes of JAX's classifier's `backbone` subtree; both training
    loops graft it, and the port's backbone at step 0 equals it.
"""

import importlib.util
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yololite_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from yololite_tpu.models.detector import build_model_from_config as jax_build

from tests.test_torch_port_zoo import random_vars
from yololite_tpu_torch.convert import load_flax, to_flax, to_flax_params
from yololite_tpu_torch.data.codecs import UnsupportedImage
from yololite_tpu_torch.tools import pretrain_backbone as pb
from yololite_tpu_torch.train.optim import GroupedOptimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONE = "mobilenetv4_conv_small_050"


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_pretrain_backbone", os.path.join(ROOT, "tools", "pretrain_backbone.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JPB = _jax_tool()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs: the test files run in
    parallel processes, and torch's default of one thread a core in each of
    them oversubscribes the machine (this file's runs took 50-100x longer
    so in a 4-process run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _imagefolder(root, n_per_class=4, seed=0):
    """2 classes of coloured crops on noise, PNG/JPEG/BMP, plus files the
    listing must skip and one that cv2 cannot read."""
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_per_class), ("val", 2)):
        for ci, color in enumerate(((200, 40, 40), (40, 40, 200))):
            d = os.path.join(root, split, f"class_{ci}")
            os.makedirs(d)
            for i in range(n):
                h, w = rng.randint(20, 60), rng.randint(20, 60)
                img = (rng.rand(h, w, 3) * 60).astype(np.uint8)
                img[h // 4:3 * h // 4, w // 4:3 * w // 4] = color
                ext = (".png", ".jpg", ".bmp")[i % 3]
                cv2.imwrite(os.path.join(d, f"{i:03d}{ext}"), img)
            with open(os.path.join(d, "notes.txt"), "w") as f:
                f.write("not an image")
    os.makedirs(os.path.join(root, "train", "class_0", "nested"))
    with open(os.path.join(root, "train", "class_1", "zz_damaged.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 20)
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _imagefolder(str(tmp_path_factory.mktemp("imagefolder")))


def test_list_imagefolder_equals_jax(folder):
    for split in ("train", "val"):
        assert pb.list_imagefolder(os.path.join(folder, split)) == \
            JPB.list_imagefolder(os.path.join(folder, split))
    with pytest.raises(FileNotFoundError):
        pb.list_imagefolder(os.path.join(folder, "train", "class_0", "nested"))


@pytest.mark.parametrize("train", [True, False])
def test_make_batch_equals_jax(folder, train):
    samples, _ = JPB.list_imagefolder(os.path.join(folder, "train"))
    assert samples[-1][0].endswith("zz_damaged.png") and cv2.imread(samples[-1][0]) is None
    idxs = list(range(len(samples))) * 3
    r_port, r_jax = np.random.RandomState(5), np.random.RandomState(5)
    got, got_l = pb.make_batch(samples, idxs, 32, r_port, train=train)
    want, want_l = JPB.make_batch(samples, idxs, 32, r_jax, train=train)
    assert got.shape == want.shape == (len(idxs), 32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got_l, want_l)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert not got[len(samples) - 1].any()          # the damaged file: zeros, as cv2's None
    s1, s2 = r_port.get_state(), r_jax.get_state()
    assert s1[2] == s2[2] and np.array_equal(s1[1], s2[1])


def test_make_batch_webp_raises(tmp_path):
    img = np.zeros((16, 16, 3), np.uint8)
    path = str(tmp_path / "a.webp")
    assert cv2.imwrite(path, img) and cv2.imread(path) is not None
    with pytest.raises(UnsupportedImage, match="WebP"):
        pb.make_batch([(path, 0)], [0], 16, np.random.RandomState(0))


def test_smoothed_cross_entropy_matches_optax():
    rng = np.random.RandomState(0)
    logits = rng.normal(0, 3, (6, 5)).astype(np.float32)
    labels = rng.randint(0, 5, 6)

    def jax_loss(lg):
        onehot = optax.smooth_labels(jax.nn.one_hot(labels, 5), 0.1)
        return optax.softmax_cross_entropy(lg, onehot).mean()

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = pb.smoothed_cross_entropy(lt, torch.from_numpy(labels), 0.1)
    (got_g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("warmup,decay", [(1, 2), (3, 12), (6, 40), (10, 11)])
def test_schedule_matches_optax(warmup, decay):
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup_steps=warmup,
                                               decay_steps=decay)
    for count in range(decay + 3):
        want = float(jax.jit(sched)(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(pb.warmup_cosine_lr(count, 2e-3, warmup, decay), want,
                                   rtol=0, atol=1e-6 * 2e-3, err_msg=f"count {count}")


def test_clip_adamw_updates_match_optax():
    """Three steps of GroupedOptimizer's chain as `pretrain` builds it
    against optax's clip_by_global_norm(1) + adamw(schedule, wd): the
    gradients' norms above and below the clip, the same gradients on both
    sides; each step's update compared."""
    rng = np.random.RandomState(0)
    shapes = {"backbone.a.weight": (4, 3), "backbone.bn.bias": (4,), "head.weight": (2, 4)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    warmup, decay, lr, wd = 2, 5, 2e-3, 0.05
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup, decay_steps=decay)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=wd))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = GroupedOptimizer({"training": {"optimizer": "adamw", "grad_clip": 1.0,
                                         "weight_decay": wd}}, list(tp.items()))
    for step, scale in enumerate((5.0, 0.1, 2.0)):
        grads = {k: (rng.normal(0, scale, s)).astype(np.float32) for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        before = {k: t.clone() for k, t in tp.items()}
        opt.step([torch.tensor(grads[k]) for k in shapes],
                 [pb.warmup_cosine_lr(step, lr, warmup, decay)] * 3)
        for k in shapes:
            # the change of a float32 parameter carries the rounding of the
            # new value: up to an ulp of the parameter on each side
            ulp = np.spacing(np.abs(params[k]).max() + 1.0).astype(np.float64)
            np.testing.assert_allclose((tp[k] - before[k]).numpy(), np.asarray(upd[k]),
                                       rtol=0, atol=1e-6 * lr + 2 * ulp,
                                       err_msg=f"step {step} {k}")


def test_ema_matches_jax():
    for step in (0, 1, 5, 50, 20_000):
        want = jnp.minimum(0.9995, (1.0 + jnp.float32(step)) / (10.0 + jnp.float32(step)))
        assert pb.ema_decay_at(step, 0.9995) == float(want)
    rng = np.random.RandomState(0)
    model = pb.build_classifier(BACKBONE, 3)
    ema = pb.build_classifier(BACKBONE, 3)
    for m in (model, ema):
        with torch.no_grad():
            for t in m.state_dict().values():
                t.copy_(torch.from_numpy(rng.normal(0, 1, tuple(t.shape)).astype(np.float32)))
    e0 = {k: v.numpy().copy() for k, v in ema.state_dict().items()}
    d = pb.ema_decay_at(3, 0.9995)
    pb.ema_update(ema, model, d)
    for k, v in model.state_dict().items():
        want = jnp.asarray(e0[k]) * jnp.float32(d) + jnp.asarray(v.numpy()) * (1 - jnp.float32(d))
        np.testing.assert_allclose(ema.state_dict()[k].numpy(), np.asarray(want), rtol=1e-7,
                                   atol=1e-7, err_msg=k)


def _pair(nc=3, img=64, seed=0):
    jm = JPB.build_classifier(BACKBONE, nc, jnp.float32)
    x = np.random.RandomState(seed).normal(0, 1, (4, img, img, 3)).astype(np.float32)
    params, bs = random_vars(jm, x)
    port = load_flax(pb.build_classifier(BACKBONE, nc), params, bs)
    return jm, port, params, bs, x


def test_classifier_fp32_forward_and_grads_match_jax():
    jm, port, params, bs, x = _pair()
    labels = np.array([0, 1, 2, 1])

    def jax_loss(p):
        lg = jm.apply({"params": p, "batch_stats": bs}, jnp.asarray(x), train=False)
        onehot = optax.smooth_labels(jax.nn.one_hot(labels, 3), 0.1)
        return optax.softmax_cross_entropy(lg, onehot).mean(), lg

    (want, want_lg), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    port.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    lg = port(xt)
    loss = pb.smoothed_cross_entropy(lg, torch.from_numpy(labels), 0.1)
    names = [n for n, _ in port.named_parameters()]
    g = torch.autograd.grad(loss, [p for _, p in port.named_parameters()])
    got_g = to_flax_params(port, dict(zip(names, g)))
    scale = lambda a: np.abs(np.asarray(a)).max()
    np.testing.assert_allclose(lg.detach().numpy(), want_lg, atol=1e-4 * scale(want_lg))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got_g)[0],
                            jax.tree.leaves(want_g)):
        np.testing.assert_allclose(a, b, atol=1e-4 * scale(b) + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_classifier_train_mode_matches_jax():
    jm, port, params, bs, x = _pair(seed=1)
    want, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    scale = lambda a: np.abs(np.asarray(a)).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * scale(want))
    _, got_bs = to_flax(port)
    for a, b in zip(jax.tree.leaves(got_bs), jax.tree.leaves(mut["batch_stats"])):
        np.testing.assert_allclose(a, b, atol=1e-3 * scale(b))


def test_pretrain_checkpoint_loads_in_both_packages(folder, tmp_path, monkeypatch, capsys):
    out = pb.main(["--data", folder, "--backbone", BACKBONE, "--out",
                   str(tmp_path / "bb.ckpt"), "--epochs", "2", "--batch_size", "4",
                   "--img_size", "32", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "epoch 1: val top-1" in log and f"wrote {out}" in log
    sd, meta = jax_load_checkpoint(out)
    assert meta == {"backbone": BACKBONE, "source": "pretrain_backbone", "num_classes": 2,
                    "epochs": 2, "img_size": 32, "classes": ["class_0", "class_1"]}
    jm = JPB.build_classifier(BACKBONE, 2, jnp.bfloat16)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    for coll in ("params", "batch_stats"):
        want = jax.tree.map(lambda s: s.shape, shapes[coll]["backbone"])
        assert jax.tree.map(np.shape, sd[coll]) == want
        assert all(np.all(np.isfinite(a)) for a in jax.tree.leaves(sd[coll]))

    # JAX's loop grafts it onto a detector's variables (loop.py:219-224)
    cfg = {"model": {"arch": "YOLOLiteMS_CPU", "backbone": BACKBONE, "num_classes": 3,
                     "depth_multiple": 0.65, "width_multiple": 0.6, "fpn_channels": 160},
           "training": {"img_size": 64}}
    det = jax.eval_shape(lambda k, x: jax_build(cfg, dtype=jnp.float32).init(k, x, train=False),
                         jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    for coll in ("params", "batch_stats"):
        graft = sd[coll].get("backbone", sd[coll])
        assert jax.tree.map(np.shape, graft) == \
            jax.tree.map(lambda s: s.shape, det[coll]["backbone"])

    # the port's loop: the backbone at step 0 is the checkpoint's
    import chip_smoke
    from yololite_tpu_torch.api import YoloLite
    from yololite_tpu_torch.train import steps
    data = chip_smoke.make_synth_set(str(tmp_path / "s"), 4, 2, w=80, h=60)
    seen = []
    real = steps.Trainer.train_step

    def first_step(self, state, batch, lr_vec):
        if not seen:
            seen.append(jax.tree.map(np.array, to_flax(state.model)))   # copies
        return real(self, state, batch, lr_vec)

    monkeypatch.setattr(steps.Trainer, "train_step", first_step)
    YoloLite("edge_n", device="cpu").train(data=data, epochs=1, batch_size=4, img_size=64,
                                           workers=0, run_dir=str(tmp_path / "runs"),
                                           pretrained_backbone=out)
    p, bs = seen[0]
    for got, want in ((p["backbone"], sd["params"]), (bs["backbone"], sd["batch_stats"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
