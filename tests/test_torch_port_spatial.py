"""Spatial parallelism of the port on the CPU (gloo): the image height split
over ranks (`parallel/spatial.py`, JAX's mesh `spatial` axis) against JAX's
single-device step, the port at world 1, and each layer unsharded.

Two spawned runs share every case (`runs` starts both at once): four ranks
hold JAX's tiny config (test_parallel.py: 64 px, b4) at n_data 2 x
n_spatial 2 and at 1 x 4 (P5 two rows over four ranks: 1, 1, 0, 0; the
discarded P6 branch one row), the eval step at 2 x 2, and every layer kind
over the first three ranks (a subgroup); two ranks hold every layer kind at
1 x 2, the eval step, a segmentation step and a 1-epoch `train_from_config`
with `spatial_parallel: 2` joined to their group. Each rank computes its
own world-1 references. JAX starts from the port's seeded weights, carried
across by the port's converter.

Measured on the CPU: the fp32 steps read 8.6e-8 (2 x 2) and 2.6e-7 (1 x 4)
from JAX's loss; fp64 steps give world 1's loss bit for bit (the loss is
fp32, from gathered maps equal to ~1e-16) and its gradients, a few
BatchNorm biases' analytically zero gradients reading round-off (1e-15) in
both, hence the 1e-14 of the whole gradient's norm added to each bound;
fp64 layers equal their unsharded forms to ~3e-15, BatchNorm's running
statistics to ~2e-9 (the single process takes them in fp32,
`torch.var_mean` of x.float()). The loop's losses and checkpoint agree as
the data axis's do (tests/test_torch_port_ddp_loop.py).
"""

import copy
import csv
import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from yololite_tpu_torch.config import load_configs
from yololite_tpu_torch.models import layers
from yololite_tpu_torch.models.backbones import build_backbone
from yololite_tpu_torch.models.detector import build_model_from_config, init_weights
from yololite_tpu_torch.ops import quant
from yololite_tpu_torch.parallel import dist as pdist
from yololite_tpu_torch.parallel import spatial as pspatial
from yololite_tpu_torch.train import loop
from yololite_tpu_torch.train.checkpoint import load_checkpoint
from yololite_tpu_torch.train.steps import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 64
TIMEOUT_S = 300
JAX_LOSS_RTOL = 2e-4        # test_parallel.py's bound for JAX's spatial mesh
FP64_REL = 1e-10            # fp64 loss and gradients against world 1
LAYER_ATOL = 1e-12          # fp64 layer outputs and input gradients (measured ~3e-15)
BN_STATS_ATOL = 1e-6        # running stats: world 1 takes them in fp32 (measured ~2e-9)
QUANT_ATOL = 1e-5           # the fake-quant conv computes in fp32
FAMILY_REL = 1e-9           # a backbone's stages, of their max (measured <= 6e-12: train-mode
                            # BatchNorm over 1 x 2 x 2 deep maps amplifies fp64 round-off)
LOOP_RTOL = 1e-5            # the loop's losses
CKPT_ATOL = 1e-3            # checkpoint weights: Adam's first updates (ddp_loop's bounds)
CKPT_TYPICAL = 1e-5         # ... and all but 0.1% of them within this
LAYOUTS = {"2x2": 2, "1x4": 4}          # name -> n_spatial at world 4
FAMILIES = ("mobilenetv4_conv_small_050", "tf_efficientnet_lite0", "tf_efficientnetv2_b0",
            "resnet18", "convnextv2_tiny", "cs3darknet_focus_s", "hgnetv2_b0",
            "mobilenetv3_large_100")


# --------------------------------------------------------------------------- #
# Configurations, steps and layer cases
# --------------------------------------------------------------------------- #

def _tiny(**training):
    from test_parallel import _tiny_cfg
    cfg = _tiny_cfg(img=IMG)
    cfg["training"].update(training)
    return cfg


def _seg():
    cfg = _tiny()
    cfg["model"] = dict(cfg["model"], with_masks=True, num_prototypes=8)
    return cfg


def _batch(seg=False):
    from test_parallel import _batch as jax_batch
    b = jax_batch(4, img=IMG)
    if seg:
        b["masks"] = (np.random.RandomState(3).rand(4, 4, 16, 16) > 0.5).astype(np.uint8)
    return b


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_step(cfg, batch, dp=None, dtype=torch.float64, flax=None):
    """One train step of the port: scalar metrics, the gradients handed to
    the optimizer, the collectives, the state's digest."""
    model = build_model_from_config(cfg)
    if flax is None:
        model = init_weights(model, 0).to(dtype)
    tr = Trainer(model, cfg, total_updates=10, device="cpu", parallel=dp)
    st = tr.state_from_weights(*flax) if flax is not None else tr._make_state()
    grads, apply = [], tr._apply_grads

    def keep(state, g, lr_vec):
        grads.append([x.detach().double().numpy().copy() for x in g])
        return apply(state, g, lr_vec)

    tr._apply_grads = keep
    rows = batch if dp is None else {k: v[dp.batch_rows(len(v))] for k, v in batch.items()}
    pdist.reset_calls()
    st, m = tr.train_step(st, tr.put_batch(rows), tr.lr_vector(1e-3))
    return {"metrics": {k: float(v) for k, v in m.items() if v.dim() == 0},
            "grads": grads[0], "calls": dict(pdist.CALLS),
            "digest": _digest(st.model.state_dict().values())}


def run_eval(cfg, batch, dp=None):
    """eval_step of seeded fp64 weights: val loss and detections."""
    model = init_weights(build_model_from_config(cfg), 0).double()
    tr = Trainer(model, cfg, device="cpu", parallel=dp)
    rows = batch if dp is None else {k: v[dp.batch_rows(len(v))] for k, v in batch.items()}
    metrics, dets = tr.eval_step(tr.model, tr.put_batch(rows))
    return {"total": float(metrics["total"]), "dets": {k: v.numpy() for k, v in dets.items()}}


class _Up(torch.nn.Module):
    def __init__(self, target):
        super().__init__()
        self.target = target

    def forward(self, x):
        return layers.upsample_nearest_to(x, self.target)


def _layer_cases():
    """name -> (module factory, input shape): every layer kind that reads
    rows it does not own, at narrow widths and odd heights."""
    cases = {}
    for k, s in ((1, 1), (1, 2), (2, 2), (3, 1), (3, 2), (4, 4), (5, 1), (5, 2), (7, 1),
                 (7, 2)):
        cases[f"conv_k{k}s{s}"] = (lambda k=k, s=s: layers.ConvBNAct(3, 4, k, s), (2, 3, 17, 9))
        cases[f"dw_k{k}s{s}"] = (lambda k=k, s=s: layers.ConvBNAct(4, 4, k, s, groups=4),
                                 (2, 4, 17, 9))
    cases["fake_quant_conv"] = (lambda: quant.fake_quant(layers.ConvBNAct(6, 8, 3, 1)),
                                (2, 6, 17, 9))
    cases["focus"] = (lambda: layers.Focus(3, 5), (2, 3, 18, 10))
    cases["upsample_x2"] = (lambda: _Up((34, 18)), (2, 4, 17, 9))
    cases["upsample_odd"] = (lambda: _Up((23, 13)), (2, 4, 17, 9))
    cases["squeeze_excite"] = (lambda: layers.MBConv(4, 4, expand=2.0, kernel=3,
                                                     se_ratio=0.25), (2, 4, 17, 9))
    cases["grn"] = (lambda: layers.ConvNeXtV2Block(4, 4), (2, 4, 17, 9))
    return cases


def _layer_errors(name, sp):
    """A layer at fp64 in train mode on this rank's rows against the
    unsharded layer: max abs differences of the output, the input gradient
    and the BatchNorm running statistics."""
    factory, shape = _layer_cases()[name]
    torch.manual_seed(0)
    mod = factory().double().train()
    for m in mod.modules():
        if isinstance(m, layers.GRN):
            torch.nn.init.normal_(m.gamma)
            torch.nn.init.normal_(m.beta)
    ref = copy.deepcopy(mod)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    xr, xs = x.clone().requires_grad_(), x.clone().requires_grad_()
    want = ref(xr)
    upstream = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    (want * upstream).sum().backward()
    local, full = pspatial.forward(mod, xs, sp)
    got = pspatial.gather(local, full.shape[2], 2, sp)
    (got * upstream).sum().backward()
    gx = pspatial.spatial_sum(xs.grad.clone(), sp)
    stats = [(a - b).abs().max().item() for (k, a), (_, b) in
             zip(mod.state_dict().items(), ref.state_dict().items()) if "running" in k]
    return {"out": (got - want).abs().max().item(), "grad": (gx - xr.grad).abs().max().item(),
            "bn": max(stats, default=0.0)}


def _family_errors(name, sp):
    """The backbone's train-mode fp64 forward at 64 px, each stage gathered,
    against world 1."""
    torch.manual_seed(0)
    mod = build_backbone(name)[0].double().train()
    ref = copy.deepcopy(mod)
    x = torch.randn(1, 3, IMG, IMG, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    with torch.no_grad():
        want = ref(x)
        local, full = pspatial.forward(mod, x, sp)
        got = [pspatial.gather(t, f.shape[2], 2, sp) for t, f in zip(local, full)]
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))


# --------------------------------------------------------------------------- #
# The ranks
# --------------------------------------------------------------------------- #

def _join(rank, port, world):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(world)
    pdist.init_distributed(f"localhost:{port}", world, rank, backend="gloo")


def _four(rank, port, job):
    """(a) the 2 x 2 and 1 x 4 steps; (b) every layer kind and backbone
    family over ranks 0-2."""
    _join(rank, port, 4)
    try:
        out = {}
        three = torch.distributed.new_group([0, 1, 2])
        if rank == 0:       # the world-1 references, in this process
            out["world1"] = run_step(_tiny(), job["batch"])
        for name, n_sp in LAYOUTS.items():
            dp = pdist.DataParallel.from_group(n_sp)
            out[f"jax_{name}"] = run_step(_tiny(), job["batch"], dp, flax=job["flax"])
            out[f"fp64_{name}"] = run_step(_tiny(), job["batch"], dp)
        out["eval_2x2"] = run_eval(_tiny(), job["batch"], pdist.DataParallel.from_group(2))
        if rank < 3:
            sp = pspatial.Spatial(3, rank, three)
            out["layers"] = {name: _layer_errors(name, sp) for name in _layer_cases()}
            out["families"] = {name: _family_errors(name, sp) for name in FAMILIES}
        torch.distributed.barrier()
    finally:
        pdist.shutdown()
    return out


def _two(rank, port, job):
    """(b) every layer kind at 1 x 2; (c) the eval step; (d) a seg step; (e)
    a 1-epoch train_from_config with spatial_parallel 2 joined here."""
    _join(rank, port, 2)
    try:
        sp = pspatial.Spatial(2, rank, None)
        out = {"layers": {name: _layer_errors(name, sp) for name in _layer_cases()}}
        dp = pdist.DataParallel.from_group(2)
        out["eval_1x2"] = run_eval(_tiny(), job["batch"], dp)
        out["seg"] = run_step(_seg(), job["seg_batch"], dp)
        if rank == 0:
            out["eval_world1"] = run_eval(_tiny(), job["batch"])
            out["seg_world1"] = run_step(_seg(), job["seg_batch"])
        pdist.reset_calls()
        res = loop.train_from_config(job["loop_cfgs"][rank], device="cpu")
        out["loop"] = {"history": res["history"], "coco": res.get("coco"),
                       "calls": dict(pdist.CALLS)}
    finally:
        pdist.shutdown()
    return out


def _loop_config(data, log_dir, **training):
    cfg = load_configs(os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                       os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
                       data, make_run_dir=False)
    cfg["training"].update(epochs=1, batch_size=4, img_size=IMG, augment=True, amp=False,
                           num_workers=2, data_parallel=1, pretrained_backbone=os.path.join(
                               ROOT, "weights", "mnv4_050_cls20.ckpt"), **training)
    cfg["logging"] = {"log_dir": str(log_dir)}
    return cfg


def _seeded_flax():
    """The port's seeded tiny model as flax trees of numpy arrays (copies:
    `to_flax` of a CPU model gives views), for both packages."""
    from yololite_tpu_torch.convert import to_flax

    def copied(tree):
        return {k: copied(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}
    return tuple(copied(t) for t in to_flax(init_weights(build_model_from_config(_tiny()), 0)))


def _jax_loss(flax):
    """JAX's single-device Trainer.train_step loss from `flax`."""
    import jax.numpy as jnp
    from yololite_tpu.models.detector import build_model_from_config as jax_build
    from yololite_tpu.train.steps import Trainer as JaxTrainer
    cfg = _tiny()
    trainer = JaxTrainer(jax_build(cfg, dtype=jnp.float32), cfg, total_updates=10, mesh=None)
    state = trainer.state_from_weights(*flax)
    _, m = trainer.train_step(state, trainer.put_batch(_batch()), trainer.lr_vector(1e-3))
    return float(m["total"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank and two-rank runs, JAX's step and one process's loop
    run, all at once (one torch thread each)."""
    from chip_smoke import make_synth_set
    tmp = tmp_path_factory.mktemp("spatial")
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        data = make_synth_set(str(tmp / "set"), n_train=8, n_val=6, w=80, h=60)
        out, errors, workers = {}, [], []

        def spawn(n, fn, job):
            try:
                out[n] = pdist.spawn(fn, (pdist.free_port(), job), n, timeout=TIMEOUT_S)
            except BaseException as e:      # re-raised in the test process below
                errors.append(e)

        def start(*args):
            workers.append(threading.Thread(target=spawn, args=args))
            workers[-1].start()

        flax = _seeded_flax()
        start(2, _two, {"batch": _batch(), "seg_batch": _batch(seg=True),
                        "loop_cfgs": [_loop_config(data, tmp / f"loop{r}", spatial_parallel=2)
                                      for r in range(2)]})
        start(4, _four, {"batch": _batch(), "flax": flax})
        out["jax_loss"] = _jax_loss(flax)
        out["loop_single"] = loop.train_from_config(_loop_config(data, tmp / "single"),
                                                    device="cpu")
        for w in workers:
            w.join()
        if errors:
            raise errors[0]
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env
    out["tmp"] = tmp
    return out


# --------------------------------------------------------------------------- #
# (a) steps
# --------------------------------------------------------------------------- #

def _grads_close(want, got, rel):
    """Each gradient to `rel` of its own norm, plus fp64 round-off (1e-14
    of the whole gradient's norm) for the analytically zero ones."""
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want))
    for i, (w, g) in enumerate(zip(want, got)):
        err, bound = np.linalg.norm(g - w), rel * np.linalg.norm(w) + 1e-14 * total
        assert err <= bound, (i, err, bound)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_equals_jax_single_device(runs, layout):
    """(a) the port at n_data 2 x n_spatial 2 and 1 x 4 against JAX's
    single-device train_step from the same seeded weights (the port's,
    carried across by its converter): the loss to test_parallel.py's rtol;
    every rank reads the same metrics."""
    ranks = runs[4]
    got = ranks[0][f"jax_{layout}"]["metrics"]["total"]
    np.testing.assert_allclose(got, runs["jax_loss"], rtol=JAX_LOSS_RTOL)
    for r in ranks[1:]:
        assert r[f"jax_{layout}"]["metrics"] == ranks[0][f"jax_{layout}"]["metrics"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_equals_world_one_fp64(runs, layout):
    """(a) the same layouts against the port at world 1 in fp64: the loss
    and every gradient to 1e-10 relative; the ranks' states equal."""
    ranks = runs[4]
    want, got = ranks[0]["world1"], ranks[0][f"fp64_{layout}"]
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= FP64_REL * max(abs(v), 1e-30), k
    _grads_close(want["grads"], got["grads"], FP64_REL)
    assert len({r[f"fp64_{layout}"]["digest"] for r in ranks}) == 1
    calls = got["calls"]
    # every conv that reads other rows exchanges them forward (and those the
    # loss reaches backward); one gather a level
    assert calls["halo"] > 0 and calls["gather"] == 3, calls


def test_mesh_layout():
    """Rank r at (d, s) = divmod(r, n_spatial); a data index's ranks hold the
    same rows; the row split is GSPMD's ceil chunks, empty ranges last."""
    for rank in range(4):
        dp = pdist.DataParallel(4, rank, rank, 4, n_spatial=2)
        assert (dp.data_index, dp.spatial_index) == divmod(rank, 2)
        assert dp.n_data == 2
        assert dp.batch_rows(8) == dp.world_rows(8) == slice(4 * (rank // 2), 4 * (rank // 2) + 4)
    assert pspatial.split(161, 2) == [(0, 81), (81, 161)]
    assert pspatial.split(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert pspatial.split(64, 4) == [(0, 16), (16, 32), (32, 48), (48, 64)]


def test_train_cli_spawns_the_mesh(tmp_path, monkeypatch):
    """`tools.train --data_parallel 2 --spatial_parallel 2 --device cpu`
    spawns 4 ranks laid out as make_mesh's reshape(n_data, n_spatial); the
    spawn is recorded, not run (the loop itself: test_loop_equals_one_process)."""
    from chip_smoke import make_synth_set
    from yololite_tpu_torch.tools import train as train_tool
    data = make_synth_set(str(tmp_path / "set"), n_train=2, n_val=1, w=32, h=24)
    spawned = []

    def record(config, device, n):
        tr = config["training"]
        spawned.append((device, n, [divmod(r, int(tr["spatial_parallel"])) for r in range(n)],
                        [pdist.DataParallel(n, r, r, n, 2).batch_rows(4) for r in range(n)]))
        return {}

    monkeypatch.setattr(loop, "_spawn", record)
    monkeypatch.chdir(tmp_path)
    train_tool.main(["--model", os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                     "--data", data, "--batch_size", "4", "--data_parallel", "2",
                     "--spatial_parallel", "2", "--device", "cpu"])
    halves = [slice(0, 2), slice(0, 2), slice(2, 4), slice(2, 4)]
    assert spawned == [("cpu", 4, [(0, 0), (0, 1), (1, 0), (1, 1)], halves)]


@pytest.mark.parametrize("kind", ["conv_k3s2", "conv_k4s4", "dw_k7s1", "focus",
                                  "upsample_odd", "squeeze_excite", "grn"])
def test_one_rank_path_equals_layer(kind):
    """The ranks' code at n_spatial 1 (explicit zero rows and convs without
    row padding, no collective) equals the layer, in this process."""
    got = _layer_errors(kind, pspatial.Spatial(1, 0, None))
    assert got["out"] <= LAYER_ATOL and got["grad"] <= LAYER_ATOL, got
    assert got["bn"] <= BN_STATS_ATOL, got


def _autograd_global_norm(x, w, b, shift, count, eps=1e-5):
    """BatchNorm's global path written as plain autograd formulas."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = xf.shape[1]
    d = xf - shift.view(1, c, 1, 1)
    sums = torch.cat([d.sum(dim=(0, 2, 3)), (d * d).sum(dim=(0, 2, 3))])
    d_mean = sums[:c] / count
    mean = shift + d_mean
    var = torch.clamp_min(sums[c:] / count - d_mean * d_mean, 0.0)
    scale = torch.rsqrt(var + eps) * w.to(xf.dtype)
    y = (xf - mean.view(1, c, 1, 1)) * scale.view(1, c, 1, 1) + b.to(xf.dtype).view(1, c, 1, 1)
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_global_batchnorm_equals_its_autograd_formulas(dtype):
    """BatchNorm's global path (`layers._GlobalNorm`, which saves x and a
    few vectors) gives the output and gradients that autograd through its
    formulas gives (which keeps fp32 copies of x), bit for bit: odd and
    empty maps, channels_last, a count beyond this rank's values."""
    for trial in range(12):
        gen = torch.Generator().manual_seed(trial)
        n, c, h, w = (int(v) for v in torch.randint(1, 9, (4,), generator=gen))
        h = 0 if trial == 3 else h
        x = (torch.randn(n, c, h, w, generator=gen) * 3 + 2).to(dtype)
        if trial % 2:
            x = x.contiguous(memory_format=torch.channels_last)
        wdt = torch.promote_types(dtype, torch.float32)
        weight, bias = (torch.randn(c, generator=gen, dtype=wdt) for _ in range(2))
        shift = torch.randn(c, generator=gen, dtype=wdt) * 0.5 + 2
        upstream = torch.randn(x.shape, generator=gen).to(dtype)
        count = 2 * max(1, n * h * w)
        got, want = [], []
        for fn, out in ((lambda *a: layers._GlobalNorm.apply(*a, lambda t: t, 1e-5)[0], got),
                        (_autograd_global_norm, want)):
            args = [t.clone().requires_grad_() for t in (x, weight, bias)]
            y = fn(*args, shift, count)
            out += [y] + list(torch.autograd.grad(y, args, upstream))
        for a, b in zip(got, want):
            assert torch.equal(a, b), trial


# --------------------------------------------------------------------------- #
# (b) layers and backbones
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", list(_layer_cases()))
def test_layer_kind_equals_unsharded(runs, n, kind):
    """(b) fp64 forward and input gradient of the layer over n ranks (odd
    heights) equal the unsharded layer's; BatchNorm statistics global."""
    errs = [r["layers"][kind] for r in (runs[4][:3] if n == 3 else runs[2])]
    atol = QUANT_ATOL if kind == "fake_quant_conv" else LAYER_ATOL
    for e in errs:
        assert e["out"] <= atol and e["grad"] <= atol, e
        assert e["bn"] <= BN_STATS_ATOL, e


@pytest.mark.parametrize("family", FAMILIES)
def test_backbone_family_forward_equals_world_one(runs, family):
    """(b) one train-mode forward per backbone family at 64 px over 3 ranks
    (empty shards at the deep stages), every stage equal to world 1."""
    for r in runs[4][:3]:
        assert r["families"][family] <= FAMILY_REL, (family, r["families"][family])


# --------------------------------------------------------------------------- #
# (c)-(e) eval, seg, the loop
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_eval_step_detections_equal_world_one(runs, layout):
    """(c) eval_step under 1 x 2 and 2 x 2 (decode and batched_nms on every
    rank): the val loss (over the data ranks) and every rank's detections
    (of its data index's images) equal world 1's."""
    want = runs[2][0]["eval_world1"]
    ranks = runs[2] if layout == "1x2" else runs[4]
    for i, r in enumerate(ranks):
        got = r[f"eval_{layout}"]
        rows = slice(0, 4) if layout == "1x2" else slice(2 * (i // 2), 2 * (i // 2) + 2)
        assert abs(got["total"] - want["total"]) <= 1e-6 * abs(want["total"])
        for k in ("valid", "classes", "idx"):
            np.testing.assert_array_equal(got["dets"][k], want["dets"][k][rows], err_msg=k)
        for k in ("boxes", "scores"):
            np.testing.assert_allclose(got["dets"][k], want["dets"][k][rows], rtol=1e-6,
                                       atol=1e-6)
        assert got["dets"]["valid"].any()


def test_segmentation_step_equals_world_one(runs):
    """(d) a seg step at 1 x 2, the mask term on gathered prototypes: the
    loss and gradients equal world 1's in fp64."""
    want = runs[2][0]["seg_world1"]
    got = runs[2][0]["seg"]
    assert "mask" in got["metrics"]
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= FP64_REL * max(abs(v), 1e-30), k
    _grads_close(want["grads"], got["grads"], FP64_REL)
    assert got["calls"]["gather"] == 4          # three levels and the prototypes


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def test_loop_equals_one_process(runs):
    """(e) 1 epoch of train_from_config with spatial_parallel 2 (joined to
    the ranks' group): history, metrics.csv, the final evaluation and the
    best checkpoint equal one process's run; rank 1 wrote nothing."""
    tmp, single = runs["tmp"], runs["loop_single"]
    got = runs[2][0]["loop"]
    for key in ("train_loss", "val_loss", "step_loss"):
        np.testing.assert_allclose(got["history"][key], single["history"][key],
                                   rtol=LOOP_RTOL, err_msg=key)
    assert runs[2][1]["loop"]["history"] == got["history"]
    a, b = _rows(tmp / "single"), _rows(tmp / "loop0")
    assert [r["epoch"] for r in a] == [r["epoch"] for r in b] == ["1"]
    for k, v in single["coco"].items():
        assert abs(got["coco"][k] - v) <= 1e-6, k
    want, _ = load_checkpoint(str(tmp / "single" / "weights" / "best_model_state.ckpt"))
    have, _ = load_checkpoint(str(tmp / "loop0" / "weights" / "best_model_state.ckpt"))
    diffs = np.concatenate([np.abs(x - y).ravel() for x, y in
                            zip(_leaves(want["params"]), _leaves(have["params"]))])
    assert diffs.max() <= CKPT_ATOL, diffs.max()
    assert np.mean(diffs > CKPT_TYPICAL) <= 1e-3, np.mean(diffs > CKPT_TYPICAL)
    assert not os.path.exists(tmp / "loop1")
    assert got["calls"]["halo"] > 0 and got["calls"]["gather"] > 0
