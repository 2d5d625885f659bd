"""Data-parallel training of the port on the CPU: two processes over gloo
(spawned with torch.multiprocessing on a free port) against the port's single
process at the same global batch, and against JAX's 2-device mesh, on
test_parallel.py's tiny config (32 px, b8) and seeded batches.

Measured on this CPU (gradient differences are the relative L2 norm of the
difference over the whole gradient vector):

  fp32 step, 2 ranks vs 1 process  loss 1.8e-6 rel, metrics 9.8e-6 rel,
                                   gradients 9.0e-5, BN running stats
                                   1.5e-5 abs (the same with accumulate: 2)
  fp64 step                        metrics 8e-8 rel (the loss is fp32),
                                   gradients 1.2e-13, BN stats 5e-8 abs
  fp64 with qat / device_augment   scales equal, gradients 2e-7 (the fake
  / seg                            quant is fp32) / 1.2e-13 / 1.8e-13

In fp32 the train-mode gradient of this model is only good to ~1e-4: the
single-process step's own gradient is 1.2e-4 from an fp64 one (BatchNorm
divides by batch standard deviations of 8-element channels at the deep
levels), and a QAT forward is chaotic at that level (a value that moves by
an ulp across a rounding boundary moves a level; activation scales part by
up to 14% at the deep convs). So the reduction itself is held in fp64, where
only it differs (gradients 1e-5, the scales 1e-6), and fp32 to what it can
give: the loss 1e-5, the metrics 3e-5, gradients 5e-4.

The ranks run every scenario in one spawned run (the `spawned` fixture); the
tests read its records."""

import hashlib
import os

import numpy as np
import pytest
import torch

from yololite_tpu_torch.data.dataset import YoloDataset
from yololite_tpu_torch.data.loader import DataLoader
from yololite_tpu_torch.eval.evaluate import collect_coco, evaluate_model
from yololite_tpu_torch.models import layers
from yololite_tpu_torch.models.detector import build_model_from_config, init_weights
from yololite_tpu_torch.ops import quant
from yololite_tpu_torch.parallel import dist as pdist
from yololite_tpu_torch.train import steps
from yololite_tpu_torch.train.steps import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANKS_TIMEOUT_S = 240
EVAL_IMG = 64

LOSS_RTOL = 1e-5            # the loss, ranks vs one process (fp32: 1.8e-6)
METRIC_RTOL = 3e-5          # the other metrics (fp32: 9.8e-6)
GRAD_REL = 5e-4             # fp32 gradients (measured 9.0e-5)
GRAD_REL_FP64 = 1e-5        # fp64 gradients (measured < 1e-12)
BN_ATOL = 1e-4              # fp32 running mean/var (measured 1.5e-5)
BN_ATOL_FP64 = 1e-6
JAX_LOSS_RTOL = 2e-4        # as test_parallel.py holds JAX's mesh to itself
JAX_GRAD_REL = 1e-3


def _grad_rel(want, got) -> float:
    """|got - want| / |want| over the whole gradient vector (L2)."""
    num = sum(float(((np.asarray(g, np.float64) - np.asarray(w, np.float64)) ** 2).sum())
              for w, g in zip(want, got))
    den = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)
    return float(np.sqrt(num / den))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _rows(batch, dp):
    if dp is None:
        return batch
    sl = dp.batch_rows(len(batch["image"]))
    return {k: v[sl] for k, v in batch.items()}


def run_steps(cfg, batches, dp=None, dtype=torch.float32, flax=None):
    """Train steps of the port on `batches` (this process's rows of each):
    per step the scalar metrics, the gradients handed to the optimizer, the
    BatchNorm running statistics, the fake-quant activation scales and the
    device-augmented images; the final state's digests."""
    torch.manual_seed(0)
    model = build_model_from_config(cfg)
    if dtype != torch.float32:
        model = init_weights(model, 0).to(dtype)
    tr = Trainer(model, cfg, total_updates=10, device="cpu", parallel=dp)
    st = (tr.state_from_weights(*flax) if flax is not None else
          tr._make_state() if dtype != torch.float32 else tr.init_state(0))
    rec = {"metrics": [], "grads": [], "bn": [], "scales": [], "images": []}
    apply_grads, div127, augment = tr._apply_grads, quant._div127, steps.photometric_augment

    def keep_grads(state, grads, lr_vec):
        rec["grads"].append([g.detach().double().numpy().copy() for g in grads])
        return apply_grads(state, grads, lr_vec)

    def keep_scale(t):
        out = div127(t)
        if t.numel() == 1:                  # the activation scale
            rec["scales"].append(float(out.detach()))
        return out

    def keep_images(*a, **kw):
        out = augment(*a, **kw)
        rec["images"].append(out.numpy().copy())
        return out

    tr._apply_grads = keep_grads
    quant._div127, steps.photometric_augment = keep_scale, keep_images
    try:
        for b in batches:
            st, m = tr.train_step(st, tr.put_batch(_rows(b, dp)), tr.lr_vector(1e-3))
            rec["metrics"].append({k: float(v) for k, v in m.items() if v.dim() == 0})
            rec["bn"].append({k: v.double().numpy().copy()
                              for k, v in st.model.state_dict().items() if "running" in k})
    finally:
        quant._div127, steps.photometric_augment = div127, augment
    opt = st.opt
    rec["digest"] = {
        "model": _digest(st.model.state_dict().values()),
        "ema": _digest(st.ema.state_dict().values()),
        "opt": _digest([t for ts in (opt.mu, opt.nu, opt.trace) if ts is not None
                        for t in ts]),
        "counters": (st.updates, st.micro, opt.count)}
    rec["names"] = [n for n, _ in st.model.named_parameters()]
    return rec


def eval_results(data_yaml_dirs, dp=None, out_dir=None):
    """evaluate_model of seeded edge_n @64 on the self-labelled val set, b4
    (the last batch padded): COCO stats, best F1/conf."""
    images, labels = data_yaml_dirs
    cfg = _edge_cfg()
    model = init_weights(build_model_from_config(cfg), 0).eval()
    tr = Trainer(model, cfg, device="cpu", parallel=dp)
    ds = YoloDataset(images, labels, img_size=EVAL_IMG, is_train=False, augment=False)
    loader = DataLoader(ds, 4, shuffle=False, drop_last=False,
                        rows=None if dp is None else dp.world_rows(4))
    res = evaluate_model(tr, model, loader, out_dir, 3, EVAL_IMG, run_bench=False)
    return {"coco": res["coco"], "best_f1": res["best_f1"], "best_conf": res["best_conf"]}


def _worker(rank, port, scenarios):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(WORLD)
    pdist.init_distributed(f"localhost:{port}", WORLD, rank, backend="gloo")
    try:
        dp = pdist.DataParallel.from_group()
        out = {}
        for name, (kind, kw) in scenarios.items():
            if kind == "steps":
                out[name] = run_steps(dp=dp, **kw)
            else:
                out[name] = eval_results(kw["dirs"], dp, kw["out_dir"])
            out[name + "_calls"] = dict(pdist.CALLS)
            pdist.reset_calls()
    finally:
        pdist.shutdown()
    return out


# --------------------------------------------------------------------------- #
def _tiny(**training):
    from test_parallel import _tiny_cfg
    cfg = _tiny_cfg()
    cfg["training"].update(training)
    return cfg


def _batches(n, seg=False):
    from test_parallel import _batch
    out = []
    for s in range(n):
        b = _batch(8, seed=s)
        if seg:
            rng = np.random.RandomState(s)
            b["masks"] = (rng.rand(8, 4, 8, 8) > 0.5).astype(np.uint8)
        out.append(b)
    return out


def _seg_cfg():
    cfg = _tiny()
    cfg["model"] = dict(cfg["model"], with_masks=True, num_prototypes=8)
    return cfg


def _edge_cfg():
    from yololite_tpu_torch.config import read_yaml
    cfg = read_yaml(os.path.join(ROOT, "configs", "models", "edge_n.yaml"))
    cfg["model"]["num_classes"] = 3
    cfg.setdefault("training", {}).update(img_size=EVAL_IMG, amp=False)
    return cfg


def _jax_flax(cfg):
    """JAX's seeded init of the tiny model, as numpy trees."""
    import jax
    import jax.numpy as jnp
    from yololite_tpu.models.detector import build_model_from_config as jax_build
    from yololite_tpu.train.steps import Trainer as JaxTrainer
    model = jax_build(cfg, dtype=jnp.float32)
    st = JaxTrainer(model, cfg, total_updates=10, mesh=None).init_state(seed=0)
    def to_np(tree):        # plain dicts of numpy arrays (the ranks import no flax)
        if hasattr(tree, "items"):
            return {k: to_np(v) for k, v in tree.items()}
        return np.asarray(tree).copy()
    return to_np(st.params), to_np(st.batch_stats)


def _self_labelled(root):
    """A val set of 6 square 64 px images labelled with seeded edge_n's five
    best detections each: (images dir, labels dir)."""
    from chip_smoke import make_synth_set
    from yololite_tpu_torch.config import load_configs
    data = make_synth_set(os.path.join(root, "set"), n_train=4, n_val=6, w=EVAL_IMG,
                          h=EVAL_IMG)
    ds_cfg = load_configs(None, None, data, make_run_dir=False)["dataset"]
    cfg = _edge_cfg()
    model = init_weights(build_model_from_config(cfg), 0).eval()
    tr = Trainer(model, cfg, device="cpu")
    ds = YoloDataset(ds_cfg["val_images"], ds_cfg["val_labels"], img_size=EVAL_IMG,
                     is_train=False, augment=False)
    _, _, dets, _ = collect_coco(tr, model, DataLoader(ds, 4, shuffle=False, drop_last=False),
                                 EVAL_IMG, conf_th=0.001, iou_th=0.65)
    labels = os.path.join(root, "labels")
    os.makedirs(labels)
    for i, path in enumerate(ds.img_files):
        mine = sorted((d for d in dets if d["image_id"] == i + 1), key=lambda d: -d["score"])
        rows = [f"{d['category_id'] - 1} {(x + w / 2) / EVAL_IMG:.6f} {(y + h / 2) / EVAL_IMG:.6f} "
                f"{w / EVAL_IMG:.6f} {h / EVAL_IMG:.6f}\n"
                for d in mine[:5] for x, y, w, h in [d["bbox"]] if min(w, h) >= 1]
        stem = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(labels, stem + ".txt"), "w") as f:
            f.writelines(rows)
    return ds_cfg["val_images"], labels


def _scenarios(tmp):
    flax = _jax_flax(_tiny())
    return {
        "plain": ("steps", dict(cfg=_tiny(), batches=_batches(3))),
        "fp64": ("steps", dict(cfg=_tiny(), batches=_batches(1), dtype=torch.float64)),
        "jax": ("steps", dict(cfg=_tiny(), batches=_batches(1), flax=flax)),
        "acc2": ("steps", dict(cfg=_tiny(accumulate=2), batches=_batches(2))),
        "qat": ("steps", dict(cfg=_tiny(qat=True), batches=_batches(1), dtype=torch.float64)),
        "devaug": ("steps", dict(cfg=_tiny(device_augment=True, augment=True),
                                 batches=_batches(2), dtype=torch.float64)),
        "seg": ("steps", dict(cfg=_seg_cfg(), batches=_batches(1, seg=True),
                              dtype=torch.float64)),
        "eval": ("eval", dict(dirs=_self_labelled(os.path.join(tmp, "selflab")),
                              out_dir=os.path.join(tmp, "eval_dp"))),
    }


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(scenarios, rank records) of one spawned 2-rank run."""
    tmp = str(tmp_path_factory.mktemp("ddp"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scenarios = _scenarios(tmp)
        ranks = pdist.spawn(_worker, (pdist.free_port(), scenarios), WORLD,
                            timeout=RANKS_TIMEOUT_S)
    finally:
        torch.set_num_threads(threads)
    return scenarios, ranks


def _single(scenarios, name):
    kind, kw = scenarios[name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if kind == "steps":
            return run_steps(**kw)
        return eval_results(kw["dirs"], None, kw["out_dir"] + "_single")
    finally:
        torch.set_num_threads(threads)


def _check_step(want, got, step=0, grad_rel=GRAD_REL, bn_atol=BN_ATOL):
    for k, v in want["metrics"][step].items():
        np.testing.assert_allclose(got["metrics"][step][k], v, err_msg=k,
                                   rtol=LOSS_RTOL if k == "total" else METRIC_RTOL)
    rel = _grad_rel(want["grads"][step], got["grads"][step])
    assert rel < grad_rel, rel
    for k, v in want["bn"][step].items():
        np.testing.assert_allclose(got["bn"][step][k], v, atol=bn_atol, rtol=0, err_msg=k)
    return rel


def _bn_calls(cfg):
    """BatchNorm calls in one train step's forward, and those whose output
    the loss's gradient reaches (the all-reduces of a data-parallel step
    beside the gradient bucket and the metrics)."""
    tr = Trainer(build_model_from_config(cfg), cfg, device="cpu")
    st = tr.init_state(0)
    fwd, bwd = [], []

    def hook(mod, args, out):
        fwd.append(1)
        out.register_hook(lambda g: bwd.append(1))
    for m in st.model.modules():
        if isinstance(m, layers.BatchNorm):
            m.register_forward_hook(hook)
    total, _ = tr.forward_loss(st, tr.put_batch(_batches(1)[0]))
    tr.backward(st, total)
    return len(fwd), len(bwd)


# --------------------------------------------------------------------------- #
def test_two_rank_step_equals_single_process(spawned):
    """(a) loss, metrics, summed gradient and BatchNorm statistics at b8:
    fp32 to the measured tolerances, fp64 to 1e-5."""
    scenarios, ranks = spawned
    _check_step(_single(scenarios, "plain"), ranks[0]["plain"])
    want, got = _single(scenarios, "fp64"), ranks[0]["fp64"]
    _check_step(want, got, grad_rel=GRAD_REL_FP64, bn_atol=BN_ATOL_FP64)
    # one all-reduce a BatchNorm forward and one a backward, the gradient
    # bucket, the metrics; the start's broadcast
    fwd, bwd = _bn_calls(_tiny())
    assert ranks[0]["fp64_calls"]["all_reduce"] == fwd + bwd + 1 + 1


def test_two_rank_step_equals_jax_mesh(spawned):
    """(b) the same step from JAX's initial weights against JAX's
    Trainer(mesh=make_mesh(2)): its loss and train-mode gradient."""
    import jax
    import jax.numpy as jnp
    from yololite_tpu.models.detector import build_model_from_config as jax_build
    from yololite_tpu.parallel.mesh import make_mesh, replicate_tree
    from yololite_tpu.train.steps import Trainer as JaxTrainer, normalize_images
    from yololite_tpu_torch.convert import to_flax_params
    scenarios, ranks = spawned
    cfg = _tiny()
    batch = _batches(1)[0]
    params, stats = scenarios["jax"][1]["flax"]
    model = jax_build(cfg, dtype=jnp.float32)
    mesh = make_mesh(2)
    trainer = JaxTrainer(model, cfg, total_updates=10, mesh=mesh)

    def loss_of(p, b):
        x = normalize_images(b["image"], jnp.float32)
        outs, _ = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                              mutable=["batch_stats"])
        total, _ = trainer.loss(outs, {k: b[k] for k in ("boxes", "labels", "mask")})
        return total

    total, grads = jax.jit(jax.value_and_grad(loss_of))(
        replicate_tree(jax.tree.map(jnp.asarray, params), mesh), trainer.put_batch(batch))
    got = ranks[0]["jax"]
    np.testing.assert_allclose(got["metrics"][0]["total"], float(total), rtol=JAX_LOSS_RTOL)
    tmpl = build_model_from_config(cfg)
    tree = to_flax_params(tmpl, {n: torch.from_numpy(g) for n, g in
                                 zip(got["names"], got["grads"][0])})
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    rel = _grad_rel(leaves(grads), leaves(tree))
    assert rel < JAX_GRAD_REL, rel


def test_ranks_bitwise_equal_after_three_steps(spawned):
    """(c) parameters, EMA, optimizer state and counters on both ranks."""
    _, ranks = spawned
    assert ranks[0]["plain"]["digest"] == ranks[1]["plain"]["digest"]
    assert ranks[0]["plain"]["digest"]["counters"] == (3, 3, 3)
    for step in range(3):
        assert ranks[0]["plain"]["metrics"][step] == ranks[1]["plain"]["metrics"][step]


def test_accumulate_two_reduces_the_summed_gradient(spawned):
    """(d) accumulate: 2: one update from two micro-steps; the mean gradient
    it applies is the single process's."""
    scenarios, ranks = spawned
    want, got = _single(scenarios, "acc2"), ranks[0]["acc2"]
    assert len(want["grads"]) == len(got["grads"]) == 1
    assert _grad_rel(want["grads"][0], got["grads"][0]) < GRAD_REL
    assert ranks[0]["acc2"]["digest"] == ranks[1]["acc2"]["digest"]
    # the accumulated sum is reduced once, on the update's micro-step
    fwd, bwd = _bn_calls(_tiny())
    assert ranks[0]["acc2_calls"]["all_reduce"] == 2 * (fwd + bwd + 1) + 1


def test_qat_scales_are_global(spawned):
    """(e) qat: true: every fake-quant activation scale is the whole batch's
    (both ranks hold the single process's), and the step equals it."""
    scenarios, ranks = spawned
    want = _single(scenarios, "qat")
    for r in range(WORLD):
        got = ranks[r]["qat"]
        assert len(got["scales"]) == len(want["scales"]) > 0
        np.testing.assert_allclose(got["scales"], want["scales"], rtol=1e-6)
    _check_step(want, ranks[0]["qat"], grad_rel=GRAD_REL_FP64, bn_atol=BN_ATOL_FP64)


def test_device_augment_rows_equal_single_process(spawned):
    """(f) device_augment: each rank's augmented images are exactly its rows
    of the single process's, and the steps equal it."""
    scenarios, ranks = spawned
    want = _single(scenarios, "devaug")
    for r in range(WORLD):
        for step in range(2):
            rows = slice(r * 4, (r + 1) * 4)
            np.testing.assert_array_equal(ranks[r]["devaug"]["images"][step],
                                          want["images"][step][rows])
    _check_step(want, ranks[0]["devaug"], grad_rel=GRAD_REL_FP64, bn_atol=BN_ATOL_FP64)


def test_segmentation_step(spawned):
    """(g) a seg step with GT masks, as test_parallel.py's."""
    scenarios, ranks = spawned
    want, got = _single(scenarios, "seg"), ranks[0]["seg"]
    assert "mask" in got["metrics"][0]
    _check_step(want, got, grad_rel=GRAD_REL_FP64, bn_atol=BN_ATOL_FP64)


def test_validation_metrics_equal_single_process(spawned):
    """evaluate_model on each rank's rows of every val batch (the second
    padded, rank 1's rows all padding) gathers to the single process's COCO,
    P/R/F1 to 1e-12; only rank 0 wrote its files."""
    scenarios, ranks = spawned
    want = _single(scenarios, "eval")
    assert want["coco"]["AP50"] > 0.5
    for r in range(WORLD):
        got = ranks[r]["eval"]
        for k, v in want["coco"].items():
            assert abs(got["coco"][k] - v) <= 1e-12, k
        assert abs(got["best_f1"] - want["best_f1"]) <= 1e-12
    out = scenarios["eval"][1]["out_dir"]
    assert sorted(os.listdir(out)) == sorted(os.listdir(out + "_single"))


def test_batchnorm_world_one_is_unchanged():
    """(h) BatchNorm in train mode with no data-parallel context, and under
    a world-size-1 context, is bit-equal to the single-process code."""
    torch.manual_seed(0)
    x = torch.randn(4, 6, 5, 5) * 3 + 1

    def before(bn, x):      # the single-process forward as written before
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            bn.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            bn.running_var.mul_(0.9).add_(var, alpha=0.1)
        return torch.nn.functional.batch_norm(x, None, None, bn.weight, bn.bias,
                                              training=True, eps=bn.eps)

    ref = layers.BatchNorm(6).train()
    want = before(ref, x)
    for ctx in (None, pdist.DataParallel(1, 0, 0, 1)):
        bn = layers.BatchNorm(6).train()
        with pdist.active(ctx):
            got = bn(x)
        assert torch.equal(got, want)
        assert torch.equal(bn.running_mean, ref.running_mean)
        assert torch.equal(bn.running_var, ref.running_var)
    # a Trainer with a world-1 context steps exactly as one without
    cfg = _tiny()
    a = run_steps(cfg, _batches(1))
    b = run_steps(cfg, _batches(1), dp=pdist.DataParallel(1, 0, 0, 1))
    assert a["metrics"] == b["metrics"] and a["digest"] == b["digest"]


@pytest.mark.parametrize("n,count", [(8, 3), (2, 5), (6, 2), (5, 1)])
def test_dataset_stripes_equal_jax(tmp_path, n, count):
    """(i) each stripe's file list equals JAX's YoloDataset(shard_index,
    shard_count), wrap-padded (also with fewer files than stripes)."""
    from chip_smoke import write_png
    from yololite_tpu.data.dataset import YoloDataset as JaxDataset
    img, lab = tmp_path / "images", tmp_path / "labels"
    img.mkdir()
    lab.mkdir()
    for i in range(n):
        write_png(str(img / f"{i:04d}.png"), np.zeros((8, 8, 3), np.uint8))
    for i in range(count):
        got = YoloDataset(str(img), str(lab), img_size=32, shard_index=i, shard_count=count)
        want = JaxDataset(str(img), str(lab), img_size=32, shard_index=i, shard_count=count)
        assert got.img_files == want.img_files
        assert len(got.img_files) == -(-n // count)
    with pytest.raises(ValueError, match="out of range"):
        YoloDataset(str(img), str(lab), shard_index=count, shard_count=count)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from chip_smoke import make_synth_set
    from yololite_tpu_torch.config import load_configs
    data = make_synth_set(str(tmp_path_factory.mktemp("rows")), n_train=8, n_val=6,
                          w=80, h=60)
    return load_configs(None, None, data, make_run_dir=False)["dataset"]


@pytest.mark.parametrize("split", ["train_augmented", "val_padded"])
@pytest.mark.parametrize("workers", [0, 2])
def test_loader_rows_equal_single_process_rows(synth, split, workers):
    """(j) two ranks' rows of every batch are the single-process loader's
    (its per-sample seeding, num_workers 2): mosaic and cutmix training
    batches, and validation with its padded final batch (rank 1's rows there
    all padding)."""
    train = split.startswith("train")
    key = "train" if train else "val"
    ds = YoloDataset(synth[f"{key}_images"], synth[f"{key}_labels"], img_size=64,
                     is_train=train, augment=train, mosaic_p=0.5, cutmix_p=0.5,
                     max_boxes=16)
    kw = dict(shuffle=train, drop_last=train, seed=3)
    want = list(DataLoader(ds, 4, num_workers=2, **kw))
    got = [list(DataLoader(ds, 4, num_workers=workers, rows=slice(r * 2, r * 2 + 2), **kw))
           for r in range(2)]
    assert len(want) == len(got[0]) == len(got[1]) == (2 if train else 2)
    for b, batch in enumerate(want):
        for k in ("image", "boxes", "labels", "mask", "image_id"):
            joined = np.concatenate([got[0][b][k], got[1][b][k]])
            np.testing.assert_array_equal(joined, batch[k], err_msg=k)
        assert got[0][b]["nvalid"] == got[1][b]["nvalid"] == batch["nvalid"]
    if not train:
        assert list(want[1]["image_id"][2:]) == [-1, -1]
        assert list(got[1][1]["image_id"]) == [-1, -1]
