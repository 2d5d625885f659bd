"""The port's training loop data-parallel on the CPU (gloo): edge_n at 64 px
on an 80x60 PNG set for 2 epochs with `data_parallel: 2` (two processes
spawned by the loop) against the single-process run, its exact resume, a
2-node x 1-rank run joined through torchrun's environment (each node its
stripe, the global batch `batch_size` x 2), and the training CLI with
`--data_parallel 2`.

Both runs sample every batch alike (the loader's per-sample seeding,
num_workers 2). Measured here: the metrics.csv losses of the two runs part
by <= 3e-6 relative; the best checkpoints by <= 1.5e-4 absolute in one
weight of 9,216 in a stem conv (Adam's first updates are sign-normalized,
so fp32 noise in a near-zero gradient moves a weight by up to lr), the
rest within 1e-5."""

import csv
import os

import numpy as np
import pytest
import torch

from chip_smoke import make_synth_set
from yololite_tpu_torch.config import load_configs
from yololite_tpu_torch.data.dataset import YoloDataset
from yololite_tpu_torch.train import loop
from yololite_tpu_torch.train.checkpoint import load_checkpoint
from yololite_tpu_torch.train.loop import train_from_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = dict(epochs=2, batch_size=4, img_size=64, augment=True, amp=False,
                 save_optimizer=True, num_workers=2,
                 pretrained_backbone=os.path.join(ROOT, "weights", "mnv4_050_cls20.ckpt"))
LOSS_RTOL = 1e-5            # metrics.csv losses (measured <= 3e-6)
CKPT_ATOL = 1e-3            # best checkpoint weights: the recipe's lr (measured 1.5e-4)
CKPT_TYPICAL = 1e-5         # ... and all but 0.1% of them within this
RESUME_RTOL = 1e-5          # a resumed epoch, two processes vs one
TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread(tmp_path_factory):
    """One torch thread here and in the spawned processes (OMP_NUM_THREADS
    is read at their start): the test files run in parallel processes."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synth_set(str(tmp_path_factory.mktemp("set")), n_train=8, n_val=6,
                          w=80, h=60)


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


def _files(log_dir):
    return sorted(os.path.relpath(os.path.join(d, f), log_dir)
                  for d, _, fs in os.walk(log_dir) for f in fs)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The single-process run and the data_parallel: 2 run."""
    tmp = tmp_path_factory.mktemp("runs")
    single = train_from_config(_config(data, tmp / "single"), device="cpu")
    dp = train_from_config(_config(data, tmp / "dp", data_parallel=2), device="cpu")
    return tmp, single, dp


def test_two_processes_equal_one(runs):
    """metrics.csv losses, validation metrics, the final evaluation and the
    best checkpoint of data_parallel: 2 against one process; the run
    directory holds the same files, written once (rank 0)."""
    tmp, single, dp = runs
    a, b = _rows(tmp / "single"), _rows(tmp / "dp")
    assert len(a) == len(b) == 2
    for ra, rb in zip(a, b):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(float(rb[k]), float(ra[k]), rtol=LOSS_RTOL, err_msg=k)
        for k in ("AP", "AP50", "AP75", "APS", "APM", "APL", "AR", "lr_g0", "lr_g1", "lr_g2"):
            assert rb[k] == ra[k], k
    assert dp["coco"] == single["coco"]
    np.testing.assert_allclose(dp["history"]["step_loss"], single["history"]["step_loss"],
                               rtol=LOSS_RTOL)
    assert _files(tmp / "dp") == _files(tmp / "single")
    sa, _ = load_checkpoint(str(tmp / "single" / "weights" / "best_model_state.ckpt"))
    sb, _ = load_checkpoint(str(tmp / "dp" / "weights" / "best_model_state.ckpt"))
    diff = np.concatenate([np.abs(y - x).ravel() for x, y in zip(_leaves(sa), _leaves(sb))])
    assert diff.max() <= CKPT_ATOL and np.mean(diff > CKPT_TYPICAL) <= 1e-3


def test_resume_from_last_checkpoint(runs, data):
    """A third epoch resumed from the data-parallel run's last checkpoint
    (full state, read after a barrier and broadcast from rank 0), in two
    processes and in one: the same losses."""
    tmp, _, _ = runs
    last = str(tmp / "dp" / "weights" / "last_model_state.ckpt")
    kw = dict(epochs=3, start_epoch=2, resume=last)
    one = train_from_config(_config(data, tmp / "resumed1", **kw), device="cpu")
    two = train_from_config(_config(data, tmp / "resumed2", data_parallel=2, **kw),
                            device="cpu")
    assert [r["epoch"] for r in _rows(tmp / "resumed2")] == ["3"]
    np.testing.assert_allclose(two["history"]["step_loss"], one["history"]["step_loss"],
                               rtol=RESUME_RTOL)


def _node(rank, port, configs):
    """One node of a 2-node x 1-rank run, joined as torchrun would: its
    train split, its batches' sizes and the run's results."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from yololite_tpu_torch.parallel import dist as pdist
    from yololite_tpu_torch.train.steps import Trainer
    seen = {"files": [], "rows": []}
    real_ds, real_step = loop.YoloDataset, Trainer.train_step

    def dataset(*a, **kw):
        ds = real_ds(*a, **kw)
        if ds.is_train:
            seen["files"] = list(ds.img_files)
        return ds

    def step(self, state, batch, lr_vec):
        seen["rows"].append(int(batch["image"].shape[0]))
        return real_step(self, state, batch, lr_vec)

    loop.YoloDataset, Trainer.train_step = dataset, step
    assert pdist.init_distributed() == 2
    try:
        seen["results"] = train_from_config(configs[rank], device="cpu")
    finally:
        pdist.shutdown()
    return seen


def test_two_nodes_one_rank_each(data, tmp_path):
    """RANK/WORLD_SIZE/LOCAL_WORLD_SIZE=1 as torchrun sets them on two
    nodes: each ingests its wrap-padded stripe of the train set, steps on a
    full node batch of 4, the global batch is 8 (the logged train loss is
    the global sum over 8); only rank 0 writes (rank 1's log_dir stays
    absent)."""
    from yololite_tpu_torch.parallel import dist as pdist
    cfgs = [_config(data, tmp_path / f"node{r}", data_parallel=2) for r in range(2)]
    seen = pdist.spawn(_node, (pdist.free_port(), cfgs), 2, timeout=TIMEOUT_S)
    ds_cfg = cfgs[0]["dataset"]
    for r in range(2):
        stripe = YoloDataset(ds_cfg["train_images"], ds_cfg["train_labels"], img_size=64,
                             shard_index=r, shard_count=2)
        assert seen[r]["files"] == stripe.img_files and len(stripe.img_files) == 4
        assert seen[r]["rows"] == [4, 4]        # one step an epoch on 4 files a node
    assert not os.path.exists(tmp_path / "node1")
    res = seen[0]["results"]
    steps = res["history"]["step_loss"]
    np.testing.assert_allclose(res["history"]["train_loss"],
                               [steps[0] / 8, steps[1] / 8], rtol=1e-12)
    assert seen[1]["results"]["coco"] == res["coco"]
    assert len(_rows(tmp_path / "node0")) == 2


def test_train_cli_data_parallel(data, tmp_path, monkeypatch):
    """`tools.train --data_parallel 2 --device cpu` trains in two processes
    and returns rank 0's results."""
    from yololite_tpu_torch.tools import train as train_tool
    monkeypatch.chdir(tmp_path)
    res = train_tool.main(["--model", os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                           "--data", data, "--epochs", "1", "--batch_size", "4",
                           "--img_size", "64", "--workers", "2", "--no-augment",
                           "--data_parallel", "2", "--device", "cpu"])
    assert res["log_dir"].startswith(str(tmp_path / "runs"))
    assert len(_rows(res["log_dir"])) == 1
    assert np.isfinite(res["history"]["step_loss"]).all()


def test_indivisible_batch_runs_one_process(data, tmp_path, capsys):
    """A batch that does not split over data_parallel runs one process, with
    the JAX loop's [dp] line."""
    res = train_from_config(_config(data, tmp_path / "one", data_parallel=3, epochs=1),
                            device="cpu")
    out = capsys.readouterr().out
    assert "[dp] batch_size 4 not divisible by 3 devices — running single-device" in out
    assert "dp=False" in out and len(res["history"]["step_loss"]) == 2


def test_chip_smoke_trains_one_process_on_a_multi_card_host(data, monkeypatch):
    """With two cards visible, training with `data_parallel` unset spawns a
    process a card; chip_smoke's phases before `ddp` pin one process (their
    launch counts and patches are the parent's): its train overrides, and
    the benchmark tool's YoloLite.train under `_one_process_training`."""
    import chip_smoke
    from yololite_tpu_torch.api import YoloLite
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    calls = []
    monkeypatch.setattr(loop, "_spawn", lambda config, device, n: calls.append(("spawn", n)))
    monkeypatch.setattr(loop, "_train", lambda config, device, dp: calls.append(("one", dp)))
    unset = {k: v for k, v in chip_smoke.TRAIN_OVERRIDES.items() if k != "data_parallel"}
    for overrides in (chip_smoke.TRAIN_OVERRIDES, chip_smoke.SEG_TRAIN_OVERRIDES, unset):
        cfg = load_configs(os.path.join(ROOT, "configs", "models", "edge_n.yaml"),
                           os.path.join(ROOT, "configs", "train", "standard_train.yaml"),
                           data, make_run_dir=False)
        cfg["training"].update(overrides)
        train_from_config(cfg, "cuda")
    assert calls == [("one", None), ("one", None), ("spawn", 2)]

    class Stop(Exception):
        pass

    seen = []

    def capture(config, device="cuda"):
        seen.append(config["training"].get("data_parallel"))
        raise Stop

    monkeypatch.setattr(loop, "train_from_config", capture)
    with chip_smoke._one_process_training(), pytest.raises(Stop):
        YoloLite("edge_n", device="cuda").train(data=data, epochs=1, batch_size=8)
    assert seen == [1]


@pytest.mark.parametrize("cards, backends", [(1, ["gloo", "nccl world 1"]),
                                             (2, ["gloo", "nccl"])])
def test_chip_smoke_ddp_phase_runs_nccl_with_two_cards(data, tmp_path, monkeypatch, cards,
                                                       backends):
    """chip_smoke's `ddp` phase: gloo ranks always; NCCL one rank a card when
    two cards are visible, else a world-1 NCCL group."""
    import chip_smoke
    ran = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(chip_smoke, "_ddp_one_process", lambda data: {})
    monkeypatch.setattr(chip_smoke, "_ddp_backend", lambda card, backend, devices, *a: (
        ran.append(backend), {backend: {"train": {"launches": [3, 3]}}})[1])
    monkeypatch.setattr(chip_smoke, "_ddp_nccl_world_one",
                        lambda card: ran.append("nccl world 1") or {})
    out = chip_smoke.phase_ddp("card", data, str(tmp_path))
    assert ran == backends and out["launches"] == 6
