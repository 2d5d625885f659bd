"""The training loop: epochs, warmup, per-epoch COCO validation, artifacts
(port of `train/loop.py`).

  - merged_config.yaml, seeds, optional pretrained backbone, resume (weights
    only, or exact: EMA + optimizer + counters from a `save_optimizer`
    checkpoint), chunked resume at `start_epoch`;
  - host augmentation (`augment`, the recipes' default: mosaic, cutmix and
    the `aug_preset` transform) with the reference's taper: mosaic and
    cutmix off from epoch int(0.7 * epochs), all host augmentation off after
    int(0.9 * epochs); `device_augment` moves the colour and noise ops into
    the train step (`data/device_augment.py`);
  - per epoch: LR from the host scheduler (warmup, cosine/step/...; backbone
    LR 0 for `freeze_backbone_epochs`), train steps, then the EMA model's val
    loss + decode + NMS -> COCO stats at conf 0.1 / iou 0.65 (`eval_every`);
  - metrics.csv (CSV_HEADER), last_metrics.json / best_metrics.json,
    best_model_state.ckpt (best while augmenting), best_no_aug.ckpt (best
    without augmentation), last_model_state.ckpt, epoch_N.ckpt every
    `save_every`;
  - the final `evaluate_model` (conf 0.001) on the best checkpoint;
  - `profile: true`: a `torch.profiler` trace of batches 3-7 of epoch 1
    into <log_dir>/profile (`utils/profiling.py`), closed at that epoch's
    end when it has fewer than 7 batches.

Segmentation (`model.with_masks`, or `task: segment`) trains the mask loss
on polygon datasets; per-epoch COCO stays bbox-only (the masks are dropped,
as the JAX loop drops them), and the final `evaluate_model` adds segm mAP.

Data parallelism (`data_parallel`, JAX's mesh `data` axis; see
`parallel/dist.py`): unset, it is every visible card on `cuda` and 1 on the
CPU. A process group that is already initialized (torchrun, or a caller
that made one) is joined, and `data_parallel` must then equal its world
size; otherwise `data_parallel: N > 1` spawns N processes, one a card over
NCCL (gloo on the CPU), and returns rank 0's results. A batch that does not
split over the processes runs one process, with JAX's `[dp]` line. Each
process trains on its rows of every batch (`batch_size` a node, the global
batch `batch_size` x nodes; with several nodes each ingests its stripe of
the train set) and validates its rows of every val batch; rank 0 alone
writes the run directory, checkpoints, metrics, plots and the profile
trace, and every process takes the same best-checkpoint decisions from the
broadcast metrics.

Spatial parallelism (`spatial_parallel: S`, JAX's mesh `spatial` axis; see
`parallel/spatial.py`): the run is a mesh of `data_parallel` x S
processes, rank r at (data index, spatial index) = divmod(r, S); the S
ranks of a data index read the same rows and split each image's height.
Unset, `data_parallel` is the visible cards divided by S on `cuda` (1 on the
CPU); on `cuda` the mesh needs as many cards as ranks (`make_mesh`'s
refusal), and a joined group must hold `data_parallel` x S processes. The
batch must split over the data indices, else one process trains, as JAX
drops its mesh.

Not ported, raising `NotImplementedError` with its ROADMAP item: the orbax
checkpoint backend (8c).

The main process draws the first training batch's labels into
`sanity_check.jpg` (a failure is printed and skipped, as in the JAX loop)
and, from epoch 6 on, the detections of one validation batch (picked by
`random.randrange`, as JAX picks it) into `last_b{n}.jpg`.
"""

from __future__ import annotations

import copy
import json
import os
import random
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from yololite_tpu_torch.config.config import save_merged_config
from yololite_tpu_torch.convert import to_flax
from yololite_tpu_torch.data.dataset import YoloDataset, max_instances_per_image
from yololite_tpu_torch.data.loader import DataLoader
from yololite_tpu_torch.eval.coco import coco_eval_from_lists
from yololite_tpu_torch.eval.evaluate import collect_coco, evaluate_model
from yololite_tpu_torch.eval.plots import plot_metrics
from yololite_tpu_torch.models.detector import build_model_from_config
from yololite_tpu_torch.parallel import dist as pdist
from yololite_tpu_torch.train.checkpoint import build_meta, load_checkpoint, save_checkpoint
from yololite_tpu_torch.train.schedulers import build_scheduler
from yololite_tpu_torch.train.steps import Trainer
from yololite_tpu_torch.train.writers import MetricWriters
from yololite_tpu_torch.utils.profiling import start_trace, stop_trace
from yololite_tpu_torch.utils.viz import save_val_debug, visualize_batch

CSV_HEADER = ["epoch", "AP", "AP50", "AP75", "APS", "APM", "APL", "AR",
              "train_loss", "val_loss", "lr_g0", "lr_g1", "lr_g2",
              "elapsed_s", "timestamp"]
COCO_KEYS = ("AP", "AP50", "AP75", "APS", "APM", "APL", "AR")


def set_seed(seed: int = 1337):
    random.seed(seed)
    np.random.seed(seed)


def _end_profile(prof, profile_dir: str) -> None:
    stop_trace(prof, profile_dir)
    print(f"[profile] trace saved to {profile_dir}")


def _write_json_atomic(path: str, data):
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
    os.replace(tmp, path)


def append_csv(path: str, header, row):
    new = not os.path.exists(path)
    with open(path, "a", encoding="utf-8") as f:
        if new:
            f.write(",".join(header) + "\n")
        f.write(",".join(str(x) for x in row) + "\n")


def _save_loss_curve(train_losses, val_losses, path):
    """loss_curve.png; skipped without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.figure()
    plt.plot(train_losses, label="Train")
    plt.plot(val_losses, label="Val")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend()
    plt.title("Loss Curve")
    plt.savefig(path)
    plt.close()


def _check_supported(config: Dict[str, Any]) -> None:
    tr = config["training"]
    if str(tr.get("checkpoint_backend", "msgpack")) != "msgpack":
        raise NotImplementedError("checkpoint_backend orbax_async (orbax is JAX-only): "
                                  "ROADMAP Queue 1 item 8c")


def _max_boxes(config: Dict[str, Any], use_augment: bool, say=print) -> int:
    mb_raw = config["training"].get("max_boxes", 100)
    if not (isinstance(mb_raw, str) and mb_raw.strip().lower() == "auto"):
        return int(mb_raw)
    # GT padding capacity M sized to the dataset (the assignment's cost grows
    # with M); mosaic tiles 4 images (+1 cutmix paste) when augmenting
    base = max(max_instances_per_image(config["dataset"]["train_labels"]),
               max_instances_per_image(config["dataset"]["val_labels"]), 1)
    eff = 4 * base + 1 if use_augment else base
    max_boxes = int(min(300, max(16, ((eff + 7) // 8) * 8)))
    say(f"max_boxes=auto -> {max_boxes} "
        f"(max {base} GT/image{', mosaic x4+1' if use_augment else ''})")
    return max_boxes


def _spawned(rank: int, world: int, port: int, backend: str, config: Dict[str, Any],
             device: str) -> Optional[Dict[str, Any]]:
    """One process of a spawned data-parallel run: join the group, train;
    rank 0 returns its results."""
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(world)
    pdist.init_distributed(f"localhost:{port}", world, rank, backend=backend)
    try:
        results = train_from_config(config, device)
    finally:
        pdist.shutdown()
    return results if rank == 0 else None


def _spawn(config: Dict[str, Any], device: str, n: int) -> Dict[str, Any]:
    """`n` processes, one a card over NCCL (gloo on the CPU); rank 0's results."""
    backend = "nccl" if device.startswith("cuda") else "gloo"
    return pdist.spawn(_spawned, (n, pdist.free_port(), backend, config, device), n)[0]


def _mesh_size(tr: Dict[str, Any], device: str) -> tuple:
    """(data_parallel, spatial_parallel): `data_parallel` unset is the
    visible cards over `spatial_parallel` on `cuda` (at least 1), 1
    elsewhere, as JAX's loop divides its devices."""
    n_sp = max(1, int(tr.get("spatial_parallel") or 1))
    n = tr.get("data_parallel")
    if n:
        return int(n), n_sp
    return (max(1, torch.cuda.device_count() // n_sp) if device == "cuda" else 1), n_sp


def train_from_config(config: Dict[str, Any], device: str = "cuda") -> Dict[str, Any]:
    _check_supported(config)
    tr = config["training"]
    batch_size = int(tr.get("batch_size", 16))
    n_dp, n_sp = _mesh_size(tr, device)
    if dist.is_initialized():           # torchrun, or a caller's group: join it
        dp = pdist.DataParallel.from_group(n_sp)
        want = tr.get("data_parallel")
        if want and int(want) * n_sp != dp.world:
            raise ValueError(f"data_parallel {want} x spatial_parallel {n_sp} in a process "
                             f"group of {dp.world}")
        if batch_size % (dp.local_world // n_sp):
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{dp.local_world // n_sp} data indices a node")
        if device == "cuda":
            device = f"cuda:{dp.local_rank}"
        return _train(config, device, dp if dp.world > 1 else None)
    need, cards = n_dp * n_sp, torch.cuda.device_count()
    if need > 1 and device.startswith("cuda") and need > cards:
        if n_sp > 1:        # make_mesh's refusal
            raise ValueError(f"mesh {n_dp}x{n_sp} needs {need} devices, have {cards} "
                             f"CUDA devices")
        raise ValueError(f"data_parallel {n_dp} needs {n_dp} CUDA devices, {cards} visible")
    if need > 1 and batch_size % n_dp:
        print(f"[dp] batch_size {batch_size} not divisible by {n_dp} "
              f"devices — running single-device")
        need = 1
    if need > 1:
        return _spawn(config, device, need)
    return _train(config, device, None)


def _train(config: Dict[str, Any], device: str,
           dp: Optional[pdist.DataParallel]) -> Dict[str, Any]:
    tr = config["training"]
    main = dp is None or dp.is_main
    say = print if main else (lambda *a, **k: None)
    seed = int(tr.get("seed", 1337))
    set_seed(seed)
    log_dir = config.get("logging", {}).get("log_dir", "runs/default")
    if main:
        os.makedirs(log_dir, exist_ok=True)
        save_merged_config(config, log_dir)
    writers = MetricWriters(log_dir, config.get("logging") if main else None)

    num_classes = int(config["model"]["num_classes"])
    img_size = int(tr.get("img_size", 640))
    epochs = int(tr.get("epochs", 100))
    batch_size = int(tr.get("batch_size", 16))
    nodes = 1 if dp is None else dp.node_count
    global_batch = batch_size * nodes
    use_augment = bool(tr.get("augment", True))
    use_resize = bool(tr.get("resize", False))
    max_boxes = _max_boxes(config, use_augment, say)
    class_names = config.get("dataset", {}).get("names")
    cache_images = bool(tr.get("cache_images", False))
    cache_budget_mb = tr.get("cache_budget_mb")
    device_augment = bool(tr.get("device_augment", False))
    task = str(config["model"].get("task", tr.get("task", "detect"))).lower()
    if config["model"].get("with_masks"):
        task = "segment"
    train_ds = YoloDataset(config["dataset"]["train_images"],
                           config["dataset"]["train_labels"], img_size=img_size,
                           is_train=True, augment=use_augment, max_boxes=max_boxes,
                           use_resize=use_resize, task=task, cache_images=cache_images,
                           photometric=not device_augment,
                           aug_preset=str(tr.get("aug_preset", "base")),
                           cache_budget_mb=cache_budget_mb, want_rles=False,
                           shard_index=0 if dp is None else dp.node_rank,
                           shard_count=nodes)
    val_ds = YoloDataset(config["dataset"]["val_images"], config["dataset"]["val_labels"],
                         img_size=img_size, is_train=False, augment=False,
                         max_boxes=max_boxes, use_resize=use_resize, task=task,
                         cache_images=cache_images, cache_budget_mb=cache_budget_mb)
    num_workers = int(tr.get("num_workers", 4) or 0)
    # data-parallel: this process's rows of the node's train batch, and of
    # the global val batch (every node holds the whole val set); the ranks
    # of one data index read the same rows
    train_loader = DataLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                              seed=seed, num_workers=num_workers,
                              rows=None if dp is None else dp.batch_rows(batch_size))
    val_loader = DataLoader(val_ds, global_batch, shuffle=False, drop_last=False,
                            num_workers=num_workers,
                            rows=None if dp is None else dp.world_rows(global_batch))
    steps_per_epoch = max(1, len(train_loader))
    total_updates = steps_per_epoch * epochs

    model = build_model_from_config(config)
    trainer = Trainer(model, config, total_updates=total_updates, device=device,
                      parallel=dp)
    state = trainer.init_state(seed=seed)

    # pretrained backbone: a backbone checkpoint (weights/, tools/import_backbone.py)
    pre_bb = (config.get("model", {}) or {}).get("pretrained_backbone") \
        or tr.get("pretrained_backbone")
    if pre_bb:
        sd, bmeta = load_checkpoint(pre_bb)
        want, have = config["model"].get("backbone"), (bmeta or {}).get("backbone")
        if have and want and have != want:
            raise ValueError(f"pretrained_backbone is for {have!r}, model uses {want!r}")
        p, bs = to_flax(state.model)
        p["backbone"] = sd["params"].get("backbone", sd["params"])
        bs["backbone"] = sd["batch_stats"].get("backbone", sd["batch_stats"])
        state = trainer.state_from_weights(p, bs)
        say(f"Initialized backbone from {pre_bb}")

    resume = tr.get("resume")
    if resume:
        if dp is not None:
            pdist.barrier()
        sd, _meta = load_checkpoint(resume)
        if "opt_state" in sd or "ema_params" in sd:
            state = trainer.state_from_full(sd)
            say(f"Resumed FULL state (EMA/optimizer) from {resume}")
        else:
            state = trainer.state_from_weights(sd["params"], sd["batch_stats"])
            say(f"Resumed weights from {resume} (fresh EMA/optimizer)")

    scheduler = build_scheduler(config, steps_per_epoch)
    base_lr = float(tr.get("lr", 1e-3))
    freeze_epochs = int(tr.get("freeze_backbone_epochs",
                               tr.get("freeze_backbone", 0) or 0) or 0)
    save_every = int(tr.get("save_every", 25) or 25)
    eval_every = int(tr.get("eval_every", 1) or 1)
    save_by = tr.get("save_by") or "AP"
    num_anchors = model.get_num_anchors_per_level()

    weight_dir = os.path.join(log_dir, "weights")
    profile_dir = os.path.join(log_dir, "profile")
    if main:
        os.makedirs(weight_dir, exist_ok=True)
    best_ckpt = os.path.join(weight_dir, "best_model_state.ckpt")
    last_ckpt = os.path.join(weight_dir, "last_model_state.ckpt")
    best_no_aug = os.path.join(weight_dir, "best_no_aug.ckpt")
    if main:    # sanity-check image of the first batch
        try:
            first = train_loader.first_batch()   # JAX: next(iter(train_loader))
            visualize_batch(first, os.path.join(log_dir, "sanity_check.jpg"), class_names)
        except Exception as e:
            print(f"[sanity_check] skipped: {e}")

    best_metric, best_metric_no_aug = -1.0, -1.0
    train_losses, val_losses, step_losses = [], [], []
    say(f"Training on {trainer.device} | {len(train_ds)} train / {len(val_ds)} val "
        f"images | img={img_size} batch={batch_size} dp={dp is not None}")
    if dp is not None:
        say(f"[dp] {dp.world} processes ({dp.node_count} node(s) x {dp.local_world}), "
            f"mesh {dp.n_data}x{dp.n_spatial} (data x spatial), {dist.get_backend()}; "
            f"global batch {global_batch}, "
            f"{batch_size * dp.n_spatial // dp.local_world} rows a data index")

    multi_scale = tr.get("multi_scale_sizes") or []
    ms_rng = np.random.RandomState(seed + 99)
    # chunked exact resume: continue the schedule, taper and CSV numbering at
    # start_epoch, and the loader's (seed + epoch) order at the global epoch
    start_epoch = int(tr.get("start_epoch", 0) or 0)
    global_step = start_epoch * steps_per_epoch
    scheduler.fast_forward(start_epoch)
    train_loader.epoch = start_epoch
    for _ in range(start_epoch):
        if multi_scale:  # burn the per-epoch size draws of skipped epochs
            ms_rng.randint(len(multi_scale))
    mosaic_tapered = False

    for epoch in range(start_epoch, epochs):
        # the augmentation taper: a chunk resumed past either threshold
        # applies it at its first epoch, as the straight run had
        if epoch >= int(epochs * 0.7) and use_augment and not mosaic_tapered:
            train_ds.set_mosaic_cutmix(0.0, 0.0)
            mosaic_tapered = True
        if epoch > int(epochs * 0.9) and use_augment:
            train_ds.set_augment(False)
            use_augment = False
        if multi_scale:
            size = int(multi_scale[ms_rng.randint(len(multi_scale))])
            if size != train_ds.img_size:
                train_ds.set_img_size(size)

        start = time.time()
        running = np.zeros(4)  # total, box, obj, cls
        nb = 0
        freeze_bb = epoch < freeze_epochs
        # `profile`: a profiler trace of batches 3-7 of epoch 1, stopped at
        # that epoch's end if it has fewer batches (JAX's trace stays open)
        profiling, prof = bool(tr.get("profile")) and epoch == 1 and main, None
        for batch in train_loader:
            if profiling and nb == 2:
                prof = start_trace(profile_dir)
            lr = base_lr * scheduler.lr_factor(epoch, global_step)
            state, metrics = trainer.train_step(state, trainer.put_batch(batch),
                                                trainer.lr_vector(lr, freeze_bb))
            b = global_batch          # the metrics are the global batch's sums
            vals = torch.stack([metrics[k] for k in ("total", "box", "obj", "cls")])
            vals = vals.double().cpu().numpy()
            step_losses.append(float(vals[0]))
            running += vals / b
            nb += 1
            global_step += 1
            if prof is not None and nb == 7:
                prof = _end_profile(prof, profile_dir)
        if prof is not None:
            prof = _end_profile(prof, profile_dir)
        avg_train = running[0] / max(1, nb)
        train_losses.append(avg_train)
        scheduler.end_epoch(epoch)

        # validation: EMA model, val loss + COCO
        do_eval = (eval_every <= 1 or (epoch + 1) % eval_every == 0
                   or (epoch + 1) == epochs or not use_augment)
        variables = trainer.ema_variables(state)
        if do_eval:
            # per-epoch COCO is bbox-only (segm mAP runs in the final
            # evaluate_model): the masks stay on the device
            dbg_batch = random.randrange(max(1, len(val_loader)))

            def val_debug(bi, batch, dets):
                if bi == dbg_batch and epoch + 1 > 5 and main:
                    save_val_debug(batch["image"], {k: dets[k].cpu().numpy() for k in
                                                    ("boxes", "scores", "classes", "valid")},
                                   log_dir, conf_th=0.3, names=class_names)
            coco_images, coco_anns, coco_dets, avg_val = collect_coco(
                trainer, variables, val_loader, img_size, conf_th=0.1, iou_th=0.65,
                masks=False, on_batch=val_debug)
            scheduler.observe(avg_val)
            coco_stats = None
            if main:
                coco_stats = coco_eval_from_lists(coco_images, coco_anns, coco_dets,
                                                  num_classes=num_classes)
            if dp is not None:      # every process takes rank 0's decisions
                coco_stats = pdist.broadcast_object(coco_stats)
        else:
            avg_val = float("nan")
            coco_stats = {k: float("nan") for k in COCO_KEYS}
        val_losses.append(avg_val)
        elapsed = time.time() - start

        lr_now = base_lr * scheduler.lr_factor(epoch + 1, global_step)
        hyper = trainer.hyper
        current = coco_stats.get(save_by, 0.0)
        new_best = current > best_metric and use_augment
        new_best_no_aug = current > best_metric_no_aug and not use_augment
        if not main:            # rank 0 writes; the others follow its best metrics
            best_metric = current if new_best else best_metric
            best_metric_no_aug = current if new_best_no_aug else best_metric_no_aug
            continue
        if do_eval:
            _write_json_atomic(os.path.join(log_dir, "last_metrics.json"),
                               {"epoch": epoch + 1, **coco_stats,
                                "train_loss": avg_train, "val_loss": avg_val})
            if coco_stats.get(save_by, 0.0) >= max(best_metric, best_metric_no_aug):
                _write_json_atomic(os.path.join(log_dir, "best_metrics.json"),
                                   {"epoch": epoch + 1, **coco_stats})
        append_csv(os.path.join(log_dir, "metrics.csv"), CSV_HEADER, [
            epoch + 1, coco_stats["AP"], coco_stats["AP50"], coco_stats["AP75"],
            coco_stats["APS"], coco_stats["APM"], coco_stats["APL"],
            coco_stats["AR"], avg_train, avg_val,
            lr_now * hyper["bb_mult"], lr_now * hyper["neck_mult"],
            lr_now * hyper["head_mult"], elapsed, time.strftime("%Y-%m-%dT%H:%M:%S"),
        ])
        writers.write(epoch + 1, {
            "train/loss": avg_train, "val/loss": avg_val, "lr": lr_now,
            **({f"val/{k}": v for k, v in coco_stats.items()} if do_eval else {})})

        # checkpoints: the deployed weights are the EMA copy
        meta = build_meta(config, coco_stats, save_by, class_names, num_anchors)
        params, batch_stats = to_flax(variables)
        if new_best:
            best_metric = current
            save_checkpoint(best_ckpt, params, batch_stats, meta)
            print(f"New best {save_by}={best_metric:.4f} saved to {best_ckpt}")
        if new_best_no_aug:
            best_metric_no_aug = current
            save_checkpoint(best_no_aug, params, batch_stats, meta)
            print(f"New best (no-aug) {save_by}={best_metric_no_aug:.4f}")
        if (epoch + 1) % save_every == 0:
            save_checkpoint(os.path.join(weight_dir, f"epoch_{epoch + 1}.ckpt"),
                            params, batch_stats, meta)
        extra = trainer.full_state(state) if bool(tr.get("save_optimizer", False)) else None
        save_checkpoint(last_ckpt, params, batch_stats, meta, extra_state=extra)
        _save_loss_curve(train_losses, val_losses, os.path.join(log_dir, "loss_curve.png"))
        print(f"Epoch {epoch + 1}/{epochs} | train {avg_train:.4f} | "
              f"val {avg_val:.4f} | AP {coco_stats['AP']:.4f} "
              f"AP50 {coco_stats['AP50']:.4f} AP75 {coco_stats['AP75']:.4f} | "
              f"took {elapsed:.1f}s")

    writers.close()
    # final plots + full evaluation on the best checkpoint, read back by rank 0
    # and broadcast
    load_path = None
    if main:
        plot_metrics(os.path.join(log_dir, "metrics.csv"), os.path.join(log_dir, "plots"),
                     smooth=0.2, style="dark")
        load_path = next((p for p in (best_ckpt, best_no_aug, last_ckpt)
                          if os.path.exists(p)), None)
    if dp is not None:
        load_path = pdist.broadcast_object(load_path)
    results: Dict[str, Any] = {}
    if load_path is not None:
        if main:
            sd, _ = load_checkpoint(load_path)
            variables = trainer.variables_from_flax(sd["params"], sd["batch_stats"])
        else:
            variables = copy.deepcopy(trainer.model).eval()
        if dp is not None:
            pdist.broadcast_state([variables])
        results = evaluate_model(trainer, variables, val_loader, log_dir, num_classes,
                                 img_size, class_names)
    results["best_metric"] = max(best_metric, best_metric_no_aug)
    results["log_dir"] = log_dir
    results["history"] = {"train_loss": train_losses, "val_loss": val_losses,
                          "step_loss": step_losses}
    return results
