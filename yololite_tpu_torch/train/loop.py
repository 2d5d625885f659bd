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
  - the final `evaluate_model` (conf 0.001) on the best checkpoint.

Segmentation (`model.with_masks`, or `task: segment`) trains the mask loss
on polygon datasets; per-epoch COCO stays bbox-only (the masks are dropped,
as the JAX loop drops them), and the final `evaluate_model` adds segm mAP.

Runs on one device (`device`, the card by default). Not ported, each raising
`NotImplementedError` with its ROADMAP item: the device mesh / multi-host /
data_parallel > 1 (ROADMAP Queue 1 item 3), the orbax checkpoint backend (8c); the sanity and val-debug images need `utils/viz.py` (8d) and are
skipped with a message, as the JAX loop does when drawing fails.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Any, Dict

import numpy as np
import torch

from yololite_tpu_torch.config.config import save_merged_config
from yololite_tpu_torch.convert import to_flax
from yololite_tpu_torch.data.dataset import YoloDataset, max_instances_per_image
from yololite_tpu_torch.data.loader import DataLoader
from yololite_tpu_torch.eval.coco import coco_eval_from_lists
from yololite_tpu_torch.eval.evaluate import dets_to_coco, evaluate_model, gts_to_coco
from yololite_tpu_torch.eval.plots import plot_metrics
from yololite_tpu_torch.models.detector import build_model_from_config
from yololite_tpu_torch.train.checkpoint import build_meta, load_checkpoint, save_checkpoint
from yololite_tpu_torch.train.schedulers import build_scheduler
from yololite_tpu_torch.train.steps import Trainer
from yololite_tpu_torch.train.writers import MetricWriters

CSV_HEADER = ["epoch", "AP", "AP50", "AP75", "APS", "APM", "APL", "AR",
              "train_loss", "val_loss", "lr_g0", "lr_g1", "lr_g2",
              "elapsed_s", "timestamp"]
COCO_KEYS = ("AP", "AP50", "AP75", "APS", "APM", "APL", "AR")


def set_seed(seed: int = 1337):
    random.seed(seed)
    np.random.seed(seed)


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
    n_dp = int(tr.get("data_parallel") or 1)
    n_sp = int(tr.get("spatial_parallel") or 1)
    if n_dp * n_sp > 1:
        raise NotImplementedError("multi-device training (mesh, data_parallel, "
                                  "spatial_parallel, multi-host): ROADMAP Queue 1 item 3")
    if str(tr.get("checkpoint_backend", "msgpack")) != "msgpack":
        raise NotImplementedError("checkpoint_backend orbax_async (orbax is JAX-only): "
                                  "ROADMAP Queue 1 item 8c")


def _max_boxes(config: Dict[str, Any], use_augment: bool) -> int:
    mb_raw = config["training"].get("max_boxes", 100)
    if not (isinstance(mb_raw, str) and mb_raw.strip().lower() == "auto"):
        return int(mb_raw)
    # GT padding capacity M sized to the dataset (the assignment's cost grows
    # with M); mosaic tiles 4 images (+1 cutmix paste) when augmenting
    base = max(max_instances_per_image(config["dataset"]["train_labels"]),
               max_instances_per_image(config["dataset"]["val_labels"]), 1)
    eff = 4 * base + 1 if use_augment else base
    max_boxes = int(min(300, max(16, ((eff + 7) // 8) * 8)))
    print(f"max_boxes=auto -> {max_boxes} "
          f"(max {base} GT/image{', mosaic x4+1' if use_augment else ''})")
    return max_boxes


def train_from_config(config: Dict[str, Any], device: str = "cuda") -> Dict[str, Any]:
    _check_supported(config)
    tr = config["training"]
    seed = int(tr.get("seed", 1337))
    set_seed(seed)
    log_dir = config.get("logging", {}).get("log_dir", "runs/default")
    os.makedirs(log_dir, exist_ok=True)
    save_merged_config(config, log_dir)
    writers = MetricWriters(log_dir, config.get("logging"))

    num_classes = int(config["model"]["num_classes"])
    img_size = int(tr.get("img_size", 640))
    epochs = int(tr.get("epochs", 100))
    batch_size = int(tr.get("batch_size", 16))
    use_augment = bool(tr.get("augment", True))
    use_resize = bool(tr.get("resize", False))
    max_boxes = _max_boxes(config, use_augment)
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
                           cache_budget_mb=cache_budget_mb, want_rles=False)
    val_ds = YoloDataset(config["dataset"]["val_images"], config["dataset"]["val_labels"],
                         img_size=img_size, is_train=False, augment=False,
                         max_boxes=max_boxes, use_resize=use_resize, task=task,
                         cache_images=cache_images, cache_budget_mb=cache_budget_mb)
    num_workers = int(tr.get("num_workers", 4) or 0)
    train_loader = DataLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                              seed=seed, num_workers=num_workers)
    val_loader = DataLoader(val_ds, batch_size, shuffle=False, drop_last=False,
                            num_workers=num_workers)
    steps_per_epoch = max(1, len(train_loader))
    total_updates = steps_per_epoch * epochs

    model = build_model_from_config(config)
    trainer = Trainer(model, config, total_updates=total_updates, device=device)
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
        print(f"Initialized backbone from {pre_bb}")

    resume = tr.get("resume")
    if resume:
        sd, _meta = load_checkpoint(resume)
        if "opt_state" in sd or "ema_params" in sd:
            state = trainer.state_from_full(sd)
            print(f"Resumed FULL state (EMA/optimizer) from {resume}")
        else:
            state = trainer.state_from_weights(sd["params"], sd["batch_stats"])
            print(f"Resumed weights from {resume} (fresh EMA/optimizer)")

    scheduler = build_scheduler(config, steps_per_epoch)
    base_lr = float(tr.get("lr", 1e-3))
    freeze_epochs = int(tr.get("freeze_backbone_epochs",
                               tr.get("freeze_backbone", 0) or 0) or 0)
    save_every = int(tr.get("save_every", 25) or 25)
    eval_every = int(tr.get("eval_every", 1) or 1)
    save_by = tr.get("save_by") or "AP"
    num_anchors = model.get_num_anchors_per_level()

    weight_dir = os.path.join(log_dir, "weights")
    os.makedirs(weight_dir, exist_ok=True)
    best_ckpt = os.path.join(weight_dir, "best_model_state.ckpt")
    last_ckpt = os.path.join(weight_dir, "last_model_state.ckpt")
    best_no_aug = os.path.join(weight_dir, "best_no_aug.ckpt")
    print("[sanity_check] skipped: drawing needs utils/viz.py (ROADMAP Queue 1 item 8d)")

    best_metric, best_metric_no_aug = -1.0, -1.0
    train_losses, val_losses, step_losses = [], [], []
    print(f"Training on {trainer.device} | {len(train_ds)} train / {len(val_ds)} val "
          f"images | img={img_size} batch={batch_size}")

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
        for batch in train_loader:
            lr = base_lr * scheduler.lr_factor(epoch, global_step)
            state, metrics = trainer.train_step(state, trainer.put_batch(batch),
                                                trainer.lr_vector(lr, freeze_bb))
            b = len(batch["image"])
            vals = torch.stack([metrics[k] for k in ("total", "box", "obj", "cls")])
            vals = vals.double().cpu().numpy()
            step_losses.append(float(vals[0]))
            running += vals / b
            nb += 1
            global_step += 1
        avg_train = running[0] / max(1, nb)
        train_losses.append(avg_train)
        scheduler.end_epoch(epoch)

        # validation: EMA model, val loss + COCO
        do_eval = (eval_every <= 1 or (epoch + 1) % eval_every == 0
                   or (epoch + 1) == epochs or not use_augment)
        variables = trainer.ema_variables(state)
        if do_eval:
            coco_images, coco_anns, coco_dets = [], [], []
            ann_id, img_id = 1, 1
            v_running, vb_count = 0.0, 0
            for batch in val_loader:
                nvalid = int(batch.get("nvalid", len(batch["image"])))
                vmetrics, dets = trainer.eval_step(variables, trainer.put_batch(batch),
                                                   conf_th=0.1, iou_th=0.65)
                v_running += float(vmetrics["total"]) / max(1, nvalid)
                vb_count += 1
                imgs, anns, ann_id = gts_to_coco(batch, img_id, nvalid, img_size, ann_id)
                coco_images += imgs
                coco_anns += anns
                # per-epoch COCO is bbox-only (segm mAP runs in the final
                # evaluate_model): the masks stay on the device
                coco_dets += dets_to_coco({k: v.cpu().numpy() for k, v in dets.items()
                                           if k != "masks"}, img_id, nvalid)
                img_id += nvalid
            avg_val = v_running / max(1, vb_count)
            scheduler.observe(avg_val)
            coco_stats = coco_eval_from_lists(coco_images, coco_anns, coco_dets,
                                              num_classes=num_classes)
        else:
            avg_val = float("nan")
            coco_stats = {k: float("nan") for k in COCO_KEYS}
        val_losses.append(avg_val)
        elapsed = time.time() - start

        lr_now = base_lr * scheduler.lr_factor(epoch + 1, global_step)
        hyper = trainer.hyper
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
        current = coco_stats.get(save_by, 0.0)
        if current > best_metric and use_augment:
            best_metric = current
            save_checkpoint(best_ckpt, params, batch_stats, meta)
            print(f"New best {save_by}={best_metric:.4f} saved to {best_ckpt}")
        if current > best_metric_no_aug and not use_augment:
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
    # final plots + full evaluation on the best checkpoint
    plot_metrics(os.path.join(log_dir, "metrics.csv"), os.path.join(log_dir, "plots"),
                 smooth=0.2, style="dark")
    load_path = best_ckpt if os.path.exists(best_ckpt) else (
        best_no_aug if os.path.exists(best_no_aug) else last_ckpt)
    results: Dict[str, Any] = {}
    if os.path.exists(load_path):
        sd, _ = load_checkpoint(load_path)
        variables = trainer.variables_from_flax(sd["params"], sd["batch_stats"])
        results = evaluate_model(trainer, variables, val_loader, log_dir, num_classes,
                                 img_size, class_names)
    results["best_metric"] = max(best_metric, best_metric_no_aug)
    results["log_dir"] = log_dir
    results["history"] = {"train_loss": train_losses, "val_loss": val_losses,
                          "step_loss": step_losses}
    return results
