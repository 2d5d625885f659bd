"""Backbone pretraining on an imagefolder (port of `tools/pretrain_backbone.py`).

When no torch checkpoint is at hand for `tools/import_backbone.py`, this
pretrains any zoo backbone from scratch as a classifier on an imagefolder
(root/train/<class>/*.png [, root/val/<class>/...], the layout
`tools/make_crop_corpus.py` writes) and saves the backbone checkpoint that a
model's `pretrained_backbone` reads, in the JAX package's layout: both
packages' training loops load it.

    python -m yololite_tpu_torch.tools.pretrain_backbone --data crops \
        --backbone mobilenetv4_conv_small_050 --epochs 90 --batch_size 256 \
        --img_size 224 --out weights/mnv4_050_pre.ckpt [--device cuda]

As in the JAX tool:
  - the classifier is the zoo backbone, the mean of its last feature map in
    fp32 and a Linear head (flax names `backbone/...` and `head/...`); bf16
    compute with fp32 weights;
  - cross-entropy on label-smoothed targets (`optax.smooth_labels`), the
    gradient clipped to global norm 1, AdamW with weight decay on every
    parameter (`train/optim.GroupedOptimizer`'s chain, one LR for all), the
    LR on optax's `warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1))` with the warmup clamped to half the run;
  - an EMA of the weights and the BatchNorm statistics, decay
    min(ema_decay, (1 + step) / (10 + step)); val top-1 and the checkpoint
    come from the EMA copy;
  - the host pipeline draws its random crops and flips from one
    `np.random.RandomState(seed)` in the same order, so the batches are the
    same crops (pixels within one level: the resize matches cv2's within
    one level).
Images (WebP and CMYK JPEG among them) are read by the port's codecs as
`cv2.imread` reads them; a file cv2 gives None for becomes a zero image, as
there. A format cv2 reads and the codecs do not (animated WebP, GIF under
an image name) raises `UnsupportedImage`. The weights start
from `init_weights(seed)`, not flax's initializers.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yololite_tpu_torch.convert import to_flax
from yololite_tpu_torch.data.codecs import imread_bgr
from yololite_tpu_torch.models.backbones.zoo import build_backbone
from yololite_tpu_torch.models.detector import init_weights
from yololite_tpu_torch.ops.letterbox import resize_image
from yololite_tpu_torch.train.checkpoint import save_checkpoint
from yololite_tpu_torch.train.optim import GroupedOptimizer
from yololite_tpu_torch.train.steps import normalize_images

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_imagefolder(root):
    """[(path, class_idx)], class names — torchvision ImageFolder layout."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    samples = []
    for ci, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(IMAGE_EXTS):
                samples.append((os.path.join(cdir, f), ci))
    if not samples:
        raise FileNotFoundError(f"no images under {root}")
    return samples, classes


def _read_rgb(path: str, img_size: int) -> np.ndarray:
    """`cv2.cvtColor(cv2.imread(path), BGR2RGB)`, a zero image where imread
    gives None (a format the codecs do not decode raises UnsupportedImage)."""
    try:
        img = imread_bgr(path)
    except ValueError:
        img = np.zeros((img_size, img_size, 3), np.uint8)
    return img[..., ::-1]


def make_batch(samples, idxs, img_size, rng, train=True):
    imgs = np.empty((len(idxs), img_size, img_size, 3), np.uint8)
    labels = np.empty((len(idxs),), np.int32)
    for j, i in enumerate(idxs):
        path, ci = samples[i]
        img = _read_rgb(path, img_size)
        if train:
            # random resized crop (scale 0.35-1.0) + horizontal flip
            h, w = img.shape[:2]
            s = rng.uniform(0.35, 1.0)
            ar = rng.uniform(0.8, 1.25)
            ch = min(h, max(8, int(round((s * h * w / ar) ** 0.5))))
            cw = min(w, max(8, int(round(ch * ar))))
            y0 = rng.randint(0, h - ch + 1)
            x0 = rng.randint(0, w - cw + 1)
            img = img[y0:y0 + ch, x0:x0 + cw]
            if rng.rand() < 0.5:
                img = img[:, ::-1]
        imgs[j] = resize_image(img, img_size)[0]
        labels[j] = ci
    return imgs, labels


class Classifier(nn.Module):
    """Zoo backbone -> mean of the last feature map (fp32) -> Linear head;
    the backbone computes in `dtype` (bf16 under autocast, fp32 weights)."""

    def __init__(self, backbone_name: str, num_classes: int, dtype=torch.float32):
        super().__init__()
        self.backbone, info = build_backbone(backbone_name)
        self.head = nn.Linear(info[-1]["num_chs"], num_classes)
        self.dtype = dtype

    def forward(self, x):
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            feat = self.backbone(x)[-1]
        return self.head(feat.float().mean(dim=(2, 3)))


def build_classifier(backbone_name, num_classes, dtype=torch.float32) -> Classifier:
    return Classifier(backbone_name, num_classes, dtype)


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float) -> torch.Tensor:
    """optax.softmax_cross_entropy(logits, smooth_labels(one_hot, s)).mean()."""
    nc = logits.shape[-1]
    target = F.one_hot(labels.long(), nc).float() * (1.0 - smoothing) + smoothing / nc
    return -(target * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def warmup_cosine_lr(count: int, peak: float, warmup: int, decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps) at
    `count`, in float32 as optax computes it."""
    f32 = np.float32
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float(f32(0.0 - peak) * frac + f32(peak))
    t = f32(min(count - warmup, decay_steps - warmup))
    cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps - warmup)))
    return float(f32(peak) * cos)


def ema_decay_at(step: int, ema_decay: float) -> float:
    """min(ema_decay, (1 + step) / (10 + step)) in float32."""
    s = np.float32(step)
    return float(np.minimum(np.float32(ema_decay),
                            (np.float32(1) + s) / (np.float32(10) + s)))


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, d: float) -> None:
    """ema = ema * d + value * (1 - d) over the weights and BatchNorm
    statistics."""
    es = [t for t in ema.state_dict().values() if t.is_floating_point()]
    vs = [t for t in model.state_dict().values() if t.is_floating_point()]
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, torch._foreach_mul(vs, float(np.float32(1) - np.float32(d))))


def _on_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def pretrain(data, backbone, out, epochs=90, batch_size=256, img_size=224,
             lr=2e-3, weight_decay=0.05, smoothing=0.1, warmup_epochs=3,
             ema_decay=0.9995, seed=0, log_every=50, device="cuda"):
    device = torch.device(device)
    train_samples, classes = list_imagefolder(os.path.join(data, "train"))
    val_dir = os.path.join(data, "val")
    val_samples = (list_imagefolder(val_dir)[0]
                   if os.path.isdir(val_dir) else None)
    nc = len(classes)
    steps_per_epoch = max(1, len(train_samples) // batch_size)
    total_steps = steps_per_epoch * epochs

    model = init_weights(build_classifier(backbone, nc, torch.bfloat16), seed).to(device)
    ema = build_classifier(backbone, nc, torch.bfloat16).to(device)
    ema.load_state_dict(model.state_dict())
    ema.eval()
    opt = GroupedOptimizer({"training": {"optimizer": "adamw", "grad_clip": 1.0,
                                         "weight_decay": weight_decay}},
                           list(model.named_parameters()))
    # decay_steps counts warmup+decay; clamp warmup so short (smoke-test)
    # schedules keep a positive cosine phase
    warmup_steps = min(max(1, warmup_epochs * steps_per_epoch),
                       max(1, total_steps // 2))
    decay_steps = max(total_steps, warmup_steps + 1)

    def train_step(step, images_u8, labels):
        model.train()
        logits = model(normalize_images(images_u8))
        loss = smoothed_cross_entropy(logits, labels, smoothing)
        acc = (logits.argmax(-1) == labels).float().mean()
        grads = torch.autograd.grad(loss, opt.params, allow_unused=True,
                                    materialize_grads=True)
        opt.step(grads, [warmup_cosine_lr(step, lr, warmup_steps, decay_steps)] * 3)
        ema_update(ema, model, ema_decay_at(step, ema_decay))
        return loss.detach(), acc.detach()

    @torch.no_grad()
    def eval_step(images_u8, labels):
        logits = ema(normalize_images(images_u8))
        return (logits.argmax(-1) == labels).sum()

    rng = np.random.RandomState(seed)
    step = 0
    t0 = time.time()
    for epoch in range(epochs):
        order = rng.permutation(len(train_samples))
        for b in range(steps_per_epoch):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            imgs, labels = make_batch(train_samples, idxs, img_size, rng)
            loss, acc = train_step(step, _on_device(imgs, device),
                                   _on_device(labels.astype(np.int64), device))
            step += 1
            if step % log_every == 0:
                print(f"epoch {epoch} step {step}/{total_steps} "
                      f"loss {float(loss):.4f} acc {float(acc):.3f} "
                      f"({(time.time() - t0):.0f}s)")
        if val_samples:
            correct = 0
            for b in range(0, len(val_samples), batch_size):
                idxs = list(range(b, min(b + batch_size, len(val_samples))))
                imgs, labels = make_batch(val_samples, idxs, img_size, rng,
                                          train=False)
                correct += int(eval_step(_on_device(imgs, device),
                                         _on_device(labels.astype(np.int64), device)))
            print(f"epoch {epoch}: val top-1 {correct / len(val_samples):.4f}")

    meta = {"backbone": backbone, "source": "pretrain_backbone",
            "num_classes": nc, "epochs": epochs, "img_size": img_size,
            "classes": classes if nc <= 1000 else None}
    params, stats = to_flax(ema)
    save_checkpoint(out, params["backbone"], stats["backbone"], meta)
    print(f"wrote {out}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="imagefolder root (train/<class>/*.jpg [, val/])")
    ap.add_argument("--backbone", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, default=90)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--weight_decay", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda | cpu | cuda:<n>")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return pretrain(args.data, args.backbone, args.out, epochs=args.epochs,
                    batch_size=args.batch_size, img_size=args.img_size, lr=args.lr,
                    weight_decay=args.weight_decay, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
