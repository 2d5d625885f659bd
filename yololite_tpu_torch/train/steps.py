"""Train / eval / predict steps (port of `train/steps.py`).

One train step: uint8 batch -> (with `device_augment`: photometric
augmentation, `data/device_augment.py`, its generator seeded from the seed
and the micro-step counter, so a resumed run replays the same stream) ->
normalize -> detector (train mode, bf16 under
autocast when `amp`) -> SimOTA loss (fp32) -> gradients -> the grouped
optax-equivalent update (`train/optim.py`) -> EMA of parameters and BatchNorm
statistics (`train/ema.py`). With `accumulate = k > 1` the gradients of k
micro-steps are summed and their mean applied on every k-th.

The eval step runs the EMA model: val loss, then decode -> scores ->
class-aware `batched_nms` (pre-NMS top-k 1024, JAX's default), whose greedy
suppression is the `nms_suppress` CUDA kernel on the card.

With `training.qat`, every conv of the model is a `FakeQuantConv2d`
(`ops/quant.py`): its quantized calls fake-quantize input and weights, in
the train step and in the eval step, as JAX wraps both in
`fake_quant_training()`. The EMA copy and every model made from this one
share it; parameters, state_dict keys and checkpoints stay plain.

A segmentation model also returns prototypes: the loss adds its mask term
against the GT masks, which ship bit-packed along W and are unpacked on the
device (`gt_masks_from_batch`), and `detect` assembles the masks of the
`max_det` slots (`ops/masks.py`).

The state lives in torch modules and tensors on `device`; counters are host
integers, so nothing waits for the device but reading the metrics.

With `parallel` (a `parallel.DataParallel` of more than one process) the
Trainer is one replica of a data-parallel run, as JAX's `Trainer(mesh=)`:
each process steps on its rows of the global batch, the forwards run inside
`parallel.active` (BatchNorm's batch statistics and the fake-quant scale
are the global batch's), the device augmentation draws for the global batch
and keeps its rows, the gradients are summed over processes once an update
(the accumulated sum with `accumulate > 1`), so clipping and the optimizer
see the global gradient, and the metrics are summed (`pos` over the global
batch). The state is rank 0's from the start (`broadcast_state`); every
replica then applies the same update and stays equal to it.

With a spatial axis in that mesh (`parallel.n_spatial > 1`, JAX's
`spatial` mesh axis) the `n_spatial` ranks of a data index hold the same
images: each normalizes (and device-augments, with the data index's draws)
the whole image, then runs the model on its rows of it
(`parallel/spatial.py`); each level's outputs, and a segmentation model's
prototypes, are gathered over the spatial ranks, so the loss, SimOTA and
decode see whole maps, and every rank of a data index computes the same
loss. The gradients are summed over every rank, the metrics over the data
ranks only (a sum over every rank would count each image `n_spatial`
times). The eval step decodes and suppresses on every rank; the
validation takes the detections of each data index's first rank.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yololite_tpu_torch.convert import (from_flax, from_flax_params, load_flax, to_flax,
                                        to_flax_params)
from yololite_tpu_torch.data.device_augment import photometric_augment
from yololite_tpu_torch.losses import LossConfig, SimOTALoss
from yololite_tpu_torch.models.detector import init_weights
from yololite_tpu_torch.ops.decode import decode_anchorfree
from yololite_tpu_torch.ops.masks import assemble_masks_batch
from yololite_tpu_torch.ops.nms import batched_nms, yolo_scores
from yololite_tpu_torch.ops.quant import fake_quant
from yololite_tpu_torch.parallel import dist as pdist
from yololite_tpu_torch.parallel import spatial as pspatial
from yololite_tpu_torch.train.ema import ema_update, ema_warmup_limit
from yololite_tpu_torch.train.optim import GroupedOptimizer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BATCH_KEYS = ("image", "boxes", "labels", "mask")
MASK_KEYS = ("masks", "masks_packed")


@functools.lru_cache(maxsize=8)
def _mean_std(device: torch.device):
    """ImageNet mean/std [1,3,1,1] on `device`, made once (a copy from the
    host per step would wait for the stream), outside inference mode."""
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1),
                torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1))


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [B,S,S,3] -> normalized [B,3,S,S] (a channels_last view)."""
    x = images_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
    mean, std = _mean_std(x.device)
    return ((x - mean) / std).to(dtype)


def gt_masks_from_batch(batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """GT masks [B,M,Hp,Wp] on the batch's device, or None. Seg batches ship
    them bit-packed along W ([B,M,Hp,ceil(Wp/8)], most significant bit
    first, as np.packbits); the width is Hp (square prototypes). A batch with
    raw "masks" passes them through."""
    if "masks_packed" in batch:
        mp = batch["masks_packed"]
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=mp.device)
        bits = (mp[..., None] >> shifts) & 1                       # [..., Wb, 8]
        return bits.reshape(*mp.shape[:-1], -1)[..., :mp.shape[-2]]
    return batch.get("masks")


def split_outputs(out, with_masks: bool):
    """The model's output -> (per-level maps, prototypes or None)."""
    return out if with_masks else (out, None)


@dataclasses.dataclass
class TrainState:
    model: nn.Module                    # raw training weights (params + BN stats)
    ema: nn.Module                      # EMA copy, what is validated and saved
    opt: GroupedOptimizer
    updates: int = 0                    # optimizer steps
    micro: int = 0                      # micro-steps (== updates unless accumulating)
    grad_accum: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[torch.Tensor]:
        return self.opt.params


class Trainer:
    """Owns the model, loss, optimizer settings and the step functions."""

    def __init__(self, model: nn.Module, config: Dict[str, Any],
                 total_updates: int = 10000, device: str = "cuda",
                 parallel: Optional[pdist.DataParallel] = None):
        tr = config.get("training", {})
        self.parallel = parallel if pdist.is_multiprocess(parallel) else None
        self.spatial = pspatial.Spatial.of(self.parallel)
        self._data_group = None if self.parallel is None else pdist.mesh_groups(self.parallel)[1]
        self.qat = bool(tr.get("qat", False))
        if self.qat:        # fake-quant convs in the train and eval steps
            fake_quant(model)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        if self.device.type == "cuda":
            self.model.to(memory_format=torch.channels_last)
        self.config = config
        self.img_size = int(tr.get("img_size", 640))
        self.with_masks = bool(getattr(model, "with_masks", False))
        self.loss = SimOTALoss(LossConfig.from_config(config))
        self.use_ema = bool(tr.get("ema", True))
        self.ema_decay = float(tr.get("ema_decay", 0.995) or 0.995)
        self.ema_warmup = ema_warmup_limit(total_updates)
        self.accumulate = max(1, int(tr.get("accumulate", 1) or 1))
        self.amp = bool(tr.get("amp", True))
        self.hyper = GroupedOptimizer(config, []).hyper
        # photometric augmentation in the train step, only when the host
        # pipeline skips its own (device_augment) and augmentation is on
        self.device_augment = bool(tr.get("device_augment", False)) and \
            bool(tr.get("augment", True))
        self.aug_seed = int(tr.get("seed", 1337) or 0) + 7
        self._aug_gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------------ #
    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.amp)

    def _make_state(self) -> TrainState:
        opt = GroupedOptimizer(self.config, list(self.model.named_parameters()))
        if self.parallel is not None:       # every replica starts as rank 0's
            pdist.broadcast_state([self.model])
        ema = copy.deepcopy(self.model)
        accum = ([torch.zeros_like(p) for p in opt.params]
                 if self.accumulate > 1 else None)
        return TrainState(model=self.model, ema=ema, opt=opt, grad_accum=accum)

    def init_state(self, seed: int = 0) -> TrainState:
        """Seeded weights (`init_weights`; not the JAX package's flax init)."""
        init_weights(self.model, seed)
        return self._make_state()

    def state_from_weights(self, params, batch_stats) -> TrainState:
        """Load flax-layout weights; fresh EMA and optimizer."""
        load_flax(self.model, params, batch_stats)
        return self._make_state()

    def state_from_full(self, state_dict) -> TrainState:
        """Exact resume from a checkpoint saved with save_optimizer=True: the
        raw weights, the EMA copies, the optimizer state and the counters;
        missing pieces stay fresh, as in JAX."""
        raw_p = state_dict.get("raw_params", state_dict["params"])
        raw_bs = state_dict.get("raw_batch_stats", state_dict["batch_stats"])
        st = self.state_from_weights(raw_p, raw_bs)
        if state_dict.get("ema_params") is not None:
            sd = from_flax(state_dict["ema_params"],
                           state_dict.get("ema_batch_stats") or raw_bs)
            st.ema.load_state_dict(sd)
        updates = state_dict.get("updates")
        if updates is not None:
            st.updates = int(np.asarray(updates))
            st.micro = int(np.asarray(state_dict.get("micro", updates)))
        opt = state_dict.get("opt_state")
        if opt is not None:
            try:
                st.opt.load_state_dict(self._opt_from_flax(opt))
            except (KeyError, ValueError) as e:   # optimizer layout changed
                print(f"[resume] optimizer state not restored ({e}); fresh moments")
        if self.parallel is not None:
            self._broadcast(st)
        return st

    def _broadcast(self, state: TrainState) -> None:
        """Make `state` rank 0's: weights, EMA, optimizer moments,
        accumulator and counters."""
        opt = state.opt
        moments = [t for ts in (opt.mu, opt.nu, opt.trace) if ts is not None for t in ts]
        pdist.broadcast_state([state.model, state.ema],
                              moments + list(state.grad_accum or []))
        state.updates, state.micro, opt.count = pdist.broadcast_object(
            (state.updates, state.micro, opt.count))

    def _opt_from_flax(self, opt: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for i, entry in opt.items():
            entry = dict(entry)
            for key in ("mu", "nu", "trace"):
                if key in entry:
                    entry[key] = from_flax_params(self.model, entry[key])
            out[i] = entry
        return out

    def full_state(self, state: TrainState) -> Dict[str, Any]:
        """The `save_optimizer` extras in the JAX package's layout."""
        raw_p, raw_bs = to_flax(state.model)
        ema_p, ema_bs = to_flax(state.ema) if self.use_ema else (raw_p, raw_bs)
        opt = {}
        for i, entry in state.opt.state_dict().items():
            opt[i] = {k: (to_flax_params(state.model, v) if isinstance(v, dict) else v)
                      for k, v in entry.items()}
        return {"raw_params": raw_p, "raw_batch_stats": raw_bs,
                "ema_params": ema_p, "ema_batch_stats": ema_bs,
                "updates": np.asarray(state.updates, np.int32),
                "micro": np.asarray(state.micro, np.int32), "opt_state": opt}

    def variables_from_flax(self, params, batch_stats) -> nn.Module:
        """A copy of the model holding these flax-layout weights, on the device."""
        model = copy.deepcopy(self.model)
        load_flax(model, params, batch_stats)
        return model.eval()

    def lr_vector(self, lr: float, freeze_backbone: bool = False) -> List[float]:
        """Absolute per-group LRs [backbone, neck, head] for this step."""
        bb = 0.0 if freeze_backbone else lr * self.hyper["bb_mult"]
        return [float(np.float32(v)) for v in
                (bb, lr * self.hyper["neck_mult"], lr * self.hyper["head_mult"])]

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors (pinned, non-blocking on the card);
        `img_valid` marks real images (padding images have id -1)."""
        keep = {k: batch[k] for k in BATCH_KEYS + MASK_KEYS if k in batch}
        if "image_id" in batch:
            keep["img_valid"] = np.asarray(batch["image_id"]) >= 0
        out = {}
        for k, v in keep.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # ------------------------------------------------------------------ #
    def forward_loss(self, state: TrainState, batch: Dict[str, torch.Tensor],
                     return_assignment: bool = False):
        """Train-mode forward (BatchNorm statistics update) and loss."""
        state.model.train()
        images = batch["image"]
        if self.device_augment:
            gb = self._global_batch(images.shape[0])
            rows = None if gb is None else (gb, self.parallel.world_rows(gb))
            images = photometric_augment(images, self.aug_generator(state.micro), rows=rows)
        x = normalize_images(images, next(state.model.parameters()).dtype)
        targets = self._targets(batch)
        with self._autocast(), pdist.active(self.parallel):
            outs, protos = self._run_model(state.model, x)
        return self.loss([o.float() for o in outs], targets,
                         None if protos is None else protos.float(),
                         img_size=int(batch["image"].shape[1]),
                         return_assignment=return_assignment,
                         global_batch=self._global_batch(images.shape[0]))

    def _run_model(self, model: nn.Module, x: torch.Tensor):
        """(per-level maps, prototypes or None) of the whole images `x`: under
        a spatial mesh (inside `pdist.active`) from this rank's rows,
        gathered over the spatial ranks."""
        if self.spatial is None or pdist.current() is None:
            return split_outputs(model(x), self.with_masks)
        out, full = pspatial.forward(model, x, self.spatial)
        (outs, protos), (f_outs, f_protos) = (split_outputs(o, self.with_masks)
                                              for o in (out, full))
        outs = [pspatial.gather(o, f.shape[2], 2, self.spatial) for o, f in zip(outs, f_outs)]
        if protos is not None:      # NHWC
            protos = pspatial.gather(protos, f_protos.shape[1], 1, self.spatial)
        return outs, protos

    def _global_batch(self, rows: int) -> Optional[int]:
        """The global batch of a data-parallel step on `rows` rows, or None."""
        return None if self.parallel is None else rows * self.parallel.n_data

    def _reduce_grads(self, grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """The sum over processes (in place), or `grads` in one process."""
        return grads if self.parallel is None else pdist.all_reduce_grads(grads)

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalar metrics summed over the data ranks, in one all-reduce."""
        if self.parallel is None or self.parallel.n_data == 1:
            return metrics
        keys = sorted(k for k, v in metrics.items() if v.dim() == 0)
        summed = pdist.all_reduce_(torch.stack([metrics[k].float() for k in keys]),
                                   self._data_group)
        return dict(metrics, **{k: summed[i].to(metrics[k].dtype) for i, k in enumerate(keys)})

    @staticmethod
    def _targets(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        targets = {k: batch[k] for k in ("boxes", "labels", "mask")}
        gtm = gt_masks_from_batch(batch)
        if gtm is not None:
            targets["masks"] = gtm
        return targets

    def aug_generator(self, micro: int) -> torch.Generator:
        """The device augmentation's generator for this micro-step, seeded
        from (seed, micro) as JAX's fold_in(key, micro)."""
        return self._aug_gen.manual_seed((self.aug_seed << 32) | int(micro))

    def backward(self, state: TrainState, total: torch.Tensor) -> List[torch.Tensor]:
        """Gradients of every parameter; zeros for the ones the loss does not
        depend on (the P6 modules without `use_p6`), as `jax.grad` gives."""
        return list(torch.autograd.grad(total, state.params, allow_unused=True,
                                        materialize_grads=True))

    def apply(self, state: TrainState, grads: Sequence[torch.Tensor],
              lr_vec: Sequence[float]) -> None:
        """Optimizer (+ EMA) on summed or single-step gradients (summed over
        processes first, once an update)."""
        if self.accumulate == 1:
            state.updates += 1
            self._apply_grads(state, self._reduce_grads(grads), lr_vec)
        else:
            torch._foreach_add_(state.grad_accum, list(grads))
            if (state.micro + 1) % self.accumulate == 0:
                state.updates += 1
                self._reduce_grads(state.grad_accum)
                mean_g = torch._foreach_div(state.grad_accum, float(self.accumulate))
                self._apply_grads(state, mean_g, lr_vec)
                torch._foreach_zero_(state.grad_accum)
        state.micro += 1

    def _apply_grads(self, state: TrainState, grads, lr_vec) -> None:
        state.opt.step(grads, lr_vec)
        if self.use_ema:
            ema_update(list(state.ema.state_dict().values()),
                       list(state.model.state_dict().values()),
                       state.updates, self.ema_decay, self.ema_warmup)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   lr_vec: Sequence[float]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        total, metrics = self.forward_loss(state, batch)
        grads = self.backward(state, total)
        self.apply(state, grads, lr_vec)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total"] = total.detach()
        return state, self._reduce_metrics(metrics)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def eval_forward(self, variables: nn.Module, images_u8: torch.Tensor):
        """-> (per-level maps, prototypes or None), fp32. The images are
        normalized in fp32 and cast to the model's dtype (a bf16 model, such
        as the int8 Predictor's, also runs with amp off, as a flax module
        casts its input)."""
        variables.eval()
        x = normalize_images(images_u8, next(variables.parameters()).dtype)
        with self._autocast():
            outs, protos = self._run_model(variables, x)
        return [o.float() for o in outs], None if protos is None else protos.float()

    def detect(self, outs, conf_th: float, iou_th: float, max_det: int,
               img_size: Optional[int] = None, protos: Optional[torch.Tensor] = None):
        """decode -> score -> NMS (-> mask assembly), on the device."""
        img_size = int(img_size or self.img_size)
        d = decode_anchorfree(outs, img_size, num_classes=self.model.num_classes
                              if protos is not None else None)
        scores, classes = yolo_scores(d["obj"][..., 0], d["cls"])
        boxes, s, c, v, idx = batched_nms(d["box"], scores, classes, iou_th=iou_th,
                                          conf_th=conf_th, max_det=max_det)
        dets = {"boxes": boxes, "scores": s, "classes": c, "valid": v, "idx": idx}
        if protos is not None:
            coef = torch.gather(d["coef"], 1, idx[..., None].long().expand(
                -1, -1, d["coef"].shape[-1]))
            dets["masks"] = assemble_masks_batch(protos, coef, boxes, float(img_size))
        return dets

    @torch.no_grad()
    def eval_step(self, variables: nn.Module, batch: Dict[str, torch.Tensor],
                  conf_th: float = 0.001, iou_th: float = 0.65, max_det: int = 300):
        """EMA-model forward -> val loss + decoded, NMS'd detections (and
        masks for a segmentation model). Data-parallel: `batch` is this
        process's rows; the metrics are summed over the data ranks, the
        detections are this process's (under a spatial mesh, of its data
        index's rows, decoded from the gathered maps on every rank)."""
        with pdist.active(self.parallel):
            outs, protos = self.eval_forward(variables, batch["image"])
        img_size = int(batch["image"].shape[1])
        total, metrics = self.loss(outs, self._targets(batch), protos, img_size=img_size,
                                   img_valid=batch.get("img_valid"),
                                   global_batch=self._global_batch(batch["image"].shape[0]))
        dets = self.detect(outs, conf_th, iou_th, max_det, img_size, protos)
        metrics = dict(metrics)
        metrics["total"] = total
        return self._reduce_metrics(metrics), dets

    # ------------------------------------------------------------------ #
    def ema_variables(self, state: TrainState) -> nn.Module:
        return state.ema if self.use_ema else state.model
