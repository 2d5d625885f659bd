"""Host-driven learning-rate schedules (port of `train/schedulers.py`; the
same pure-Python code, so every schedule's LR sequence is equal).

cosine / step / multistep / onecycle (per step) / plateau / none, plus the
manual warmup (lr = base * 0.1 in epoch 0, then base * (0.1 + 0.9 e / warmup)
until warmup ends). The LR is computed on the host each step and passed to
the train step as numbers, so plateau logic and warmup need no graph change.

Like the JAX package, StepLR steps once per epoch, not inside the validation
loop as the reference did.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional


class Scheduler:
    """Returns an LR multiplier relative to base lr.

    Call `epoch_factor(epoch)` for the factor used during that epoch, and
    `step_factor(global_step, total_steps)` for per-step schedules (onecycle).
    `observe(metric)` feeds plateau.
    """

    def __init__(self, cfg: Dict[str, Any], steps_per_epoch: int):
        tr = cfg.get("training", {})
        sch = tr.get("scheduler", None)
        if isinstance(sch, bool):
            sch = {"type": "none"} if sch else None
        if isinstance(sch, str):
            sch = {"type": sch}
        if not isinstance(sch, dict):
            sch = {"type": "none"}
        self.type = str(sch.get("type", "none")).lower()
        if self.type in ("off", "disable"):
            self.type = "none"
        self.cfg = sch
        self.epochs = int(tr.get("epochs", 100))
        self.steps_per_epoch = max(1, int(steps_per_epoch))
        self.warmup_epochs = int(tr.get("warmup_epochs", 0) or 0)
        # plateau state
        self._plateau_factor = 1.0
        self._best: Optional[float] = None
        self._bad = 0
        # epoch-stepped scheduler counter (steps at end of non-warmup epochs,
        # matching train.py:381-388)
        self._sched_steps = 0

    # ------------------------------------------------------------------ #
    def _cosine(self, t: int) -> float:
        t_max = int(self.cfg.get("t_max", self.epochs))
        eta_min = float(self.cfg.get("min_lr", 0.0))
        # factor relative to base lr; eta_min expressed as absolute lr in torch,
        # we treat it as a factor floor when min_lr < base (documented).
        return eta_min + (1.0 - eta_min) * 0.5 * (1.0 + math.cos(math.pi * min(t, t_max) / t_max))

    def _step(self, t: int) -> float:
        size = int(self.cfg.get("step_size", 30))
        gamma = float(self.cfg.get("gamma", 0.1))
        return gamma ** (t // size)

    def _multistep(self, t: int) -> float:
        milestones = sorted(self.cfg.get("milestones", [60, 80]))
        gamma = float(self.cfg.get("gamma", 0.1))
        return gamma ** sum(1 for m in milestones if t >= m)

    def _onecycle(self, global_step: int) -> float:
        total = self.epochs * self.steps_per_epoch
        pct_start = float(self.cfg.get("pct_start", 0.3))
        div = float(self.cfg.get("div_factor", 25.0))
        final_div = float(self.cfg.get("final_div_factor", 1e4))
        max_lr_f = 1.0  # max_lr defaults to the param-group lr (schedulers.py:40-47)
        up = max(1, int(total * pct_start))
        if global_step < up:
            p = global_step / up
            lo = max_lr_f / div
            return lo + (max_lr_f - lo) * 0.5 * (1.0 - math.cos(math.pi * p))
        p = min(1.0, (global_step - up) / max(1, total - up))
        lo = max_lr_f / final_div
        return lo + (max_lr_f - lo) * 0.5 * (1.0 + math.cos(math.pi * p))

    # ------------------------------------------------------------------ #
    def observe(self, metric: float):
        """Plateau: reference steps with mode='max' on avg val loss
        (schedulers.py:58-66, train.py:521-522)."""
        if self.type != "plateau":
            return
        patience = int(self.cfg.get("patience", 5))
        factor = float(self.cfg.get("factor", 0.1))
        min_lr = float(self.cfg.get("min_lr", 0.0))
        if self._best is None or metric > self._best:
            self._best = metric
            self._bad = 0
        else:
            self._bad += 1
            if self._bad > patience:
                self._plateau_factor = max(self._plateau_factor * factor, min_lr)
                self._bad = 0

    def fast_forward(self, start_epoch: int):
        """Chunked resume (`training.start_epoch`): replay the epoch stepping
        for the epochs a previous process already ran, so cosine/step/
        multistep continue mid-schedule instead of restarting. Plateau state
        is metric-history-dependent and starts fresh (documented)."""
        for e in range(max(0, int(start_epoch))):
            self.end_epoch(e)

    def end_epoch(self, epoch: int):
        """Advance epoch-stepped schedulers (mirrors train.py:381-388 ordering)."""
        if self.type == "onecycle":
            return
        in_warmup = self.warmup_epochs > 0 and epoch < self.warmup_epochs
        if not in_warmup and self.type in ("cosine", "step", "multistep"):
            self._sched_steps += 1

    def lr_factor(self, epoch: int, global_step: int) -> float:
        """LR factor in effect during `epoch` at `global_step`."""
        if self.type == "onecycle":
            return self._onecycle(global_step)
        if self.warmup_epochs > 0 and epoch == 0:
            return 0.1
        if self.warmup_epochs > 0 and epoch <= self.warmup_epochs:
            return 0.1 + 0.9 * (epoch / self.warmup_epochs)
        if self.type == "cosine":
            return self._cosine(self._sched_steps)
        if self.type == "step":
            return self._step(self._sched_steps)
        if self.type == "multistep":
            return self._multistep(self._sched_steps)
        if self.type == "plateau":
            return self._plateau_factor
        return 1.0


def build_scheduler(cfg: Dict[str, Any], steps_per_epoch: int) -> Scheduler:
    return Scheduler(cfg, steps_per_epoch)
