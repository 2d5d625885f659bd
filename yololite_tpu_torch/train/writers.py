"""Optional metric writers next to metrics.csv (port of `train/writers.py`,
the same code).

The primary metrics artifact stays the dependency-free metrics.csv + plot
suite. These writers add live dashboards when their backends are
importable; absent backends degrade to no-ops with one warning, never a
crash.

  logging.tensorboard: true   -> <log_dir>/tb/ event files (tf.summary)
  logging.wandb: <project>    -> Weights & Biases run (if `wandb` installed)
"""

from __future__ import annotations

import os
from typing import Dict, Optional


class MetricWriters:
    def __init__(self, log_dir: str, logging_cfg: Optional[Dict] = None):
        cfg = logging_cfg or {}
        self._tb = None
        self._wandb = None
        if cfg.get("tensorboard"):
            try:
                import tensorflow as tf
                self._tb = tf.summary.create_file_writer(
                    os.path.join(log_dir, "tb"))
            except Exception as e:  # no tensorflow in this env
                print(f"[writers] tensorboard disabled ({e})")
        project = cfg.get("wandb")
        if project:
            try:
                import wandb
                self._wandb = wandb.init(
                    project=str(project), dir=log_dir,
                    name=os.path.basename(os.path.abspath(log_dir)),
                    reinit=True)
            except Exception as e:
                print(f"[writers] wandb disabled ({e})")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        scalars = {k: float(v) for k, v in scalars.items()
                   if v is not None and v == v}  # drop NaN/None
        if self._tb is not None:
            import tensorflow as tf
            with self._tb.as_default():
                for k, v in scalars.items():
                    tf.summary.scalar(k, v, step=step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
