"""Metric plotting from metrics.csv (port of `eval/plots.py`; skipped without
matplotlib).

Parity with reference `plot_metrics` (scripts/data/plot_metrics.py:24-258):
reads the training metrics CSV, EMA-smooths each series (alpha=0.2 default),
writes one PNG per metric with best-point annotation plus a combined overview.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

METRIC_COLS = ["AP", "AP50", "AP75", "APS", "APM", "APL", "AR",
               "train_loss", "val_loss"]


def _ema_smooth(values: np.ndarray, alpha: float) -> np.ndarray:
    if len(values) == 0 or alpha <= 0:
        return values
    out = np.empty_like(values, dtype=np.float64)
    out[0] = values[0]
    for i in range(1, len(values)):
        out[i] = alpha * values[i] + (1 - alpha) * out[i - 1]
    return out


def read_metrics_csv(path: str) -> Dict[str, np.ndarray]:
    cols: Dict[str, List[float]] = {}
    with open(path, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        for row in reader:
            for k, v in row.items():
                if k is None:
                    continue
                try:
                    cols.setdefault(k, []).append(float(v))
                except (TypeError, ValueError):
                    cols.setdefault(k, []).append(np.nan)
    return {k: np.asarray(v) for k, v in cols.items()}


def plot_metrics(csv_path: str, out_dir: str, smooth: float = 0.2,
                 style: str = "dark") -> None:
    if not os.path.exists(csv_path):
        return
    os.makedirs(out_dir, exist_ok=True)
    data = read_metrics_csv(csv_path)
    epochs = data.get("epoch", np.arange(1, 1 + len(next(iter(data.values()), []))))
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        if style == "dark":
            plt.style.use("dark_background")
        for key in METRIC_COLS:
            if key not in data or np.all(np.isnan(data[key])):
                continue
            y = data[key]
            ys = _ema_smooth(y, smooth)
            plt.figure(figsize=(7, 4))
            plt.plot(epochs, y, alpha=0.35, label=key)
            plt.plot(epochs, ys, linewidth=2, label=f"{key} (smoothed)")
            lower_better = key.endswith("loss")
            bi = int(np.nanargmin(y)) if lower_better else int(np.nanargmax(y))
            plt.scatter([epochs[bi]], [y[bi]], zorder=5)
            plt.annotate(f"best {y[bi]:.4f} @ {int(epochs[bi])}",
                         (epochs[bi], y[bi]), textcoords="offset points",
                         xytext=(5, 8), fontsize=8)
            plt.xlabel("epoch")
            plt.ylabel(key)
            plt.title(key)
            plt.grid(True, linestyle=":", alpha=0.4)
            plt.legend()
            plt.tight_layout()
            plt.savefig(os.path.join(out_dir, f"{key}.png"))
            plt.close()

        # combined overview
        plt.figure(figsize=(10, 6))
        for key in ("AP", "AP50", "AP75", "AR"):
            if key in data and not np.all(np.isnan(data[key])):
                plt.plot(epochs, _ema_smooth(data[key], smooth), label=key)
        plt.xlabel("epoch")
        plt.ylabel("metric")
        plt.title("Training overview")
        plt.grid(True, linestyle=":", alpha=0.4)
        plt.legend()
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, "overview.png"))
        plt.close()
        plt.style.use("default")
    except Exception:
        pass
