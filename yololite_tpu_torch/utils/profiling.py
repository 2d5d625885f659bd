"""Profiling utilities (port of `utils/profiling.py`).

`trace(log_dir)` records a `torch.profiler` trace of the block it wraps (host
ops, and the card's kernels and copies when CUDA is present) into
`<log_dir>/profile/trace_<ms>.json`, Chrome-trace JSON that opens in Perfetto
or chrome://tracing; with no `log_dir` it does nothing. `start_trace` /
`stop_trace` are the same trace split in two, for a window that a loop opens
and closes (the training loop's `profile` flag). `StageTimer` accumulates
wall-clock milliseconds per named stage and reports mean / p50 / p90 / p95,
with the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


def start_trace(out_dir: str) -> torch.profiler.profile:
    """Start a profiler trace that `stop_trace` writes into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, out_dir: str) -> str:
    """Stop `prof` and write its Chrome trace; returns the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(out_dir, f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace into <log_dir>/profile (no-op if None)."""
    if not log_dir:
        yield
        return
    out = os.path.join(log_dir, "profile")
    prof = start_trace(out)
    try:
        yield
    finally:
        stop_trace(prof, out)


class StageTimer:
    """Accumulates wall-clock per named stage; reports mean/p50/p90/p95."""

    def __init__(self):
        self.samples = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def report(self):
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            out[k] = {"mean_ms": float(a.mean()), "p50_ms": float(np.percentile(a, 50)),
                      "p90_ms": float(np.percentile(a, 90)),
                      "p95_ms": float(np.percentile(a, 95)), "n": len(v)}
        return out
