"""Utilities (port of `utils/`): the profiler trace and the stage timer. The
drawing helpers of `utils/viz.py` are not ported (ROADMAP Queue 1 item 8d)."""

from yololite_tpu_torch.utils.profiling import StageTimer, trace

__all__ = ["trace", "StageTimer"]
