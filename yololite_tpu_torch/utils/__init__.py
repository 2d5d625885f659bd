"""Utilities (port of `utils/`): the drawing helpers, the profiler trace and
the stage timer."""

from yololite_tpu_torch.utils.viz import draw_detections, visualize_batch, save_val_debug
from yololite_tpu_torch.utils.profiling import trace, StageTimer

__all__ = ["draw_detections", "visualize_batch", "save_val_debug", "trace",
           "StageTimer"]
