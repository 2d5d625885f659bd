from yololite_tpu_torch.track.kalman import (
    KalmanSortTracker, xyxy_to_cxsysr, cxsysr_to_xyxy, iou_xyxy,
)

__all__ = ["KalmanSortTracker", "xyxy_to_cxsysr", "cxsysr_to_xyxy", "iou_xyxy"]
