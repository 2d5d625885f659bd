"""Greedy-NMS suppression kernel wrapper (counterpart of `ops/pallas_nms.py`).

Replaces the Pallas TPU kernel `_suppress_kernel` launched by
`pallas_greedy_keep` (yololite_tpu/ops/pallas_nms.py), which the JAX
`batched_nms(use_pallas=True)` path calls. The CUDA source is
`yololite_tpu_torch/csrc/nms_suppress.cu`: one thread block per image builds
the k x k suppression bitmask in shared memory and one warp runs the greedy
scan, giving the exact greedy keep mask (the fixpoint's unique solution).

Bound on the H100: fp32 compute, about 15 operations per pair over
B*k*(k-1)/2 pairs, ~3.8 us for B=128, k=512 at the card's ~67 TFLOP/s fp32
(non-tensor) rate; it moves ~1 MB, which is negligible. The greedy scan is a
chain of k dependent steps, so the kernel is latency-bound well above that
bound; making the scan shorter is later work.

`greedy_keep` takes CPU tensors to `greedy_keep_reference` (the plain PyTorch
fixpoint on `box_iou_matrix`); for CUDA tensors it launches the kernel or
raises. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
MAX_K = 1024
SOURCE = "yololite_tpu_torch/csrc/nms_suppress.cu"

_FN = None


def greedy_keep_reference(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_th: float) -> torch.Tensor:
    """Plain PyTorch: boxes [B,k,4] (class-shifted, score-descending), valid
    [B,k] bool -> exact greedy keep [B,k] bool."""
    from yololite_tpu_torch.ops.boxes import box_iou_matrix
    from yololite_tpu_torch.ops.nms import _greedy_keep
    return _greedy_keep(box_iou_matrix(boxes, boxes), valid, iou_th)


def _kernel():
    global _FN
    if _FN is None:
        from yololite_tpu_torch.csrc.build import load
        fn = load("nms_suppress").yl_nms_greedy_keep
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_th: float) -> torch.Tensor:
    """boxes [B,k,4] float32 (class-shifted, score-descending), valid [B,k]
    bool -> keep [B,k] bool. CUDA tensors go through the kernel, CPU tensors
    through `greedy_keep_reference`."""
    global LAUNCHES
    if boxes.device.type == "cpu":
        return greedy_keep_reference(boxes, valid, iou_th)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_keep: unsupported device {boxes.device}")
    if boxes.dtype != torch.float32 or boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"greedy_keep: boxes must be float32 [B,k,4], got "
                         f"{boxes.dtype} {tuple(boxes.shape)}")
    b, k, _ = boxes.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k):
        raise ValueError(f"greedy_keep: valid must be bool [{b},{k}], got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if valid.device != boxes.device:
        raise ValueError("greedy_keep: boxes and valid on different devices")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_keep: inputs must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"greedy_keep: k={k} outside 1..{MAX_K}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return keep
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                        b, k, float(iou_th), stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return keep
