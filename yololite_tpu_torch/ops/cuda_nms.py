"""Greedy-NMS suppression kernel wrapper (counterpart of `ops/pallas_nms.py`).

Replaces the Pallas TPU kernel `_suppress_kernel` launched by
`pallas_greedy_keep` (yololite_tpu/ops/pallas_nms.py), which the JAX
`batched_nms(use_pallas=True)` path calls. The CUDA source is
`yololite_tpu_torch/csrc/nms_suppress.cu`; it gives the exact greedy keep
mask (the fixpoint's unique solution) for any k.

Bound on the H100: operations, about 15 fp32 operations per pair, ~3.8 us
for all B*k*(k-1)/2 pairs at B=128, k=512 at the card's ~67 TFLOP/s fp32
(non-tensor) rate; it moves ~1 MB, which is negligible.

The first design (one block per image, the mask in shared memory, one warp
scanning the k rows one by one) lost its time to one SM per image, a mask
pass over the full square with a ballot per word, and a scan of k dependent
steps; it also capped k at 1024. The kernel now runs two launches on the
current stream: a mask pass spread over (image, 32-row chunk, column tile)
blocks that builds whole 32-bit words of the upper triangle in registers
into a [B, k, ceil(k/32)] uint32 scratch tensor (allocated here, never
zeroed), then a scan, one block per image, that resolves 32 rows at a time
in one warp's registers and ORs the kept rows into a `removed` bitset in
shared memory.

The kernel is the registered op `yololite::nms_suppress(Tensor boxes, Tensor
valid, float iou_th) -> Tensor keep` (`torch.library.custom_op`), so that
`torch.export` can trace a graph that calls it: the CUDA implementation
launches the kernel (ctypes on `data_ptr()`s, which only real tensors have)
or raises; the CPU implementation is `greedy_keep_reference` (the plain
PyTorch fixpoint on `box_iou_matrix`); the fake implementation gives the
bool [B, k] shape to a tracer. `greedy_keep` calls the op, so serving,
validation, streaming and every exported graph share one route to the
kernel. `LAUNCHES` counts kernel calls (mask pass and scan together count
one), in either mode; `LAUNCHES_DIOU` counts the DIoU ones alone.

DIoU-NMS (`batched_nms(use_diou=True)`) runs on the same kernel: the op's
`use_diou` flag picks the mask pass's DIoU instantiation, which sets a bit
where IoU - d2 / c2 > thr in JAX's op order (`ops/nms._suppression_matrix`).
JAX computes it with XLA even when the Pallas kernel is asked for; the Pallas
kernel has no DIoU mode.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
LAUNCHES_DIOU = 0
SOURCE = "yololite_tpu_torch/csrc/nms_suppress.cu"

_LIB = None


def greedy_keep_reference(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_th: float, use_diou: bool = False) -> torch.Tensor:
    """Plain PyTorch: boxes [B,k,4] (class-shifted, score-descending), valid
    [B,k] bool -> exact greedy keep [B,k] bool under IoU or DIoU."""
    from yololite_tpu_torch.ops.nms import _greedy_keep, _suppression_matrix
    return _greedy_keep(_suppression_matrix(boxes, use_diou), valid, iou_th)


def library() -> ctypes.CDLL:
    """The built `nms_suppress` library with its C functions typed:
    `yl_nms_greedy_keep` (the kernel) and its two launches `yl_nms_mask` and
    `yl_nms_scan`, which only the card's smoke run calls apart to time them."""
    global _LIB
    if _LIB is None:
        from yololite_tpu_torch.csrc.build import load
        lib = load("nms_suppress")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.yl_nms_greedy_keep.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, i32, ptr]
        lib.yl_nms_mask.argtypes = [ptr, ptr, ptr, i32, i32, f32, i32, ptr]
        lib.yl_nms_scan.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
        for fn in (lib.yl_nms_greedy_keep, lib.yl_nms_mask, lib.yl_nms_scan):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def mask_words(k: int) -> int:
    """32-bit words per row of the kernel's suppression bitmask."""
    return (k + 31) // 32


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_th: float, use_diou: bool = False) -> torch.Tensor:
    """boxes [B,k,4] float32 (class-shifted, score-descending), valid [B,k]
    bool -> keep [B,k] bool under IoU (or DIoU), through
    `torch.ops.yololite.nms_suppress`: CUDA tensors launch the kernel, CPU
    tensors take `greedy_keep_reference`."""
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"greedy_keep: unsupported device {boxes.device}")
    return torch.ops.yololite.nms_suppress(boxes, valid, float(iou_th), bool(use_diou))


@torch.library.custom_op("yololite::nms_suppress", mutates_args=(), device_types="cpu")
def nms_suppress(boxes: torch.Tensor, valid: torch.Tensor, iou_th: float,
                 use_diou: bool = False) -> torch.Tensor:
    """The plain version (a fresh tensor: an op's output may not alias `valid`)."""
    return greedy_keep_reference(boxes, valid, iou_th, use_diou).clone()


@nms_suppress.register_kernel("cuda")
def _nms_suppress_cuda(boxes: torch.Tensor, valid: torch.Tensor, iou_th: float,
                       use_diou: bool = False) -> torch.Tensor:
    """Launch the kernel on the current stream, or raise."""
    global LAUNCHES, LAUNCHES_DIOU
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
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    scratch = torch.empty((b, k, mask_words(k)), dtype=torch.int32, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().yl_nms_greedy_keep(boxes.data_ptr(), valid.data_ptr(),
                                           keep.data_ptr(), scratch.data_ptr(),
                                           b, k, float(iou_th), int(use_diou), stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_DIOU += bool(use_diou)
    return keep


@nms_suppress.register_fake
def _nms_suppress_fake(boxes: torch.Tensor, valid: torch.Tensor, iou_th: float,
                       use_diou: bool = False) -> torch.Tensor:
    return torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
