"""Dynamic int8 convolution kernels: wrappers and their plain versions.

The JAX package computes its int8 path (`ops/quant.py:_int8_conv`) in plain
XLA: quantize the activation with one dynamic per-tensor scale, run the conv
on s8 x s8 with int32 accumulators, rescale in fp32. PyTorch on CUDA has no
int8 convolution, and an emulation in fp32 stops being exact once a sum
passes 2^24, so the port runs three kernels written for Hopper in
`csrc/int8_conv.cu` (built by `csrc/build.py`, loaded with ctypes):

  int8_quantize        s_x = max|x| / 127 over the whole tensor, then
                       x_q = clip(round_half_even(x / max(s_x, 1e-12)), -127, 127)
  int8_conv_dense      groups = 1: int32 acc over (ky, kx, c), then
                       float(acc) * (s_x * s_w[o]) + b[o] in the output type
  int8_conv_depthwise  groups = cin = cout, the same epilogue

Each wrapper takes NHWC memory (a channels_last NCHW tensor) and returns it.
On a CUDA tensor it launches its kernel on the current stream or raises; on
a CPU tensor it computes the plain PyTorch version (`*_reference`), which
repeats the kernel's arithmetic: the quantize in ATen, the conv as
`F.conv2d` in float64 on the int8 values (exact: every sum stays below
2^53) rounded to int32, then the same epilogue. The two agree bit for bit.
`LAUNCHES` counts launches per kernel name (the quantize's two passes count
one). `out_dtype=torch.int32` returns the raw accumulators.

Weights come packed once (`pack_dense`, `pack_depthwise`) from the int8
OIHW kernel: dense as [O, Kp] with K = kh*kw*cin ordered (ky, kx, c) and
zero-padded to a multiple of 32, depthwise as [kh, kw, C].
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

SOURCE = "yololite_tpu_torch/csrc/int8_conv.cu"
KERNEL_NAMES = ("int8_quantize", "int8_conv_dense", "int8_conv_depthwise")
LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)
K_STEP = 32

_IN_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_LIB = None


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from yololite_tpu_torch.csrc.build import load
        lib = load("int8_conv")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.yl_int8_quantize.argtypes = [ptr, i32, i64, ptr, ptr, ptr, ptr]
        lib.yl_int8_conv_dense.argtypes = [ptr] * 6 + [i32] * 15 + [ptr]
        lib.yl_int8_conv_depthwise.argtypes = [ptr] * 6 + [i32] * 13 + [ptr]
        for fn in (lib.yl_int8_quantize, lib.yl_int8_conv_dense, lib.yl_int8_conv_depthwise):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_err(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _nhwc(x: torch.Tensor, what: str) -> None:
    if x.ndim != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: a channels_last [N,C,H,W] tensor is expected, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def _route(x: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {x.device}")


# --------------------------------------------------------------------------- #
def quantize_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (x_q int8 in x's layout, s_x fp32 [1])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax().reshape(1)
    s = amax / torch.full_like(amax, 127.0)         # a true division (a scalar is a reciprocal)
    q = torch.round(xf / s.clamp_min(1e-12)).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16/fp32 [N,C,H,W] channels_last -> (x_q int8 channels_last, s_x fp32 [1])."""
    if not _route(x, "int8_quantize"):
        return quantize_reference(x)
    _nhwc(x, "int8_quantize")
    if x.dtype not in _IN_TYPES:
        raise ValueError(f"int8_quantize: fp32 or bf16 input expected, got {x.dtype}")
    q = torch.empty_like(x, dtype=torch.int8, memory_format=torch.channels_last)
    s = torch.empty(1, dtype=torch.float32, device=x.device)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().yl_int8_quantize(x.data_ptr(), _IN_TYPES[x.dtype], x.numel(),
                                         scratch.data_ptr(), q.data_ptr(), s.data_ptr(),
                                         _stream(x))
    _check_err(err, "int8_quantize")
    LAUNCHES["int8_quantize"] += 1
    return q, s


# --------------------------------------------------------------------------- #
def pack_dense(w_q: torch.Tensor) -> torch.Tensor:
    """int8 [O, C, kh, kw] -> [O, Kp] (ky, kx, c)-major, zero-padded to 32."""
    o, c, kh, kw = w_q.shape
    k = kh * kw * c
    kp = -(-k // K_STEP) * K_STEP
    out = torch.zeros((o, kp), dtype=torch.int8, device=w_q.device)
    out[:, :k] = w_q.permute(0, 2, 3, 1).reshape(o, k)
    return out


def unpack_dense(w: torch.Tensor, cin: int, kh: int, kw: int) -> torch.Tensor:
    return w[:, :kh * kw * cin].reshape(-1, kh, kw, cin).permute(0, 3, 1, 2)


def pack_depthwise(w_q: torch.Tensor) -> torch.Tensor:
    """int8 [C, 1, kh, kw] -> [kh, kw, C]."""
    return w_q[:, 0].permute(1, 2, 0).contiguous()


def _out_size(h: int, w: int, kernel, stride, padding) -> Tuple[int, int]:
    return ((h + 2 * padding[0] - kernel[0]) // stride[0] + 1,
            (w + 2 * padding[1] - kernel[1]) // stride[1] + 1)


def _epilogue_reference(acc: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
                        bias: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    if out_dtype == torch.int32:
        return acc
    out = acc.to(torch.float32) * (s_x * s_w)[None, :, None, None]
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out.to(out_dtype)


def _conv_reference(x_q, w_oihw, s_x, s_w, bias, stride, padding, groups, out_dtype):
    acc = F.conv2d(x_q.to(torch.float64), w_oihw.to(torch.float64), None, stride, padding,
                   1, groups)
    acc = acc.to(torch.int32).contiguous(memory_format=torch.channels_last)
    return _epilogue_reference(acc, s_x, s_w, bias, out_dtype)


def conv_dense_reference(x_q, s_x, w_packed, s_w, bias, kernel, stride, padding,
                         out_dtype=torch.float32):
    """Plain version of `conv_dense` (same arguments)."""
    w = unpack_dense(w_packed, x_q.shape[1], *kernel)
    return _conv_reference(x_q, w, s_x, s_w, bias, stride, padding, 1, out_dtype)


def conv_depthwise_reference(x_q, s_x, w_packed, s_w, bias, stride, padding,
                             out_dtype=torch.float32):
    """Plain version of `conv_depthwise` (same arguments)."""
    w = w_packed.permute(2, 0, 1)[:, None]
    return _conv_reference(x_q, w, s_x, s_w, bias, stride, padding, x_q.shape[1], out_dtype)


def _check_conv(name, x_q, s_x, w, s_w, bias, out_dtype, cout):
    _nhwc(x_q, name)
    if x_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"{name}: int8 activations and weights expected, got "
                         f"{x_q.dtype} and {w.dtype}")
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"{name}: output type must be fp32, bf16 or int32, got {out_dtype}")
    for t, what, n in ((s_x, "s_x", 1), (s_w, "s_w", cout), (bias, "bias", cout)):
        if t is None and what == "bias":
            continue
        if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be {n} contiguous fp32 values, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (s_x, w, s_w, bias):
        if t is not None and t.device != x_q.device:
            raise ValueError(f"{name}: all operands must be on {x_q.device}")
    if not w.is_contiguous():
        raise ValueError(f"{name}: packed weights must be contiguous")


def conv_dense(x_q: torch.Tensor, s_x: torch.Tensor, w_packed: torch.Tensor,
               s_w: torch.Tensor, bias: Optional[torch.Tensor], kernel, stride, padding,
               out_dtype=torch.float32) -> torch.Tensor:
    """groups=1 int8 conv: x_q int8 [N,C,H,W] channels_last, s_x fp32 [1],
    w_packed int8 [O,Kp] (`pack_dense`), s_w fp32 [O], bias fp32 [O] or None
    -> [N,O,OH,OW] channels_last in `out_dtype`."""
    if not _route(x_q, "int8_conv_dense"):
        return conv_dense_reference(x_q, s_x, w_packed, s_w, bias, kernel, stride, padding,
                                    out_dtype)
    o, kp = w_packed.shape
    n, c, h, w = x_q.shape
    _check_conv("int8_conv_dense", x_q, s_x, w_packed, s_w, bias, out_dtype, o)
    if kp % K_STEP or kp < kernel[0] * kernel[1] * c:
        raise ValueError(f"int8_conv_dense: packed K {kp} does not hold "
                         f"{kernel[0]}x{kernel[1]}x{c} taps padded to {K_STEP}")
    oh, ow = _out_size(h, w, kernel, stride, padding)
    out = torch.empty((n, o, oh, ow), dtype=out_dtype, device=x_q.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_q.device):
        err = library().yl_int8_conv_dense(
            x_q.data_ptr(), w_packed.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), _OUT_TYPES[out_dtype],
            n, h, w, c, oh, ow, o, kernel[0], kernel[1], stride[0], stride[1],
            padding[0], padding[1], kp, _stream(x_q))
    _check_err(err, "int8_conv_dense")
    LAUNCHES["int8_conv_dense"] += 1
    return out


def conv_depthwise(x_q: torch.Tensor, s_x: torch.Tensor, w_packed: torch.Tensor,
                   s_w: torch.Tensor, bias: Optional[torch.Tensor], stride, padding,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Depthwise int8 conv: x_q int8 [N,C,H,W] channels_last, w_packed int8
    [kh,kw,C] (`pack_depthwise`) -> [N,C,OH,OW] channels_last."""
    if not _route(x_q, "int8_conv_depthwise"):
        return conv_depthwise_reference(x_q, s_x, w_packed, s_w, bias, stride, padding,
                                        out_dtype)
    kh, kw, cw = w_packed.shape
    n, c, h, w = x_q.shape
    _check_conv("int8_conv_depthwise", x_q, s_x, w_packed, s_w, bias, out_dtype, c)
    if cw != c:
        raise ValueError(f"int8_conv_depthwise: weights for {cw} channels, input has {c}")
    oh, ow = _out_size(h, w, (kh, kw), stride, padding)
    out = torch.empty((n, c, oh, ow), dtype=out_dtype, device=x_q.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x_q.device):
        err = library().yl_int8_conv_depthwise(
            x_q.data_ptr(), w_packed.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), _OUT_TYPES[out_dtype],
            n, h, w, c, oh, ow, kh, kw, stride[0], stride[1], padding[0], padding[1],
            _stream(x_q))
    _check_err(err, "int8_conv_depthwise")
    LAUNCHES["int8_conv_depthwise"] += 1
    return out
