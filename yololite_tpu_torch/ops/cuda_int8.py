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
zero-padded to a multiple of 32, depthwise as [kh, kw, C]. The dense kernel
reads its weights in mma fragment order (`pack_dense_mma`), made once from
the [O, Kp] pack and held beside it (`Int8Conv2d.w_mma`); a caller that
passes none gets one made for the call.

`plan_dense` and `plan_depthwise` are plain functions of the shapes: they
pick each call's kernel variant, tile, grid, threads and shared memory, and
raise on a call no variant takes. The launchers in `int8_conv.cu` check the
plan's shared memory against their own count.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

SOURCE = "yololite_tpu_torch/csrc/int8_conv.cu"
KERNEL_NAMES = ("int8_quantize", "int8_conv_dense", "int8_conv_depthwise")
# the CUDA symbols of each kernel (profiler rows name the kernel by these)
KERNEL_SYMBOLS = {"int8_quantize": ("absmax_kernel", "quantize_kernel"),
                  "int8_conv_dense": ("int8_dense_mma_kernel",),
                  "int8_conv_depthwise": ("int8_depthwise_tile_kernel",)}
LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)
K_STEP = 32

# H100 launch limits (sm_90)
MAX_THREADS = 1024
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65_535
MAX_SMEM = 232_448     # a block's shared memory (the launchers opt in above 48 KB)
# dense: 128 rows a block (4 warps x 32), K resident when 128 rows of it fit
# in DENSE_RESIDENT bytes, else 128-byte K chunks through a 3-stage ring
DENSE_ROWS, DENSE_THREADS = 128, 128
DENSE_RESIDENT = 96 * 1024
DENSE_KCHUNK, DENSE_STAGES = 128, 3
# fewer blocks than DENSE_MIN_BLOCKS split O's column steps over grid.y
# when K is at most DENSE_SPLIT_K, or whatever K when there are fewer blocks
# than SMs (each block then copies its rows again, from L2): small-M calls
# fill the card
DENSE_MIN_BLOCKS, DENSE_SPLIT_K, SMS = 1024, 256, 132
# how the rows reach shared memory (`DenseMode` in int8_conv.cu): a 1x1
# call's rows as they lie; a KxK call on C % 16 == 0 as a (128/tw) x tw output
# tile's input patch when it fits in DENSE_HALO bytes; else an im2col gather
DENSE_MODES = ("rows", "gather", "halo")
DENSE_HALO = 64 * 1024
# a block whose column steps cover all of O stages each warp's 32 whole
# output rows (when 4 warps' rows fit in DENSE_FULL_ROWS bytes) and stores
# them as one contiguous run, instead of a strip a column step
DENSE_FULL_ROWS = 32 * 1024
# depthwise: 20-column tiles (4 pixel groups x 5 outputs) of one 16-channel
# group, 16 threads an output row; the KxK kernels unrolled for these
DW_TILE_W, DW_GROUP, DW_MAX_THREADS = 20, 16, 320
DW_ROWS = (20, 16, 10, 8)
DW_UNROLLED = {(3, 1), (3, 2), (5, 1), (5, 2), (7, 1)}

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
        lib.yl_int8_conv_dense.argtypes = [ptr] * 6 + [i32] * 26 + [ptr]
        lib.yl_int8_conv_depthwise.argtypes = [ptr] * 6 + [i32] * 18 + [ptr]
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


def pack_dense_mma(w_packed: torch.Tensor) -> torch.Tensor:
    """[O, Kp] (`pack_dense`) -> the dense kernel's fragment order: for each
    n8 tile of outputs (O padded with zero rows to a multiple of 32), each
    k32 step and each lane (g, t) of a warp, the 8 bytes w[8*tile + g,
    32*step + 8t : 32*step + 8t + 8]; [O32 / 8, Kp / 32, 32, 8] int8."""
    o, kp = w_packed.shape
    o32 = -(-o // 32) * 32
    w = torch.zeros((o32, kp), dtype=torch.int8, device=w_packed.device)
    w[:o] = w_packed
    return (w.view(o32 // 8, 8, kp // 32, 4, 8).permute(0, 2, 1, 3, 4)
            .reshape(o32 // 8, kp // 32, 32, 8).contiguous())


def unpack_dense(w: torch.Tensor, cin: int, kh: int, kw: int) -> torch.Tensor:
    return w[:, :kh * kw * cin].reshape(-1, kh, kw, cin).permute(0, 3, 1, 2)


def pack_depthwise(w_q: torch.Tensor) -> torch.Tensor:
    """int8 [C, 1, kh, kw] -> [kh, kw, C]."""
    return w_q[:, 0].permute(1, 2, 0).contiguous()


def _out_size(h: int, w: int, kernel, stride, padding) -> Tuple[int, int]:
    return ((h + 2 * padding[0] - kernel[0]) // stride[0] + 1,
            (w + 2 * padding[1] - kernel[1]) // stride[1] + 1)


# --------------------------------------------------------------------------- #
class Plan(NamedTuple):
    """One conv call's launch: `variant` names the kernel instance, `args`
    the plan's values the C launcher takes after the shapes."""
    variant: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    args: Tuple[int, ...]


def _out_bytes(out_dtype) -> int:
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"output type must be fp32, bf16 or int32, got {out_dtype}")
    return 2 if out_dtype == torch.bfloat16 else 4


def _pitch32(k_bytes: int) -> int:
    """A shared row pitch of 32 mod 64 bytes: the 16 lanes of a phase read 8
    bytes each from 4 rows x 4 offsets without a bank conflict."""
    return k_bytes if k_bytes % 64 == 32 else k_bytes + 32


def _checked(plan: Plan, what: str) -> Plan:
    gx, gy, gz = plan.grid
    if (not 1 <= gx <= MAX_GRID_X or not 1 <= gy <= MAX_GRID_YZ
            or not 1 <= gz <= MAX_GRID_YZ or not 1 <= plan.threads <= MAX_THREADS
            or plan.smem > MAX_SMEM):
        raise ValueError(f"{what}: no launch plan fits the card's limits: {plan}")
    return plan


def plan_dense(n: int, c: int, h: int, w: int, o: int, kernel, stride, padding,
               out_dtype) -> Plan:
    """The dense kernel's launch for one call (shapes only), one block a
    tile of 128 rows and `ncb` column steps. args: (mode, nt, ncb, lda, kch,
    kchunks, tw, full, vin, vout, smem)."""
    kh, kw = kernel
    oh, ow = _out_size(h, w, kernel, stride, padding)
    m = n * oh * ow
    kp = -(-kh * kw * c // K_STEP) * K_STEP
    osz = _out_bytes(out_dtype)
    vin = 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1
    nt = 1 if o <= 8 else 2 if o <= 16 else 4
    blocks, tw = max(1, -(-m // DENSE_ROWS)), 0
    if (kh, kw) == (1, 1) and tuple(stride) == (1, 1) and tuple(padding) == (0, 0) \
            and vin > 1:
        mode = 0
    else:
        mode = 1
        if vin == 16:
            tw = 16 if ow > 8 else 8
            th = DENSE_ROWS // tw
            hr, hc = (th - 1) * stride[0] + kh, (tw - 1) * stride[1] + kw
            if hr * hc * c <= DENSE_HALO:
                mode = 2
                blocks = n * -(-ow // tw) * -(-oh // th)
    if mode == 2 or DENSE_ROWS * _pitch32(kp) <= DENSE_RESIDENT:
        kch, kchunks, stages = kp, 1, 1
    else:
        kch, kchunks, stages = DENSE_KCHUNK, -(-kp // DENSE_KCHUNK), DENSE_STAGES
    lda = _pitch32(kch)
    steps = -(-o // (8 * nt))
    split = 1 if blocks >= DENSE_MIN_BLOCKS or (kp > DENSE_SPLIT_K and blocks >= SMS) \
        else min(steps, -(-DENSE_MIN_BLOCKS // blocks))
    ncb = -(-steps // split)
    full = int(mode != 2 and kchunks == 1 and ncb == steps and (o * osz) % 16 == 0
               and 4 * 32 * o * osz <= DENSE_FULL_ROWS)
    staging = 4 * 32 * (o * osz if full else 8 * nt * osz + (16 if osz == 2 else 32))
    if mode == 2:
        a_bytes = -(-hr * hc * c // 16) * 16
        rest = staging + DENSE_ROWS * 16 + -(-kp // 8 * 4 // 16) * 16
    else:
        a_bytes = stages * DENSE_ROWS * lda
        rest = staging + (DENSE_ROWS * 16 if mode == 1 else 0)
    smem = a_bytes + rest
    vout = math.gcd(o * osz, 16)
    variant = f"int8_dense_mma_kernel<{DENSE_MODES[mode]}, nt={nt}>"
    plan = Plan(variant, (blocks, -(-steps // ncb), 1), DENSE_THREADS, smem,
                (mode, nt, ncb, lda, kch, kchunks, tw, full, vin, vout, smem))
    return _checked(plan, f"int8_conv_dense {(n, c, h, w)} -> {o} {tuple(kernel)}")


def plan_depthwise(n: int, c: int, h: int, w: int, kernel, stride, padding,
                   out_dtype) -> Plan:
    """The depthwise kernel's launch for one call (shapes only): the tile
    height with the fewest rows past the output (the tallest among equals)
    whose halo fits. One block a tile: grid.x counts them (spatial tile
    fastest, then 16-channel group, then image). args: (variant, th, pitch,
    vin, smem)."""
    kh, kw = kernel
    sh, sw = stride
    oh, ow = _out_size(h, w, kernel, stride, padding)
    _out_bytes(out_dtype)
    unrolled = kh == kw and sh == sw and (kh, sh) in DW_UNROLLED
    hc = (DW_TILE_W - 1) * sw + kw
    # two output rows share a warp: S = 1 keeps them 4 slots apart mod 8
    pitch = hc + (4 - hc) % 8 if unrolled and sh == 1 else hc
    vin = 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1
    tiles_x = -(-ow // DW_TILE_W)
    for th in sorted(DW_ROWS, key=lambda t: (-(-oh // t) * t - oh, -t)):
        hr = (th - 1) * sh + kh
        smem = kh * kw * DW_GROUP * 4 + hr * pitch * DW_GROUP
        if smem <= MAX_SMEM and 16 * th <= DW_MAX_THREADS:
            break
    else:
        raise ValueError(f"int8_conv_depthwise: no tile of {DW_ROWS} rows fits "
                         f"{kh}x{kw} s{sh}x{sw} in {MAX_SMEM} B of shared memory")
    variant = 10 * kh + sh if unrolled else 0
    name = (f"int8_depthwise_tile_kernel<{kh}, {sh}>" if unrolled
            else "int8_depthwise_tile_kernel<any>")
    plan = Plan(name, (tiles_x * -(-oh // th) * -(-c // DW_GROUP) * n, 1, 1), 16 * th, smem,
                (variant, th, pitch, vin, smem))
    return _checked(plan, f"int8_conv_depthwise {(n, c, h, w)} {tuple(kernel)}")


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
               out_dtype=torch.float32, w_mma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """groups=1 int8 conv: x_q int8 [N,C,H,W] channels_last, s_x fp32 [1],
    w_packed int8 [O,Kp] (`pack_dense`), s_w fp32 [O], bias fp32 [O] or None
    -> [N,O,OH,OW] channels_last in `out_dtype`. `w_mma` is
    `pack_dense_mma(w_packed)`, made here when not given."""
    if not _route(x_q, "int8_conv_dense"):
        return conv_dense_reference(x_q, s_x, w_packed, s_w, bias, kernel, stride, padding,
                                    out_dtype)
    o, kp = w_packed.shape
    n, c, h, w = x_q.shape
    _check_conv("int8_conv_dense", x_q, s_x, w_packed, s_w, bias, out_dtype, o)
    if kp % K_STEP or kp < kernel[0] * kernel[1] * c:
        raise ValueError(f"int8_conv_dense: packed K {kp} does not hold "
                         f"{kernel[0]}x{kernel[1]}x{c} taps padded to {K_STEP}")
    if w_mma is None:
        w_mma = pack_dense_mma(w_packed)
    want = (-(-o // 32) * 4, kp // K_STEP, 32, 8)
    if (tuple(w_mma.shape) != want or w_mma.dtype != torch.int8 or not w_mma.is_contiguous()
            or w_mma.device != x_q.device):
        raise ValueError(f"int8_conv_dense: w_mma must be pack_dense_mma(w_packed), "
                         f"int8 {want} on {x_q.device}")
    oh, ow = _out_size(h, w, kernel, stride, padding)
    out = torch.empty((n, o, oh, ow), dtype=out_dtype, device=x_q.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    plan = plan_dense(n, c, h, w, o, kernel, stride, padding, out_dtype)
    with torch.cuda.device(x_q.device):
        err = library().yl_int8_conv_dense(
            x_q.data_ptr(), w_mma.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), _OUT_TYPES[out_dtype],
            n, h, w, c, oh, ow, o, kernel[0], kernel[1], stride[0], stride[1],
            padding[0], padding[1], kp, *plan.args, _stream(x_q))
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
    plan = plan_depthwise(n, c, h, w, (kh, kw), stride, padding, out_dtype)
    with torch.cuda.device(x_q.device):
        err = library().yl_int8_conv_depthwise(
            x_q.data_ptr(), w_packed.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), _OUT_TYPES[out_dtype],
            n, h, w, c, oh, ow, kh, kw, stride[0], stride[1], padding[0], padding[1],
            *plan.args, _stream(x_q))
    _check_err(err, "int8_conv_depthwise")
    LAUNCHES["int8_conv_depthwise"] += 1
    return out
