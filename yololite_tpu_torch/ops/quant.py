"""Int8 inference (post-training dynamic quantization) and quantization-aware
training (port of `ops/quant.py`).

PTQ: `quantize_int8(model)` turns every `nn.Conv2d` of a model into an
`Int8Conv2d` in place (the class changes; parameters, buffers and
state_dict keys stay). Its int8 weights and per-output-channel scales are
computed once, from the fp32 weights, as JAX computes them from its fp32
params:

    s_w = max|w| over (cin/g, kh, kw) / 127,  w_q = clip(round(w / max(s_w, 1e-12)), -127, 127)

Each call decides from the input's shape whether to quantize (JAX's
`_should_quantize`: not when C <= 4, the image-input conv, nor on a
[B,C,1,1] tensor, the SE squeeze/excite convs; a deep level that is 1x1 at a
small image size is skipped too). A quantized call runs the activation
quantize and the dense or depthwise int8 conv of `ops/cuda_int8.py` (kernels
on the card, their plain versions on the CPU) and returns the model's dtype.
`nn.Linear` stays as it is: JAX's ConvNeXtV2 MLP is `nn.Dense`, which its
interceptor does not touch.

QAT: `fake_quant(model)` turns every `nn.Conv2d` into a `FakeQuantConv2d`,
which quantizes and dequantizes its input and weights (the same scales,
detached) with the straight-through estimator x + (q - x).detach(), and
convolves in fp32 with autocast off, as JAX's `_fake_quant_conv` computes
in f32 and casts to the module's dtype (bf16 under amp). It is plain
PyTorch, as JAX's is plain XLA. The scales come from the unfolded training
weights (the deploy fold changes them; JAX's caveat).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yololite_tpu_torch.ops import cuda_int8


def should_quantize(x: torch.Tensor) -> bool:
    """JAX's `_should_quantize` on an NCHW input."""
    if x.shape[1] <= 4:
        return False
    return not (x.ndim == 4 and x.shape[2] == 1 and x.shape[3] == 1)


def _div127(t: torch.Tensor) -> torch.Tensor:
    # a true fp32 division, as JAX's `/ 127.0` (PyTorch turns the division of
    # a CUDA tensor by a Python number into a multiply by its reciprocal)
    return t / torch.full_like(t, 127.0)


def quantize_weights(w: torch.Tensor):
    """fp32 [O, I, kh, kw] -> (w_q int8 [O, I, kh, kw], s_w fp32 [O])."""
    wf = w.detach().to(torch.float32)
    s_w = _div127(wf.abs().amax(dim=(1, 2, 3)))
    w_q = torch.round(wf / s_w.clamp_min(1e-12)[:, None, None, None]).clamp(-127, 127)
    return w_q.to(torch.int8), s_w


class Int8Conv2d(nn.Conv2d):
    """A conv whose quantized calls run int8 (`quantize_int8` makes them)."""

    def _prepare_int8(self) -> None:
        if self.dilation != (1, 1) or not isinstance(self.padding, tuple):
            raise ValueError(f"int8 conv: dilation {self.dilation} / padding "
                             f"{self.padding!r} not supported")
        cin, cout = self.in_channels, self.out_channels
        self.depthwise = self.groups == cin == cout and self.groups > 1
        if self.groups != 1 and not self.depthwise:
            raise ValueError(f"int8 conv: groups={self.groups} with cin={cin}, cout={cout} "
                             f"is neither dense nor depthwise")
        w_q, self.s_w = quantize_weights(self.weight)
        self.w_packed = (cuda_int8.pack_depthwise(w_q) if self.depthwise
                         else cuda_int8.pack_dense(w_q))
        # the dense kernel's fragment order, made once (not part of state_dict)
        self.w_mma = None if self.depthwise else cuda_int8.pack_dense_mma(self.w_packed)
        self.bias_f32 = None if self.bias is None else self.bias.detach().to(torch.float32)

    def _apply(self, fn, recurse=True):
        # the int8 weights, scales and fp32 bias follow the module's device
        # but keep their types when the model is cast to bf16
        super()._apply(fn, recurse)
        dev = self.weight.device
        self.w_packed, self.s_w = self.w_packed.to(dev), self.s_w.to(dev)
        if self.w_mma is not None:
            self.w_mma = self.w_mma.to(dev)
        if self.bias_f32 is not None:
            self.bias_f32 = self.bias_f32.to(dev)
        return self

    def forward(self, x):
        if not should_quantize(x):
            return super().forward(x)
        x_q, s_x = cuda_int8.quantize(x)
        if self.depthwise:
            return cuda_int8.conv_depthwise(x_q, s_x, self.w_packed, self.s_w, self.bias_f32,
                                            self.stride, self.padding, self.weight.dtype)
        return cuda_int8.conv_dense(x_q, s_x, self.w_packed, self.s_w, self.bias_f32,
                                    self.kernel_size, self.stride, self.padding,
                                    self.weight.dtype, w_mma=self.w_mma)


def quantize_int8(model: nn.Module) -> nn.Module:
    """Make every `nn.Conv2d` of `model` an `Int8Conv2d`, in place. Call it
    while the weights are fp32, before casting the model to bf16."""
    for mod in model.modules():
        if type(mod) is nn.Conv2d:
            mod.__class__ = Int8Conv2d
            mod._prepare_int8()
    return model


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward q, gradient identity on x."""
    return x + (q - x).detach()


class FakeQuantConv2d(nn.Conv2d):
    """QAT conv: fake-quantized input and weights (`fake_quant` makes them)."""

    def forward(self, x):
        if not should_quantize(x):
            return super().forward(x)
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
        with torch.autocast(dev, enabled=False):
            wf = self.weight.to(torch.float32)
            s_w = _div127(wf.abs().amax(dim=(1, 2, 3))).detach().clamp_min(1e-12)
            s_w = s_w[:, None, None, None]
            w_fq = _ste(wf, torch.round(wf / s_w).clamp(-127, 127) * s_w)
            xf = x.to(torch.float32)
            s_x = _div127(xf.abs().amax().reshape(1)).detach().clamp_min(1e-12)
            x_fq = _ste(xf, torch.round(xf / s_x).clamp(-127, 127) * s_x)
            out = F.conv2d(x_fq, w_fq, None, self.stride, self.padding, self.dilation,
                           self.groups)
            if self.bias is not None:
                out = out + self.bias.to(torch.float32)[None, :, None, None]
        return out.to(dtype)


def fake_quant(model: nn.Module) -> nn.Module:
    """Make every `nn.Conv2d` of `model` a `FakeQuantConv2d`, in place (the
    parameters, and so the optimizer's and EMA's view of them, stay)."""
    for mod in model.modules():
        if type(mod) is nn.Conv2d:
            mod.__class__ = FakeQuantConv2d
    return model
