"""Building blocks of the edge detectors (PyTorch, NCHW, eval-mode BatchNorm).

Port of `yololite_tpu/models/layers.py`: the YOLOLiteMS neck/head blocks
(ConvBNAct, ConvBlock, DWConvBlock, the nearest upsample) and every block of
the backbone zoo (UIB, MBConv with SqueezeExcite, FusedMBConv, BasicBlock,
ConvNeXtV2Block with GRN, CSPBottleneck/CS3Stage, Focus, HGBlock).

Submodules carry the names flax gives their counterparts (`Conv_0`,
`BatchNorm_0`, `ConvBNAct_2`, ...), so a flax parameter path maps onto a torch
`state_dict` key by a plain rename (see `yololite_tpu_torch/convert.py`).

Under a spatial forward (`parallel/spatial.py`, the image height split over
ranks) the layers that read rows they do not own fetch them: every conv
(through the spatial context), Focus, the nearest upsample; BatchNorm's
statistics, SqueezeExcite's mean and GRN's norm are taken over the whole
image. Outside one they compute what they always did.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yololite_tpu_torch.parallel import dist as pdist
from yololite_tpu_torch.parallel import spatial as pspatial

ACTS = {
    "silu": F.silu,
    "relu": F.relu,
    "relu6": F.relu6,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "hardswish": F.hardswish,
    None: lambda x: x,
    "none": lambda x: x,
}


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return int(new_v)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` holding scale/bias/
    mean/var as weight/bias/running_mean/running_var.

    In eval mode it normalizes with the running statistics. In train mode
    (`module.train()`) it normalizes with the batch mean and the *biased*
    batch variance (what `F.batch_norm(training=True)` does), and updates
    `running = 0.9 * running + 0.1 * batch` with the biased variance too, as
    flax does. `F.batch_norm` would fold the *unbiased* variance into
    `running_var`, so it gets no running buffers here; the statistics for
    the update are taken apart, in fp32 also under bf16 autocast.

    Inside a data-parallel forward (`parallel.active`, world size > 1) the
    batch statistics are the global batch's, as flax's are under the JAX
    mesh (`_GlobalNorm`): the per-channel sum and sum of squares (shifted by
    the running mean, which every process holds alike, against
    cancellation) are all-reduced in fp32 (fp64 for an fp64 model), and the
    backward all-reduces those sums' gradients; the count is the global one
    (every data index holds as many images; under a spatial forward the
    global height is the plan's, whatever this rank's rows). In a spatial
    forward without a data-parallel context the sums span the spatial axis.
    The output is computed from them in that precision and cast to the
    input's dtype."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        h = pspatial.height("bn", x)
        if pspatial.recording():        # the plan's meta pass: shapes only
            return x
        dp, sp = pdist.current(), pspatial.sharding()
        if dp is not None:
            return self._global_forward(x, dp.n_data, pdist.all_reduce_, h)
        if sp is not None:
            return self._global_forward(x, 1, lambda t: pspatial.spatial_sum_(t, sp), h)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                            eps=self.eps)

    def _global_forward(self, x, n_data: int, reduce=pdist.all_reduce_,
                        height: Optional[int] = None):
        """Statistics of `n_data` times this rank's images at the global
        `height` (x's own by default), their sums summed in place by
        `reduce`."""
        count = x.shape[0] * n_data * (x.shape[2] if height is None else height) * x.shape[3]
        y, mean, var = _GlobalNorm.apply(x, self.weight, self.bias,
                                         self.running_mean.detach().clone(), count, reduce,
                                         self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y


class _GlobalNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * weight + bias with the mean and
    (biased) variance of `count` values, from the sums of x - shift and of
    its square that `reduce` completes over processes; also returns (mean,
    var). It computes what autograd through those formulas computes, bit
    for bit, but saves x and a few vectors, not autograd's fp32 copies of
    x: the backward recomputes them and reduces the gradients of the two
    sums the same way. The weight and bias gradients are this rank's share
    (summed with the other gradients)."""

    @staticmethod
    def forward(ctx, x, weight, bias, shift, count: int, reduce, eps: float):
        dt = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        xf = x.to(dt)
        d = xf - shift.view(1, c, 1, 1)
        sums = reduce(torch.cat([d.sum(dim=(0, 2, 3)), (d * d).sum(dim=(0, 2, 3))]))
        d_mean = sums[:c] / count
        mean = shift + d_mean
        raw = sums[c:] / count - d_mean * d_mean
        var = torch.clamp_min(raw, 0.0)
        r = torch.rsqrt(var + eps)
        scale = r * weight.to(dt)
        y = (xf - mean.view(1, c, 1, 1)) * scale.view(1, c, 1, 1) + bias.to(dt).view(1, c, 1, 1)
        ctx.save_for_backward(x, weight, shift, d_mean, mean, raw, r)
        ctx.count, ctx.reduce = count, reduce
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, shift, d_mean, mean, raw, r = ctx.saved_tensors
        dt, c, count = mean.dtype, x.shape[1], ctx.count
        v = lambda t: t.view(1, c, 1, 1)
        xf, g = x.to(dt), gy.to(dt)
        # autograd's order: the output's affine, rsqrt, clamp, the two sums
        grad_b = g.sum(dim=(0, 2, 3), keepdim=True).view(c)
        g_z = g * v(r * weight.to(dt))
        g_scale = (g * (xf - v(mean))).sum(dim=(0, 2, 3), keepdim=True).view(c)
        g_mean = (-g_z).sum(dim=(0, 2, 3), keepdim=True).view(c)
        grad_w = g_scale * r
        g_var = -0.5 * (g_scale * weight.to(dt)) * r.pow(3)
        g_var = torch.where(raw >= 0, g_var, torch.zeros((), dtype=dt, device=g_var.device))
        m = -g_var * d_mean
        tot = ctx.reduce(torch.cat([(m + m + g_mean) / count, g_var / count]))
        t = v(tot[c:]) * (xf - v(shift))
        gx = g_z + (t + t + v(tot[:c]).expand_as(t))
        return (gx.to(x.dtype), grad_w.to(weight.dtype), grad_b.to(weight.dtype),
                None, None, None, None)


def conv2d(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
           bias: bool = True) -> nn.Conv2d:
    """flax `nn.Conv` with symmetric padding kernel//2, as the JAX blocks pad
    for every kernel, even ones included: ConvNeXtV2's k4 s4 stem and k2 s2
    downsamples therefore give 161/81/41/21 maps at 640, not 160/80/40/20."""
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                     groups=groups, bias=bias)


class ConvBNAct(nn.Module):
    """Conv2D (no bias) -> BatchNorm -> activation."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: Optional[str] = "silu"):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, kernel, stride, groups, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.act = ACTS[act]

    def forward(self, x):
        return self.act(self.BatchNorm_0(self.Conv_0(x)))


class ConvBlock(nn.Module):
    """n x (Conv3x3-BN-act): the FPN smooth block of the non-CPU variant."""

    def __init__(self, cin: int, features: int, n: int = 1, act: str = "silu"):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"ConvBNAct_{i}",
                            ConvBNAct(cin if i == 0 else features, features, 3, 1,
                                      act=act))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"ConvBNAct_{i}")(x)
        return x


class DWConvBlock(nn.Module):
    """n x (DWConv3x3 -> Conv1x1 -> BN -> ReLU); BN only after the pointwise."""

    def __init__(self, cin: int, features: int, n: int = 1):
        super().__init__()
        self.n = n
        c = cin
        for i in range(n):
            self.add_module(f"Conv_{2 * i}", conv2d(c, c, 3, groups=c, bias=False))
            self.add_module(f"Conv_{2 * i + 1}", conv2d(c, features, 1, bias=False))
            self.add_module(f"BatchNorm_{i}", BatchNorm(features))
            c = features

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Conv_{2 * i}")(x)
            x = getattr(self, f"Conv_{2 * i + 1}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x))
        return x


class UIB(nn.Module):
    """Universal Inverted Bottleneck (MobileNetV4): optional start-DW ->
    1x1 expand -> optional mid-DW -> 1x1 project. Inner ConvBNAct_<i> count
    only the convs that exist, as flax's auto-names do."""

    def __init__(self, cin: int, features: int, expand: float = 4.0,
                 dw_start: int = 0, dw_mid: int = 3, stride: int = 1,
                 act: str = "relu"):
        super().__init__()
        stride_on_mid = dw_mid > 0
        mid = make_divisible(cin * expand)
        convs = []
        if dw_start > 0:
            convs.append(ConvBNAct(cin, cin, dw_start, 1 if stride_on_mid else stride,
                                   groups=cin, act=None))
        convs.append(ConvBNAct(cin, mid, 1, 1, act=act))
        if dw_mid > 0:
            convs.append(ConvBNAct(mid, mid, dw_mid, stride, groups=mid, act=act))
        convs.append(ConvBNAct(mid, features, 1, 1, act=None))
        self.n = len(convs)
        for i, m in enumerate(convs):
            self.add_module(f"ConvBNAct_{i}", m)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = x
        for i in range(self.n):
            h = getattr(self, f"ConvBNAct_{i}")(h)
        return h + x if self.residual else h


class SqueezeExcite(nn.Module):
    """Global mean -> biased 1x1 -> act -> biased 1x1 -> sigmoid gate (the JAX
    block's gate, not timm's hard sigmoid). Under a spatial forward the mean
    is the whole image's (a sum over the axis, in at least fp32) and the
    gate, whole on every rank, scales this rank's rows."""

    def __init__(self, channels: int, se_features: int, act: str = "silu"):
        super().__init__()
        self.Conv_0 = conv2d(channels, se_features, 1)
        self.Conv_1 = conv2d(se_features, channels, 1)
        self.act = ACTS[act]

    def forward(self, x):
        h = pspatial.height("se", x)
        sp = pspatial.sharding()
        if sp is None:
            s = x.mean((2, 3), keepdim=True)
        else:
            dt = torch.promote_types(x.dtype, torch.float32)
            s = pspatial.spatial_sum(x.to(dt).sum((2, 3), keepdim=True), sp)
            s = (s / (h * x.shape[3])).to(x.dtype)
        with pspatial.replicated():
            gate = torch.sigmoid(self.Conv_1(self.act(self.Conv_0(s))))
        return x * gate


class MBConv(nn.Module):
    """Inverted residual (MobileNetV2/EfficientNet): [1x1 expand] -> DW ->
    [SE] -> 1x1 project. No expand conv when expand == 1, so the depthwise
    conv is then `ConvBNAct_0`. se_ratio=0 disables SE (Lite); SE width comes
    from the block input."""

    def __init__(self, cin: int, features: int, expand: float = 6.0,
                 kernel: int = 3, stride: int = 1, se_ratio: float = 0.0,
                 act: str = "relu6"):
        super().__init__()
        mid = make_divisible(cin * expand)
        expands = expand != 1.0
        convs = [ConvBNAct(cin, mid, 1, 1, act=act)] if expands else []
        convs += [ConvBNAct(mid if expands else cin, mid, kernel, stride, groups=mid,
                            act=act),
                  ConvBNAct(mid, features, 1, 1, act=None)]
        self.n = len(convs)
        for i, m in enumerate(convs):
            self.add_module(f"ConvBNAct_{i}", m)
        self.se = se_ratio > 0
        if self.se:
            self.SqueezeExcite_0 = SqueezeExcite(mid, max(1, int(cin * se_ratio)), act)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = x
        for i in range(self.n):
            if self.se and i == self.n - 1:
                h = self.SqueezeExcite_0(h)
            h = getattr(self, f"ConvBNAct_{i}")(h)
        return h + x if self.residual else h


class FusedMBConv(nn.Module):
    """Fused inverted residual (EfficientNetV2): kxk expand conv + 1x1
    project, or one kxk conv when expand == 1."""

    def __init__(self, cin: int, features: int, expand: float = 4.0,
                 kernel: int = 3, stride: int = 1, act: str = "silu"):
        super().__init__()
        mid = make_divisible(cin * expand)
        self.expands = expand != 1.0
        if self.expands:
            self.ConvBNAct_0 = ConvBNAct(cin, mid, kernel, stride, act=act)
            self.ConvBNAct_1 = ConvBNAct(mid, features, 1, 1, act=None)
        else:
            self.ConvBNAct_0 = ConvBNAct(cin, features, kernel, stride, act=act)
        self.residual = stride == 1 and cin == features

    def forward(self, x):
        h = self.ConvBNAct_0(x)
        if self.expands:
            h = self.ConvBNAct_1(h)
        return h + x if self.residual else h


class BasicBlock(nn.Module):
    """ResNet-18/34 basic block; the 1x1 shortcut (`ConvBNAct_2`) exists only
    when the shape changes. ReLU after the add."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, features, 3, stride, act="relu")
        self.ConvBNAct_1 = ConvBNAct(features, features, 3, 1, act=None)
        self.shortcut = stride != 1 or cin != features
        if self.shortcut:
            self.ConvBNAct_2 = ConvBNAct(cin, features, 1, stride, act=None)

    def forward(self, x):
        h = self.ConvBNAct_1(self.ConvBNAct_0(x))
        return F.relu(h + (self.ConvBNAct_2(x) if self.shortcut else x))


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXtV2) on an NHWC tensor: L2 norm
    over H, W in (at least) fp32, divided by its mean over channels; under a
    spatial forward the sum of squares spans the axis."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x if x.dtype == torch.float64 else x.float()
        ss = xf.square().sum((1, 2), keepdim=True)
        sp = pspatial.sharding()
        if sp is not None:
            ss = pspatial.spatial_sum(ss, sp)
        gx = (ss + 1e-12).sqrt()
        nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
        return (self.gamma * (x * nx.to(x.dtype)) + self.beta + xf).to(x.dtype)


class ConvNeXtV2Block(nn.Module):
    """DW7x7 (biased) -> LayerNorm -> Linear 4x -> GELU (tanh) -> GRN ->
    Linear, residual. LayerNorm, the Linears and GRN run on the NHWC view,
    which is free on channels_last memory."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, 7, groups=features)
        self.LayerNorm_0 = nn.LayerNorm(features, eps=1e-6)
        self.Dense_0 = nn.Linear(features, 4 * features)
        self.GRN_0 = GRN(4 * features)
        self.Dense_1 = nn.Linear(4 * features, features)

    def forward(self, x):
        h = self.Conv_0(x).permute(0, 2, 3, 1)
        h = ACTS["gelu"](self.Dense_0(self.LayerNorm_0(h)))
        h = self.Dense_1(self.GRN_0(h))
        return x + h.permute(0, 3, 1, 2)


class CSPBottleneck(nn.Module):
    """Darknet bottleneck: 1x1 -> 3x3 (SiLU), residual when shapes allow."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(cin, features, 1, 1, act="silu")
        self.ConvBNAct_1 = ConvBNAct(features, features, 3, 1, act="silu")
        self.residual = cin == features

    def forward(self, x):
        h = self.ConvBNAct_1(self.ConvBNAct_0(x))
        return h + x if self.residual else h


class CS3Stage(nn.Module):
    """Cross-stage-partial stage: two 1x1 halves a, b; n bottlenecks on b;
    concat [a, b]; 1x1 merge (`ConvBNAct_2`)."""

    def __init__(self, cin: int, features: int, n: int = 1):
        super().__init__()
        c = features // 2
        self.n = n
        self.ConvBNAct_0 = ConvBNAct(cin, c, 1, 1, act="silu")
        self.ConvBNAct_1 = ConvBNAct(cin, c, 1, 1, act="silu")
        for i in range(n):
            self.add_module(f"CSPBottleneck_{i}", CSPBottleneck(c, c))
        self.ConvBNAct_2 = ConvBNAct(2 * c, features, 1, 1, act="silu")

    def forward(self, x):
        a, b = self.ConvBNAct_0(x), self.ConvBNAct_1(x)
        for i in range(self.n):
            b = getattr(self, f"CSPBottleneck_{i}")(b)
        return self.ConvBNAct_2(torch.cat([a, b], 1))


class Focus(nn.Module):
    """Space-to-depth 2x2 (JAX's channel order, H indexed first) + conv; under
    a spatial forward on the rows of this rank's output rows, so the row
    phase is the global row's parity."""

    def __init__(self, cin: int, features: int, kernel: int = 3):
        super().__init__()
        self.ConvBNAct_0 = ConvBNAct(4 * cin, features, kernel, 1, act="silu")

    def forward(self, x):
        x = pspatial.pair_rows(x)
        x = torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2],
                       x[:, :, ::2, 1::2], x[:, :, 1::2, 1::2]], 1)
        return self.ConvBNAct_0(x)


class HGBlock(nn.Module):
    """HGNetV2 block: `layers` chained 3x3 convs, concat of the input and
    every tap, 1x1 to features/2, 1x1 to features (all ReLU)."""

    def __init__(self, cin: int, mid: int, features: int, layers: int = 6,
                 kernel: int = 3, residual: bool = False):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"ConvBNAct_{i}", ConvBNAct(cin if i == 0 else mid, mid,
                                                        kernel, 1, act="relu"))
        self.add_module(f"ConvBNAct_{layers}",
                        ConvBNAct(cin + layers * mid, features // 2, 1, 1, act="relu"))
        self.add_module(f"ConvBNAct_{layers + 1}",
                        ConvBNAct(features // 2, features, 1, 1, act="relu"))
        self.residual = residual and cin == features

    def forward(self, x):
        taps = [x]
        for i in range(self.layers):
            taps.append(getattr(self, f"ConvBNAct_{i}")(taps[-1]))
        out = getattr(self, f"ConvBNAct_{self.layers}")(torch.cat(taps, 1))
        out = getattr(self, f"ConvBNAct_{self.layers + 1}")(out)
        return out + x if self.residual else out


def upsample_nearest_to(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest upsample of an NCHW map to (H, W).

    The JAX version repeats for exact x2 and otherwise calls
    `jax.image.resize(..., "nearest")`, which samples at pixel centres: that
    is torch's `nearest-exact`, not its legacy `nearest`. At exact x2
    `nearest-exact` is the repeat, so one call covers both cases. Under a
    spatial forward the target height is the plan's global one."""
    if pspatial.current() is not None:
        return pspatial.upsample_nearest(x, target_hw)
    return F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")
