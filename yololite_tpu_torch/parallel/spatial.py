"""Spatial parallelism over processes: the `spatial` axis of
`parallel/mesh.py` (image height sharded over ranks, halo exchanges around
every conv).

JAX shards the image height over a mesh axis "spatial" and lets GSPMD
partition every convolution, insert the halo exchanges and gather a map
again wherever an operation needs all of it. Here the `n` ranks of one data
index (`Spatial`) each hold one contiguous range of rows of every feature
map, and every layer that reads rows it does not own fetches them:

  - the row split (`split`): a map of global height H is cut as GSPMD cuts a
    sharded dim, into chunks of ceil(H / n) rows; the last ranges may be
    short or empty (a 2-row P5 over 4 ranks is 1, 1, 0, 0);
  - the plan: a rank cannot tell a map's global height from its own rows
    (161 rows over 2 ranks leave rank 1 with 80, as 160 do), so the first
    sharded forward of a module at an input shape runs it once on the meta
    device at the full shape and records, in call order, the global height
    at every operation that needs it (`_plan`); the sharded forward takes
    them in the same order and checks each against its local rows;
  - convs (every `F.conv2d` of the forward, caught by a TorchFunctionMode,
    so plain and fake-quant convs alike): the rank's output rows
    [o_a, o_b) of the global output read the global input rows
    [o_a s - p, (o_b - 1) s - p + k); `_Halo` assembles exactly those from
    their owners (zeros outside [0, H), and only there) and the conv runs on
    them with no row padding. Forward, one all_gather of the rows each rank
    holds for others (padded to one length); backward, one all_gather of the
    received rows' gradients, summed into their owners' rows. A 1x1
    stride-1 conv needs no other rows and exchanges nothing;
  - `upsample_nearest` and `pair_rows` (Focus) fetch the source rows of
    their output rows the same way;
  - `gather`: a row-sharded map whole on every rank of the axis (the loss,
    decode); its backward keeps the rank's own rows of the gradient without
    summing, since every rank of the axis computes the same loss from the
    same gathered values;
  - `spatial_sum`: a differentiable sum over the axis (global pools;
    BatchNorm's statistics span data x spatial through `parallel/dist.py`).

A rank with no rows of a map still takes part in every collective, forward
and backward: its empty outputs stay connected to their inputs.
`forward(module, x, sp)` runs a module on this rank's rows of `x`; outside
it the layers compute what they always did.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import weakref
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from yololite_tpu_torch.parallel import dist as pdist

Rows = Tuple[int, int]

_CTX: Optional["_Context"] = None
# module -> {(training, input shape): _Plan}
_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class Spatial:
    """This rank's place on the spatial axis: `n` ranks in `group` (None:
    the default group), this one the `index`-th."""

    n: int
    index: int
    group: Any = None

    @classmethod
    def of(cls, dp: Optional[pdist.DataParallel]) -> Optional["Spatial"]:
        """The spatial axis of `dp`'s mesh (its groups made on first call),
        or None without one."""
        if dp is None or dp.n_spatial == 1:
            return None
        return cls(dp.n_spatial, dp.spatial_index, pdist.mesh_groups(dp)[0])


def split(h: int, n: int) -> List[Rows]:
    """Each rank's rows [a, b) of a map `h` rows high: chunks of ceil(h/n)."""
    c = -(-h // n)
    return [(min(i * c, h), min((i + 1) * c, h)) for i in range(n)]


def _meet(x: Rows, y: Rows) -> Rows:
    a, b = max(x[0], y[0]), min(x[1], y[1])
    return (a, b) if b > a else (a, a)


def _len(r: Rows) -> int:
    return r[1] - r[0]


# --------------------------------------------------------------------------- #
# The row exchange
# --------------------------------------------------------------------------- #

class _Exchange:
    """Which rows go where when each rank r needs the global rows `need[r]`
    of a map `h` rows high split over `n` ranks. `pairs[q][r]` are the rows
    rank q owns that rank r (!= q) needs; q sends them in r order, r returns
    their gradients in q order."""

    def __init__(self, h: int, n: int, need: Tuple[Rows, ...]):
        self.h, self.n, self.need = h, n, need
        self.own = split(h, n)
        self.pairs = [[_meet(need[r], self.own[q]) if r != q else (0, 0)
                       for r in range(n)] for q in range(n)]
        self.m_fwd = max(sum(_len(p) for p in self.pairs[q]) for q in range(n))
        self.m_bwd = max(sum(_len(self.pairs[q][r]) for q in range(n)) for r in range(n))
        # row offset of the piece for r in q's buffer, and of q's in r's return
        self.off_fwd = [[sum(_len(self.pairs[q][t]) for t in range(r)) for r in range(n)]
                        for q in range(n)]
        self.off_bwd = [[sum(_len(self.pairs[t][r]) for t in range(q)) for r in range(n)]
                        for q in range(n)]

    @property
    def is_local(self) -> bool:
        """Every rank needs exactly its own rows (or nothing)."""
        return all(_len(nd) == 0 and _len(ow) == 0 or nd == ow
                   for nd, ow in zip(self.need, self.own))

    def forward(self, x: torch.Tensor, s: int, group) -> torch.Tensor:
        oa = self.own[s][0]
        bufs = None
        if self.m_fwd:
            pieces = [x.narrow(2, a - oa, b - a) for a, b in self.pairs[s] if b > a]
            bufs = pdist.all_gather(_pad_rows(pieces, self.m_fwd, x), group, "halo")
        wa, wb = self.need[s]
        segs = []
        if wa < min(wb, 0):
            segs.append(_zero_rows(x, min(wb, 0) - wa))
        for q in range(self.n):
            a, b = _meet((wa, wb), self.own[q])
            if b <= a:
                continue
            segs.append(x.narrow(2, a - oa, b - a) if q == s
                        else bufs[q].narrow(2, self.off_fwd[q][s], b - a))
        if wb > max(wa, self.h):
            segs.append(_zero_rows(x, wb - max(wa, self.h)))
        return torch.cat(segs, 2) if segs else x.narrow(2, 0, 0)

    def backward(self, g: torch.Tensor, s: int, group, x_shape) -> torch.Tensor:
        (oa, _), (wa, wb) = self.own[s], self.need[s]
        gx = g.new_zeros(x_shape)
        a, b = _meet((wa, wb), self.own[s])
        if b > a:
            gx.narrow(2, a - oa, b - a).add_(g.narrow(2, a - wa, b - a))
        if self.m_bwd:
            pieces = [g.narrow(2, a - wa, b - a) for a, b in
                      (self.pairs[q][s] for q in range(self.n)) if b > a]
            bufs = pdist.all_gather(_pad_rows(pieces, self.m_bwd, g), group, "halo")
            for r in range(self.n):
                a, b = self.pairs[s][r]
                if b > a:
                    gx.narrow(2, a - oa, b - a).add_(
                        bufs[r].narrow(2, self.off_bwd[s][r], b - a))
        return gx


@functools.lru_cache(maxsize=4096)
def _exchange(h: int, n: int, need: Tuple[Rows, ...]) -> _Exchange:
    return _Exchange(h, n, need)


def _zero_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.new_zeros(x.shape[0], x.shape[1], rows, *x.shape[3:])


def _pad_rows(pieces: Sequence[torch.Tensor], m: int, like: torch.Tensor) -> torch.Tensor:
    """The pieces one after another along dim 2, zero rows up to `m`."""
    have = sum(p.shape[2] for p in pieces)
    if have < m:
        pieces = list(pieces) + [_zero_rows(like, m - have)]
    return torch.cat(pieces, 2).contiguous()


class _Halo(torch.autograd.Function):
    """Rows `ex.need[s]` of the global map from this rank's rows `x`."""

    @staticmethod
    def forward(ctx, x, ex: _Exchange, sp: Spatial):
        ctx.ex, ctx.sp, ctx.x_shape = ex, sp, x.shape
        return ex.forward(x, sp.index, sp.group)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.backward(g, ctx.sp.index, ctx.sp.group, ctx.x_shape), None, None


def fetch(x: torch.Tensor, h: int, need: Sequence[Rows], sp: Spatial) -> torch.Tensor:
    """The global rows `need[sp.index]` of a map `h` rows high held as this
    rank's rows `x` (dim 2), every rank r asking for `need[r]`; zeros outside
    [0, h). Differentiable; every rank of the axis calls it together."""
    ex = _exchange(h, sp.n, tuple(need))
    if ex.is_local:
        return x
    return _Halo.apply(x, ex, sp)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h: int, dim: int, sp: Spatial):
        own = split(h, sp.n)
        ctx.rows, ctx.dim = own[sp.index], dim
        m = max(_len(r) for r in own)
        xt = x.movedim(dim, 2)
        bufs = pdist.all_gather(_pad_rows([xt], m, xt), sp.group, "gather")
        return torch.cat([b.narrow(2, 0, _len(r)) for b, r in zip(bufs, own)],
                         2).movedim(2, dim)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        return g.narrow(ctx.dim, a, b - a).contiguous(), None, None, None


def gather(x: torch.Tensor, h: int, dim: int, sp: Spatial) -> torch.Tensor:
    """The whole map (`h` rows along `dim`) from every rank's rows, on every
    rank of the axis; the backward keeps this rank's rows of the gradient."""
    return x if sp.n == 1 else _Gather.apply(x, h, dim, sp)


def spatial_sum(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """Differentiable sum over the axis's ranks."""
    return x if sp.n == 1 else pdist.all_reduce_sum(x, sp.group)


def spatial_sum_(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """Sum over the axis's ranks, in place (no gradient)."""
    return x if sp.n == 1 else pdist.all_reduce_(x, sp.group)


def spatial_max(x: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """Elementwise max over the axis's ranks (no gradient)."""
    return x if sp.n == 1 else pdist.all_reduce_max(x, sp.group)


# --------------------------------------------------------------------------- #
# The plan and the context the layers read
# --------------------------------------------------------------------------- #

class _Context:
    """One forward's spatial state: recording the plan (`sp` None) or
    sharding over `sp`, taking the plan's events in order."""

    def __init__(self, sp: Optional[Spatial], events: Optional[list] = None):
        self.sp = sp
        self.events = [] if events is None else events
        self.pos = 0
        self.replicated = 0

    def event(self, kind: str, x: torch.Tensor, *extra) -> tuple:
        """(global height of x's dim 2, *extra) at this operation: recorded
        with `extra` while planning, taken from the plan while sharding."""
        if self.sp is None:
            ev = (kind, x.shape[2]) + tuple(extra)
            self.events.append(ev)
            return ev[1:]
        if self.pos >= len(self.events) or self.events[self.pos][0] != kind:
            want = self.events[self.pos][0] if self.pos < len(self.events) else "none"
            raise RuntimeError(f"spatial plan: operation {self.pos} is {want}, not {kind}")
        ev = self.events[self.pos]
        a, b = split(ev[1], self.sp.n)[self.sp.index]
        if x.shape[2] != b - a:
            raise RuntimeError(f"spatial plan: {kind} {self.pos} holds {x.shape[2]} rows, "
                               f"its share of {ev[1]} is {b - a}")
        self.pos += 1
        return ev[1:]


def current() -> Optional[_Context]:
    """The spatial context of the running forward, None outside one or
    inside `replicated()`."""
    return None if _CTX is None or _CTX.replicated else _CTX


def sharding() -> Optional[Spatial]:
    """The axis this forward's maps are sharded over, or None (no context,
    the planning pass, or a replicated part)."""
    ctx = current()
    return None if ctx is None else ctx.sp


def recording() -> bool:
    """Is this the planning pass (meta tensors at the full shape)?"""
    ctx = current()
    return ctx is not None and ctx.sp is None


def height(kind: str, x: torch.Tensor) -> int:
    """The global height of `x` (dim 2) at a layer that needs it (an event
    of the plan); x's own height outside a spatial forward."""
    ctx = current()
    return x.shape[2] if ctx is None else ctx.event(kind, x)[0]


def conv_input_height(x: torch.Tensor) -> int:
    """The global height of the input of the conv about to run (its plan
    event, not taken)."""
    ctx = current()
    if ctx is None or ctx.sp is None:
        return x.shape[2]
    kind, h = ctx.events[ctx.pos][:2]
    if kind != "conv":
        raise RuntimeError(f"spatial plan: operation {ctx.pos} is {kind}, not conv")
    return h


@contextlib.contextmanager
def replicated() -> Iterator[None]:
    """Inside, tensors are whole on every rank (a global pool's output):
    layers compute as without a spatial context and record nothing."""
    ctx = _CTX
    if ctx is None:
        yield
        return
    ctx.replicated += 1
    try:
        yield
    finally:
        ctx.replicated -= 1


@contextlib.contextmanager
def _use(ctx: _Context) -> Iterator[None]:
    global _CTX
    prev, _CTX = _CTX, ctx
    try:
        yield
    finally:
        _CTX = prev


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _conv_args(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return x, weight, bias, _pair(stride), _pair(padding), _pair(dilation), groups


def _conv(ctx: _Context, func, args, kwargs):
    x, weight, bias, stride, padding, dilation, groups = _conv_args(*args, **kwargs)
    (h,) = ctx.event("conv", x)
    sp = ctx.sp
    if sp is None:
        return func(*args, **kwargs)
    s, p = stride[0], padding[0]
    span = dilation[0] * (weight.shape[2] - 1) + 1
    out_rows = split((h + 2 * p - span) // s + 1, sp.n)
    need = [(a * s - p, (b - 1) * s - p + span) if b > a else (0, 0) for a, b in out_rows]
    window = fetch(x, h, need, sp)
    row_pad = (0, padding[1])
    if _len(out_rows[sp.index]) == 0:
        # no output rows here: a stub conv whose empty result stays connected
        # to the window, so this rank runs the exchange's backward too
        stub = _zero_rows(window, span) + window.sum() * 0
        return func(stub, weight, bias, stride, row_pad, dilation, groups)[:, :, :0]
    return func(window, weight, bias, stride, row_pad, dilation, groups)


class _ConvMode(TorchFunctionMode):
    """Routes the forward's convs through the context (plan or halo)."""

    def __init__(self, ctx: _Context):
        super().__init__()
        self.ctx = ctx

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d and not self.ctx.replicated:
            return _conv(self.ctx, func, args, kwargs)
        return func(*args, **kwargs)


@dataclasses.dataclass
class _Plan:
    events: list
    out: Any                # the outputs at the full shape (meta tensors)


def _plan(module: torch.nn.Module, x: torch.Tensor) -> _Plan:
    """The module's spatial events at x's full shape, from one meta-device
    forward (made once a module, mode and input shape)."""
    key = (module.training, tuple(x.shape))
    plans = _PLANS.setdefault(module, {})
    if key not in plans:
        meta = {k: torch.empty_like(v, device="meta") for k, v in itertools.chain(
            module.named_parameters(remove_duplicate=False),
            module.named_buffers(remove_duplicate=False))}
        ctx = _Context(None)
        with torch.no_grad(), pdist.active(None), _use(ctx), _ConvMode(ctx):
            out = torch.func.functional_call(
                module, meta, (torch.empty(x.shape, dtype=x.dtype, device="meta"),))
        plans[key] = _Plan(ctx.events, out)
    return plans[key]


def forward(module: torch.nn.Module, x: torch.Tensor, sp: Spatial):
    """`module` on this rank's rows of the whole input `x` (NCHW, every rank
    of the axis holding the same `x`): (this rank's outputs, the outputs at
    the full shape as meta tensors, for their global sizes)."""
    plan = _plan(module, x)
    a, b = split(x.shape[2], sp.n)[sp.index]
    ctx = _Context(sp, plan.events)
    with _use(ctx), _ConvMode(ctx):
        out = module(x[:, :, a:b])
    if ctx.pos != len(ctx.events):
        raise RuntimeError(f"spatial plan: {len(ctx.events) - ctx.pos} operations not run")
    return out, plan.out


# --------------------------------------------------------------------------- #
# Layers that read other rows
# --------------------------------------------------------------------------- #

@functools.lru_cache(maxsize=256)
def nearest_index(src: int, dst: int) -> torch.Tensor:
    """Source index of each of `dst` positions of torch's `nearest-exact`
    resize from `src` (computed by the resize itself, on the host)."""
    with torch.inference_mode(False):
        grid = torch.arange(src, dtype=torch.float32).view(1, 1, src, 1)
        return F.interpolate(grid, size=(dst, 1), mode="nearest-exact").view(dst).long()


def upsample_nearest(x: torch.Tensor, target_hw: Sequence[int]) -> torch.Tensor:
    """`nearest-exact` resize of this rank's rows of a map to its rows of the
    target (the target's global height is the plan's, not the caller's)."""
    ctx = current()
    h, ht = ctx.event("up", x, int(target_hw[0]))
    if ctx.sp is None:
        return F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")
    sp = ctx.sp
    rows = nearest_index(h, ht)
    need = [(int(rows[a]), int(rows[b - 1]) + 1) if b > a else (0, 0)
            for a, b in split(ht, sp.n)]
    window = fetch(x, h, need, sp)
    a, b = split(ht, sp.n)[sp.index]
    idx = (rows[a:b] - need[sp.index][0]).to(x.device)
    cols = nearest_index(x.shape[3], int(target_hw[1])).to(x.device)
    return window.index_select(2, idx).index_select(3, cols)


def pair_rows(x: torch.Tensor) -> torch.Tensor:
    """The global rows [2 o_a, 2 o_b) that this rank's output rows [o_a, o_b)
    of a 2x space-to-depth read (its first row even, as the global row
    parity requires); x itself outside a sharded forward."""
    ctx = current()
    if ctx is None:
        return x
    (h,) = ctx.event("focus", x)
    if ctx.sp is None:
        return x
    sp = ctx.sp
    need = [(2 * a, 2 * b) for a, b in split(h // 2, sp.n)]
    return fetch(x, h, need, sp)
