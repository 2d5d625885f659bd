"""The int8 conv kernels' launch plans (`ops/cuda_int8.plan_dense`,
`plan_depthwise`) at every distinct quantized conv call of every config, and
the dense kernel's weight fragment order, on the CPU.

The kernels run only on the card (`tests/test_torch_port_cuda.py`,
`chip_smoke.py`), but what they are launched with is a plain function of the
shapes. The calls are collected on the `meta` device with a pre-forward hook
on the plain `nn.Conv2d`s and `quant.should_quantize`, of the model the int8
Predictor builds (heads fused): edge_n and edge_n_seg at 640 with N = 128 (the serving
batch), every other config at 640 with N = 2. Each plan must fit the H100's
launch limits (grid.x < 2^31, grid.y/z <= 65,535, <= 1,024 threads, <=
232,448 B of shared memory, which above 48 KB the launcher opts in to), for
each output type, and no call may fall outside the planned variants.
"""

import glob
import os

import numpy as np
import pytest
import torch

from yololite_tpu_torch.config import read_yaml
from yololite_tpu_torch.config.config import MODEL_DIRS
from yololite_tpu_torch.deploy.fuse_head import fuse_head_params
from yololite_tpu_torch.models.detector import YOLOLiteMS, build_model_from_config
from yololite_tpu_torch.ops import cuda_int8, quant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING = ("configs/models/edge_n.yaml", "configs/models/edge_n_seg.yaml")
OUT_TYPES = (torch.bfloat16, torch.float32, torch.int32)


def _configs():
    out = []
    for sub in MODEL_DIRS:
        for path in sorted(glob.glob(os.path.join(ROOT, "configs", sub, "*.yaml"))):
            if "model" in read_yaml(path):
                out.append(os.path.relpath(path, ROOT))
    return out


CONFIGS = _configs()


def quantized_calls(rel: str, n: int, img: int = 640):
    """Distinct (input shape, cout, kernel, stride, padding, groups, bias) of
    the quantized conv calls of one forward, on the meta device."""
    cfg = read_yaml(os.path.join(ROOT, rel))
    cfg["model"]["num_classes"] = 3
    with torch.device("meta"):      # the Predictor's model: heads fused, as it loads them
        model = build_model_from_config(cfg)
        _, fused = fuse_head_params(model.state_dict())
        model = YOLOLiteMS(**dict(model.config, fused_head=fused
                                  or model.config["fused_head"])).eval()
    calls = set()

    def hook(mod, args):
        x = args[0]
        if quant.should_quantize(x):
            calls.add((tuple(x.shape), mod.out_channels, mod.kernel_size, mod.stride,
                       mod.padding, mod.groups, mod.bias is not None))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if type(m) is torch.nn.Conv2d]
    x = torch.empty(n, 3, img, img, device="meta").contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return sorted(calls)


def _assert_fits(plan):
    gx, gy, gz = plan.grid
    assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= 65_535 and 1 <= gz <= 65_535, plan
    assert 1 <= plan.threads <= 1024, plan
    assert plan.smem <= 232_448, plan
    assert plan.smem == plan.args[-1], plan        # the launcher checks this value


def test_configs_found():
    assert len(CONFIGS) == 17
    assert set(SERVING) <= set(CONFIGS)


@pytest.mark.parametrize("rel", CONFIGS)
def test_every_quantized_call_has_a_plan(rel):
    n = 128 if rel in SERVING else 2
    calls = quantized_calls(rel, n)
    assert calls, rel
    kinds = set()
    for shape, cout, kernel, stride, padding, groups, _ in calls:
        _, c, h, w = shape
        assert shape[0] == n
        for dtype in OUT_TYPES:
            if groups == 1:
                plan = cuda_int8.plan_dense(n, c, h, w, cout, kernel, stride, padding, dtype)
                mode, nt, ncb, lda, kch, kchunks, tw, full, vin, vout, smem = plan.args
                # a 1x1 call copies its rows as they lie; a KxK call on C % 16 == 0
                # copies its input patch (edge_n's always fit); K = kh*kw*c fits
                assert (mode == 0) == (kernel == (1, 1) and c % 4 == 0), (shape, kernel)
                if rel == SERVING[0] and kernel != (1, 1):
                    assert mode == 2 and tw == 16, (shape, kernel, plan)
                assert kch * kchunks >= kernel[0] * kernel[1] * c and lda % 64 == 32
                assert nt * 8 >= min(cout, 32) and (cout * dtype.itemsize) % vout == 0
                assert c % vin == 0 and plan.grid[1] * ncb * nt * 8 >= cout
                # whole output rows staged only where one block covers all of O
                assert not full or (plan.grid[1] == 1 and mode != 2
                                    and cout * dtype.itemsize % 16 == 0)
                if rel == SERVING[0]:    # edge_n's widths keep all of K resident
                    assert kchunks == 1, (shape, kernel, plan)
            else:
                assert groups == c == cout, (shape, cout, groups)
                plan = cuda_int8.plan_depthwise(n, c, h, w, kernel, stride, padding, dtype)
                variant, th, pitch, vin, smem = plan.args
                # every config's depthwise shape has its unrolled kernel
                assert variant == 10 * kernel[0] + stride[0], (shape, kernel, stride)
                assert plan.threads == 16 * th and c % vin == 0
                tiles = -(-plan.grid[0] // (n * -(-c // 16)))
                assert plan.grid[0] == tiles * -(-c // 16) * n, plan
            _assert_fits(plan)
            kinds.add(plan.variant)
    assert kinds


def test_serving_calls_cover_the_kernels_edges():
    """edge_n b128 has the shapes the redesign is about: 1x1 at O = 8 and
    O = 288/480, 3x3 s2 im2col calls, and 3x3/5x5 depthwise at s1 and s2."""
    calls = quantized_calls("configs/models/edge_n.yaml", 128)
    dense = [(s[1], o, k, st) for s, o, k, st, p, g, b in calls if g == 1]
    dw = {(k, st) for s, o, k, st, p, g, b in calls if g > 1}
    assert {8, 288, 480} <= {o for c, o, k, st in dense if k == (1, 1)}
    assert any(k == (3, 3) and st == (2, 2) for c, o, k, st in dense)
    assert {((3, 3), (1, 1)), ((5, 5), (1, 1)), ((5, 5), (2, 2)), ((3, 3), (2, 2))} <= dw
    assert len(calls) == 36        # as chip_smoke's check_int8_model counts them


def test_plans_raise_on_what_no_variant_takes():
    with pytest.raises(ValueError, match="no tile"):
        cuda_int8.plan_depthwise(1, 16, 400, 400, (99, 99), (2, 2), (49, 49), torch.float32)
    with pytest.raises(ValueError, match="limits"):       # more tiles than grid.x takes
        cuda_int8.plan_depthwise(2 ** 22, 1632, 80, 80, (3, 3), (1, 1), (1, 1), torch.float32)
    with pytest.raises(ValueError, match="limits"):
        cuda_int8.plan_dense(2 ** 26, 16, 160, 160, 16, (1, 1), (1, 1), (0, 0), torch.float32)
    with pytest.raises(ValueError, match="output type"):
        cuda_int8.plan_dense(1, 16, 8, 8, 8, (1, 1), (1, 1), (0, 0), torch.float16)


def test_uncommon_shapes_take_the_general_variants():
    # a 1x1 call on a channel count that is not a multiple of 4 gathers bytes
    plan = cuda_int8.plan_dense(2, 5, 16, 16, 70, (1, 1), (1, 1), (0, 0), torch.bfloat16)
    assert plan.args[0] == 1 and plan.args[8] == 1 and plan.args[9] == 4    # vin 1, vout 4
    # K beyond the resident budget streams in 128-byte chunks
    plan = cuda_int8.plan_dense(2, 512, 20, 20, 512, (3, 3), (1, 1), (1, 1), torch.bfloat16)
    assert plan.args[0] == 1 and plan.args[4:6] == (128, 36) and plan.smem > 48 * 1024
    # few row blocks (M = 800): O's 16 column steps of 32 spread over grid.y
    assert plan.grid == (7, 16, 1) and plan.args[2] == 1
    _assert_fits(plan)
    # depthwise 7x7 s2 and a non-square kernel take the general loop
    for kernel, stride in (((7, 7), (2, 2)), ((3, 5), (1, 1)), ((1, 1), (1, 1))):
        plan = cuda_int8.plan_depthwise(2, 40, 21, 19, kernel, stride, (1, 1), torch.float32)
        assert plan.args[0] == 0
        _assert_fits(plan)


def _mma_m16n8k32(a_frag, b_frag):
    """mma.sync.m16n8k32 s8 on fragments as the PTX ISA lays them out:
    lane (g, t) = (lane >> 2, lane & 3) gives A rows g and g+8 at k 4t..4t+3
    (a0, a1) and 16+4t..19+4t (a2, a3), and B column g at the same k (b0,
    b1). Returns the 16 x 8 int32 product."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a[g, 4 * t:4 * t + 4] = a_frag[lane][0]
        a[g + 8, 4 * t:4 * t + 4] = a_frag[lane][1]
        a[g, 16 + 4 * t:20 + 4 * t] = a_frag[lane][2]
        a[g + 8, 16 + 4 * t:20 + 4 * t] = a_frag[lane][3]
        b[4 * t:4 * t + 4, g] = b_frag[lane][0]
        b[16 + 4 * t:20 + 4 * t, g] = b_frag[lane][1]
    return a @ b


@pytest.mark.parametrize("o,c", [(8, 32), (16, 96), (96, 96), (70, 5), (288, 48)])
def test_fragment_order_reproduces_the_product(o, c):
    """The dense kernel's A loads (8 bytes at row g and g+8, offset 8t of a
    k32 step) and `pack_dense_mma`'s B fragments follow one permutation of k,
    so the mma computes x_q @ w^T exactly."""
    rng = np.random.RandomState(o * 1000 + c)
    w_q = torch.from_numpy(rng.randint(-127, 128, (o, c, 1, 1)).astype(np.int8))
    packed = cuda_int8.pack_dense(w_q)
    frag = cuda_int8.pack_dense_mma(packed).numpy()
    kp = packed.shape[1]
    assert frag.shape == (-(-o // 32) * 4, kp // 32, 32, 8)
    a = rng.randint(-127, 128, (16, kp)).astype(np.int64)   # bytes past K: any, times 0
    got = np.zeros((16, frag.shape[0] * 8), np.int64)
    for nt in range(frag.shape[0]):
        for kt in range(kp // 32):
            blk = a[:, 32 * kt:32 * kt + 32]
            a_frag = [(blk[g, 8 * t:8 * t + 4], blk[g + 8, 8 * t:8 * t + 4],
                       blk[g, 8 * t + 4:8 * t + 8], blk[g + 8, 8 * t + 4:8 * t + 8])
                      for g, t in ((lane >> 2, lane & 3) for lane in range(32))]
            b_frag = [(frag[nt, kt, lane, :4], frag[nt, kt, lane, 4:]) for lane in range(32)]
            got[:, 8 * nt:8 * nt + 8] += _mma_m16n8k32(a_frag, b_frag)
    want = a[:, :c] @ w_q[:, :, 0, 0].numpy().astype(np.int64).T
    assert np.array_equal(got[:, :o], want)
    assert not got[:, o:].any()
