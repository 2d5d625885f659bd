"""The CUDA suppression kernel against its plain PyTorch version, on the card
(and the device photometric augmentation, card vs CPU).

Marked `cuda`; skips without a card. This file imports no JAX, so it runs on
the card's machine, which has none (tests/conftest.py imports JAX, hence
`--noconftest`):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Keep masks are discrete, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from yololite_tpu_torch.ops import cuda_nms
from yololite_tpu_torch.ops.nms import batched_nms, select_candidates


def _boxes(rng, b, k):
    cx, cy = rng.rand(2, b, k) * 500
    w, h = rng.rand(2, b, k) * 85 + 5
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _check(boxes, valid, thr=0.5):
    boxes, valid = boxes.cuda().contiguous(), valid.cuda().contiguous()
    before = cuda_nms.LAUNCHES
    got = cuda_nms.greedy_keep(boxes, valid, thr)
    torch.cuda.synchronize()
    assert cuda_nms.LAUNCHES == before + 1
    want = cuda_nms.greedy_keep_reference(boxes, valid, thr)
    assert torch.equal(got, want), f"{int((got != want).sum())} keep bits differ"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 63, 64, 65, 511, 512, 1024, 1025, 2048])
def test_kernel_matches_reference(card, k, b):
    rng = np.random.RandomState(k * 10 + b)
    _check(torch.from_numpy(_boxes(rng, b, k)), torch.from_numpy(rng.rand(b, k) > 0.1))


@pytest.mark.cuda
def test_kernel_matches_reference_at_all_anchors(card):
    """k = 8,400: every anchor of a 640 image, as JAX's batched_nms takes."""
    rng = np.random.RandomState(8400)
    boxes = _boxes(rng, 2, 8400)
    boxes += (rng.randint(0, 3, (2, 8400)) * 8192.0)[..., None].astype(np.float32)
    _check(torch.from_numpy(boxes), torch.from_numpy(rng.rand(2, 8400) > 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [512, 8683])
def test_kernel_at_convnext_anchor_count(card, k):
    """N = 8,683 candidates: the anchors of ConvNeXtV2-tiny (v2 yololite_l)
    at 640, whose 161/81/41/21 maps give levels 81² + 41² + 21². k = 512 is
    the Predictor's pre-NMS top-k over them (batched_nms card vs CPU must
    then be bit-exact), k = N takes every one."""
    n, b = 8683, 2
    rng = np.random.RandomState(k)
    boxes = torch.from_numpy(_boxes(rng, b, n) * 640 / 500)
    scores = torch.from_numpy(rng.rand(b, n).astype(np.float32))
    classes = torch.from_numpy(rng.randint(0, 3, (b, n)).astype(np.int32))
    *_, valid, shifted = select_candidates(boxes.cuda(), scores.cuda(), classes.cuda(),
                                           conf_th=0.05, k=k, class_aware=True)
    _check(shifted, valid, 0.45)
    if k < n:
        kw = dict(iou_th=0.45, conf_th=0.05, max_det=300, pre_nms_topk=k)
        got = batched_nms(boxes.cuda(), scores.cuda(), classes.cuda(), **kw)
        want = batched_nms(boxes, scores, classes, **kw)
        for name, g, w in zip(("boxes", "scores", "classes", "valid", "idx"), got, want):
            assert torch.equal(g.cpu(), w), f"batched_nms {name}: card != CPU"


@pytest.mark.cuda
def test_kernel_edge_cases(card):
    rng = np.random.RandomState(5)
    boxes = torch.from_numpy(_boxes(rng, 2, 100))
    valid = torch.ones(2, 100, dtype=torch.bool)
    valid[0] = False                                    # an all-invalid image
    valid[1, 40:] = False                               # an invalid tail
    keep = _check(boxes, valid)
    assert not keep[0].any() and not keep[1, 40:].any()
    same = torch.tensor([[10.0, 10.0, 60.0, 40.0]]).repeat(1, 70, 1)
    keep = _check(same, torch.ones(1, 70, dtype=torch.bool))
    assert keep[0].tolist() == [True] + [False] * 69    # only the first is kept
    n = 100                                             # crosses three word boundaries
    chain = torch.tensor([[i * 20.0, 0.0, i * 20.0 + 100.0, 50.0] for i in range(n)])[None]
    keep = _check(chain, torch.ones(1, n, dtype=torch.bool))
    assert keep[0].tolist() == [i % 2 == 0 for i in range(n)]


@pytest.mark.cuda
def test_iou_equal_to_threshold_does_not_suppress(card):
    """IoU(big, small) = 1 / ((2 + 1 - 1) + 1e-7) = 0.5 exactly in fp32 (the
    1e-7 is below half an ulp of 2), and 1 / 4 = 0.25 exactly likewise:
    `IoU > thr` is false, so both boxes stay."""
    for big, thr in (([0.0, 0.0, 2.0, 1.0], 0.5), ([0.0, 0.0, 2.0, 2.0], 0.25)):
        pair = torch.tensor([[big, [0.0, 0.0, 1.0, 1.0]]])
        keep = _check(pair, torch.ones(1, 2, dtype=torch.bool), thr)
        assert keep[0].tolist() == [True, True]
        keep = _check(pair, torch.ones(1, 2, dtype=torch.bool), float(np.nextafter(
            np.float32(thr), np.float32(0.0))))
        assert keep[0].tolist() == [True, False]


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    boxes = torch.zeros(2, 1025, 4, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        cuda_nms.greedy_keep(boxes[:, :8].half(), torch.ones(2, 8, dtype=torch.bool,
                                                              device="cuda"), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nms.greedy_keep(boxes.transpose(0, 1).contiguous().transpose(0, 1),
                             torch.ones(2, 1025, dtype=torch.bool, device="cuda"), 0.5)
    rng = np.random.RandomState(0)
    b = torch.from_numpy(_boxes(rng, 2, 64)).cuda()
    s = torch.rand(2, 64, device="cuda")
    c = torch.zeros(2, 64, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError):
        batched_nms(b, s, c, use_diou=True)


@pytest.mark.cuda
def test_train_step_fp32_card_matches_cpu(card):
    """One fp32 train step (TF32 off) of edge_n at 256 px from the same
    weights and batch: the SimOTA assignment equal, losses within 1e-3
    relative, gradients within 2e-2 in relative L2 norm (at 256 px this
    seeded net's train-mode backward is well-conditioned; chip_smoke.py's
    train phase holds the 640 px step against a CPU fp64 backward instead),
    updated parameters within 2.1 x lr_max (Adam's first step is
    lr * g / |g|, so an element whose gradient is at rounding level may step
    either way)."""
    from yololite_tpu_torch.convert import to_flax
    from yololite_tpu_torch.models.detector import build_model_from_config, init_weights
    from yololite_tpu_torch.train.steps import Trainer
    cfg = {"model": {"arch": "YOLOLiteMS_CPU", "backbone": "mobilenetv4_conv_small_050",
                     "depth_multiple": 0.65, "width_multiple": 0.60, "fpn_channels": 160,
                     "head_depth": 1, "num_classes": 3},
           "training": {"img_size": 256, "amp": False, "lr": 1e-3, "grad_clip": 1.0,
                        "bb_lr_mult": 0.25, "neck_lr_mult": 1.25, "head_lr_mult": 1.75},
           "loss": {"center_radius_cells": 3.5, "area_cells_min": 0.0, "area_tol": 1.75}}
    params, stats = to_flax(init_weights(build_model_from_config(cfg), 0))
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 200, (4, 6, 2))
    batch = {"image": rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8),
             "boxes": np.concatenate([xy, xy + rng.uniform(8, 56, (4, 6, 2))], -1
                                     ).astype(np.float32),
             "labels": rng.randint(0, 3, (4, 6)).astype(np.int32),
             "mask": rng.rand(4, 6) > 0.3}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            trainer = Trainer(build_model_from_config(cfg), cfg, device=dev)
            state = trainer.state_from_weights(params, stats)
            total, m = trainer.forward_loss(state, trainer.put_batch(batch),
                                            return_assignment=True)
            grads = trainer.backward(state, total)
            lr_vec = trainer.lr_vector(1e-3)
            trainer.apply(state, grads, lr_vec)
            out[dev] = ({k: v.detach().cpu() for k, v in m.items()}, float(total.detach()),
                        [g.cpu() for g in grads], [p.detach().cpu() for p in state.params])
    finally:
        torch.backends.cudnn.allow_tf32 = True
    (mg, tg, gg, pg), (mc, tc, gc, pc) = out["cuda"], out["cpu"]
    assert torch.equal(mg["pos_mask"], mc["pos_mask"]) and int(mc["pos_mask"].sum()) > 0
    pos = mc["pos_mask"]
    assert torch.equal(mg["matched_gt"][pos], mc["matched_gt"][pos])
    np.testing.assert_allclose(tg, tc, rtol=1e-3)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-3, err_msg=k)
    flat = lambda gs: torch.cat([x.reshape(-1).double() for x in gs])
    assert float((flat(gg) - flat(gc)).norm() / flat(gc).norm()) <= 2e-2
    assert max(float((a - c).abs().max()) for a, c in zip(pg, pc)) <= 2.1 * max(lr_vec)


@pytest.mark.cuda
def test_device_augment_card_matches_cpu(card):
    """The photometric step on equal draws: card vs CPU within 1 level (the
    fp32 colour product may round the other way at a half)."""
    from yololite_tpu_torch.data import device_augment as dev_aug
    images = torch.from_numpy((np.random.RandomState(0).rand(8, 64, 80, 3) * 255)
                              .astype(np.uint8))
    p = dev_aug.draw(images.shape, torch.Generator().manual_seed(1), 1.0, 1.0)
    want = dev_aug.apply(images, p)
    got = dev_aug.apply(images.cuda(), {k: v.cuda() for k, v in p.items()}).cpu()
    assert int((got.int() - want.int()).abs().max()) <= 1
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = dev_aug.photometric_augment(images.cuda(), gen)
    assert out.dtype == torch.uint8 and out.shape == images.shape and out.is_cuda


@pytest.mark.cuda
def test_registered_op_launches_the_kernel(card):
    """`torch.ops.yololite.nms_suppress` on CUDA tensors is the kernel (one
    launch counted), equal to the plain version; a failed check raises."""
    rng = np.random.RandomState(12)
    boxes = torch.from_numpy(_boxes(rng, 2, 300)).cuda()
    valid = torch.from_numpy(rng.rand(2, 300) > 0.1).cuda()
    before = cuda_nms.LAUNCHES
    keep = torch.ops.yololite.nms_suppress(boxes, valid, 0.5)
    torch.cuda.synchronize()
    assert cuda_nms.LAUNCHES == before + 1 and keep.is_cuda
    assert torch.equal(keep, cuda_nms.greedy_keep_reference(boxes, valid, 0.5))
    with pytest.raises(ValueError, match="float32"):
        torch.ops.yololite.nms_suppress(boxes.half(), valid, 0.5)


@pytest.mark.cuda
def test_cuda_nms_artifact_equals_the_predictor(card, tmp_path):
    """An fp32 "nms" `.pt2` exported on the card from a seeded edge_n at 128
    px (TF32 off) gives the Predictor's detections bit for bit, with one
    kernel launch a call."""
    from yololite_tpu_torch.deploy.export import export_model, load_exported
    from yololite_tpu_torch.deploy.predictor import Predictor
    from yololite_tpu_torch.models.detector import build_model_from_config, init_weights
    cfg = {"model": {"arch": "YOLOLiteMS_CPU", "backbone": "mobilenetv4_conv_small_050",
                     "depth_multiple": 0.65, "width_multiple": 0.60, "fpn_channels": 160,
                     "head_depth": 1, "num_classes": 3, "num_anchors_per_level": 1}}
    model = init_weights(build_model_from_config(cfg), 0).eval()
    weights = (model, model.state_dict(), {"img_size": 128, "names": ["a", "b", "c"]})
    x = torch.from_numpy((np.random.RandomState(3).rand(4, 128, 128, 3) * 255)
                         .astype(np.uint8)).cuda()
    torch.backends.cudnn.allow_tf32 = False
    try:
        pred = Predictor(weights, device="cuda", dtype=torch.float32)
        want = pred._run(128, 0.001, 0.65, 300, x)
        path = export_model(weights, out_dir=str(tmp_path), fmt="nms", batch=4, img_size=128,
                            dtype=torch.float32, device="cuda")
        call, meta = load_exported(path)
        before = cuda_nms.LAUNCHES
        got = call(x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    assert cuda_nms.LAUNCHES == before + 1 and meta["device"].startswith("cuda")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------- #
# int8 kernels (csrc/int8_conv.cu): equal to their plain versions bit for bit

def _int8_input(shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    return x.cuda().contiguous(memory_format=torch.channels_last)


def _quantize_case(case, dtype):
    """The input of one quantize case (channels_last on the card)."""
    if case == "misaligned_view":       # a batch slice 45 elements in: scalar loads
        x = _int8_input((3, 5, 3, 3), dtype)[1:]
        assert x.data_ptr() % 16 != 0
        return x
    if case == "max_last_negative":     # the largest |x| is the last element, negative
        x = _int8_input((2, 24, 9, 7), dtype)
        x.permute(0, 2, 3, 1).reshape(-1)[-1] = -1000.0
        return x
    if case == "zeros":                 # -0.0 where x < 0
        return _int8_input((2, 16, 8, 8), dtype) * 0
    shapes = {"odd_hw": (2, 16, 33, 17), "tiny": (1, 5, 3, 3), "wide": (4, 96, 40, 40),
              "n_not_multiple_of_8": (3, 7, 11, 13),
              "above_l2": (16, 16, 320, 320)}   # 52 MB in bf16, 105 MB in fp32
    return _int8_input(shapes[case], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["odd_hw", "tiny", "wide", "misaligned_view",
                                  "n_not_multiple_of_8", "max_last_negative", "zeros",
                                  "above_l2"])
def test_int8_quantize_matches_plain(card, case, dtype):
    """One cooperative launch a call, x_q and s_x equal to the plain version,
    on the vector route (16-byte aligned x, with an n % 8 tail) and the
    scalar one (a misaligned view)."""
    from yololite_tpu_torch.ops import cuda_int8
    x = _quantize_case(case, dtype)
    before = cuda_int8.LAUNCHES["int8_quantize"]
    q, s = cuda_int8.quantize(x)
    q0, s0 = cuda_int8.quantize_reference(x)
    torch.cuda.synchronize()
    assert cuda_int8.LAUNCHES["int8_quantize"] == before + 1
    assert torch.equal(q, q0) and torch.equal(s, s0)
    assert q.is_contiguous(memory_format=torch.channels_last)
    if case == "max_last_negative":
        assert s.item() == (torch.tensor([1000.0]) / torch.tensor([127.0])).item()
        assert q.permute(0, 2, 3, 1).reshape(-1)[-1].item() == -127
    if case == "zeros":
        assert s.item() == 0.0 and not q.any()


def _quantize_equal(x):
    from yololite_tpu_torch.ops import cuda_int8
    x = x.cuda().reshape(1, -1, 1, 1).contiguous(memory_format=torch.channels_last)
    q, s = cuda_int8.quantize(x)
    q0, s0 = cuda_int8.quantize_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(s, s0), (s.item(), s0.item())
    bad = (q != q0).reshape(-1).nonzero()[:5, 0]
    assert not len(bad), [(x.reshape(-1)[i].item(), q.reshape(-1)[i].item(),
                           q0.reshape(-1)[i].item()) for i in bad]


# largest |x| of each case: the scale at the 1e-12 clamp, at its edge, in
# the usual range, and at bf16's largest finite values
_QUANTIZE_MAXIMA = (1e-30, 1.27e-10, 1.3e-10, 0.5, 1.0, 3.0, 5.5, 127.0, 1000.0, 6.1e4,
                    1e20, -3.3e38)


@pytest.mark.cuda
@pytest.mark.parametrize("amax", _QUANTIZE_MAXIMA)
def test_int8_quantize_every_bf16_value(card, amax):
    """The kernel's division (a reciprocal computed once, two exact-remainder
    corrections) against the plain version's IEEE division: every finite
    bf16 value within |amax|, beside amax, in bf16 and in fp32."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16)
    m = torch.tensor([amax], dtype=torch.bfloat16)
    v = v[torch.isfinite(v) & (v.float().abs() <= m.float().abs())]
    x = torch.cat([v, m])
    for dtype in (torch.bfloat16, torch.float32):
        _quantize_equal(x.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("amax", _QUANTIZE_MAXIMA)
def test_int8_quantize_rounds_half_integers_as_the_plain_version(card, amax):
    """fp32 inputs whose quotient lies within a few ulps of every k + 0.5
    (the values where a quotient off by one ulp would round to another
    level), of every k, and at the clamp."""
    m = torch.tensor([amax], dtype=torch.float32)
    d = (m.abs() / torch.tensor([127.0])).clamp_min(1e-12)
    k = torch.arange(-128, 128, dtype=torch.float32)
    mid = torch.cat([(k + 0.5) * d, k * d, torch.tensor([127.5, -127.5]) * d])
    steps = [mid]
    up, down = mid.clone(), mid.clone()
    for _ in range(4):
        up = torch.nextafter(up, torch.tensor(float("inf")))
        down = torch.nextafter(down, torch.tensor(float("-inf")))
        steps += [up, down]
    x = torch.cat(steps)
    x = x[x.abs() <= m.abs()]
    _quantize_equal(torch.cat([x, m]))


# dense 1x1 at the widths of the fused heads (O = 8), the stem (16) and the
# wide expansions (96, 288, 480), with M = n*h*w not a multiple of the
# kernel's 128-row tile; a 1x1 on C % 16 != 0 (4-byte copies) and C odd (the
# byte gather); 3x3 on C % 16 == 0 through the input patch at s1 and s2 on
# odd H and W; a 3x3 whose K streams through the 3-stage ring (K > 736)
_DENSE_EDGES = [
    (1, 96, 7, 9, 8, 1, 1, 1, True), (3, 16, 13, 11, 16, 1, 1, 1, False),
    (2, 96, 17, 15, 96, 1, 1, 1, True), (1, 48, 19, 21, 288, 1, 1, 1, False),
    (2, 64, 9, 13, 480, 1, 1, 1, True), (2, 196, 9, 11, 96, 1, 1, 1, True),
    (1, 5, 10, 10, 24, 1, 1, 1, False), (2, 48, 19, 23, 40, 3, 1, 1, True),
    (1, 32, 17, 13, 16, 3, 2, 1, False), (2, 512, 10, 9, 64, 3, 1, 1, True)]
# depthwise at every channel width of the tail and group logic, 3x3, 5x5
# and 7x7 (7x7 s2 runs the general loop), s1 and s2, odd H and W, with and
# without bias
_DW_EDGES = [(2, c, 23, 17 + 2 * i, c, k, s, c, (i + k + s) % 2 == 0)
             for i, c in enumerate((16, 24, 32, 40, 96, 256)) for k in (3, 5, 7) for s in (1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,o,k,s,groups,bias", [
    (2, 16, 40, 40, 32, 3, 2, 1, False), (2, 32, 20, 20, 48, 1, 1, 1, True),
    (1, 12, 33, 31, 16, 3, 1, 1, False), (2, 5, 16, 16, 70, 3, 1, 1, True),
    (2, 64, 11, 11, 64, 4, 4, 1, False), (2, 48, 20, 20, 48, 3, 1, 48, False),
    (2, 96, 21, 19, 96, 5, 2, 96, False), (1, 40, 13, 13, 40, 7, 1, 40, True),
    *_DENSE_EDGES, *_DW_EDGES])
def test_int8_conv_matches_plain(card, n, c, h, w, o, k, s, groups, bias):
    from yololite_tpu_torch.ops import cuda_int8, quant
    conv = torch.nn.Conv2d(c, o, k, s, k // 2, groups=groups, bias=bias)
    quant.quantize_int8(conv).cuda()
    x = _int8_input((n, c, h, w), seed=k)
    q, sx = cuda_int8.quantize(x)
    if conv.depthwise:
        run = lambda f, t: f(q, sx, conv.w_packed, conv.s_w, conv.bias_f32, conv.stride,
                             conv.padding, t)
        kernel, plain = cuda_int8.conv_depthwise, cuda_int8.conv_depthwise_reference
    else:
        run = lambda f, t: f(q, sx, conv.w_packed, conv.s_w, conv.bias_f32, conv.kernel_size,
                             conv.stride, conv.padding, t)
        kernel, plain = cuda_int8.conv_dense, cuda_int8.conv_dense_reference
    for t in (torch.int32, torch.float32, torch.bfloat16):
        got, want = run(kernel, t), run(plain, t)
        torch.cuda.synchronize()
        assert got.dtype == t and torch.equal(got, want), t
    with torch.no_grad():
        assert torch.equal(conv.to(torch.bfloat16)(x), run(plain, torch.bfloat16))


@pytest.mark.cuda
def test_int8_wrappers_reject_what_the_kernels_do_not_take(card):
    from yololite_tpu_torch.ops import cuda_int8
    x = _int8_input((2, 16, 8, 8)).contiguous()          # NCHW memory
    with pytest.raises(ValueError, match="channels_last"):
        cuda_int8.quantize(x)
    q, s = cuda_int8.quantize(x.contiguous(memory_format=torch.channels_last))
    w = torch.zeros(8, 32, dtype=torch.int8, device="cuda")
    sw = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="int8"):
        cuda_int8.conv_dense(q.float(), s, w, sw, None, (1, 1), (1, 1), (0, 0))
    with pytest.raises(ValueError, match="s_w"):
        cuda_int8.conv_dense(q, s, w, sw[:4], None, (1, 1), (1, 1), (0, 0))
    with pytest.raises(ValueError, match="packed K"):
        cuda_int8.conv_dense(q, s, w, sw, None, (3, 3), (1, 1), (1, 1))
    with pytest.raises(ValueError, match="w_mma"):
        cuda_int8.conv_dense(q, s, w, sw, None, (1, 1), (1, 1), (0, 0), w_mma=w)


@pytest.mark.cuda
def test_s2d_device_pack_equals_host_pack(card):
    from yololite_tpu_torch.deploy.s2d import pack_s2d, pack_s2d_device
    x = (np.random.RandomState(0).rand(3, 64, 48, 3) * 255).astype(np.uint8)
    got = pack_s2d_device(torch.from_numpy(x).cuda())
    assert np.array_equal(got.cpu().numpy(), pack_s2d(x))
