"""PyTorch port parity: NMS and the suppression kernel's plain version.

Discrete outputs (keep masks, indices, classes, padding) must match exactly;
scores and boxes are gathered, not computed, so they match exactly too. The
CUDA kernel itself runs only on the card (`chip_smoke.py` and
`tests/test_torch_port_cuda.py`); here a numpy model of its word layout and
chunked scan (`_kernel_model_keep`) is held against JAX's exact greedy keep,
also exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yololite_tpu.ops.nms import _greedy_keep as jax_greedy_keep
from yololite_tpu.ops.nms import _suppression_matrix as jax_suppression_matrix
from yololite_tpu.ops.nms import batched_nms as jax_batched_nms
from yololite_tpu.ops.nms import nms_numpy as jax_nms_numpy
from yololite_tpu.ops.nms import nms_single as jax_nms_single
from yololite_tpu.ops.nms import yolo_scores as jax_yolo_scores
from yololite_tpu.ops.pallas_nms import pallas_greedy_keep

from yololite_tpu_torch.ops import cuda_nms
from yololite_tpu_torch.ops.nms import _greedy_keep as _port_greedy_keep
from yololite_tpu_torch.ops.nms import batched_nms, nms_numpy, yolo_scores


def random_boxes(rng, shape, span=500.0, size=(5.0, 90.0)):
    cx, cy = rng.rand(2, *shape) * span
    w, h = rng.rand(2, *shape) * (size[1] - size[0]) + size[0]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def chain_boxes(n=30):
    """Boxes along a line, each overlapping only its neighbours above 0.5:
    greedy keeps every other box, and the fixpoint needs ~n/2 steps."""
    step = 20.0
    return np.stack([np.arange(n) * step, np.zeros(n), np.arange(n) * step + 100.0,
                     np.full(n, 50.0)], axis=1).astype(np.float32)


def test_reference_equals_pallas_interpret_and_fixpoint():
    rng = np.random.RandomState(0)
    B, k = 3, 128
    boxes = random_boxes(rng, (B, k))
    valid = rng.rand(B, k) > 0.1
    got = cuda_nms.greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    assert cuda_nms.LAUNCHES == 0          # CPU tensors never reach the kernel
    pallas = np.asarray(pallas_greedy_keep(jnp.asarray(boxes), jnp.asarray(valid),
                                           iou_th=0.5, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    for b in range(B):
        overlap = jax_suppression_matrix(jnp.asarray(boxes[b]), use_diou=False)
        want = np.asarray(jax_greedy_keep(overlap, jnp.asarray(valid[b]), 0.5))
        np.testing.assert_array_equal(got[b].numpy(), want)


def _nms_inputs(seed=3, B=2, n=400, num_classes=4):
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, (B, n), span=600.0, size=(5.0, 85.0))
    scores = rng.rand(B, n).astype(np.float32)
    scores[:, : n // 4] = 0.0                       # ties at zero
    classes = rng.randint(0, num_classes, (B, n)).astype(np.int32)
    return boxes, scores, classes


def _assert_same(got, want):
    names = ("boxes", "scores", "classes", "valid", "idx")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("k", [128, 300])
@pytest.mark.parametrize("conf", [0.05, 0.001])
def test_batched_nms_matches_jax(conf, k, class_aware):
    boxes, scores, classes = _nms_inputs()
    kw = dict(iou_th=0.5, conf_th=conf, max_det=150, pre_nms_topk=k,
              class_aware=class_aware)
    want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), **kw)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("class_aware", [True, False])
def test_batched_nms_diou_matches_jax(class_aware):
    boxes, scores, classes = _nms_inputs(seed=5)
    kw = dict(iou_th=0.45, conf_th=0.01, max_det=100, pre_nms_topk=256,
              class_aware=class_aware, use_diou=True)
    want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), **kw)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("thr", [0.65, 0.3, 0.0, -0.1, -0.4])
def test_op_diou_route_matches_jax(thr):
    """`yololite::nms_suppress` with use_diou on CPU tensors (the kernel's
    plain version) against JAX's `_suppression_matrix(use_diou=True)` and
    `_greedy_keep`, at thresholds >= 0 (where the kernel prunes pairs that
    do not intersect) and < 0 (where it computes every pair); the chain of
    30 boxes in image 0."""
    rng = np.random.RandomState(21)
    B, k = 3, 160
    boxes = random_boxes(rng, (B, k), span=300.0)
    boxes[0, :30] = chain_boxes()
    valid = rng.rand(B, k) > 0.15
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = torch.ops.yololite.nms_suppress(tb, tv, thr, True)
    np.testing.assert_array_equal(cuda_nms.greedy_keep(tb, tv, thr, use_diou=True).numpy(),
                                  got.numpy())
    assert cuda_nms.LAUNCHES == 0 and cuda_nms.LAUNCHES_DIOU == 0
    for b in range(B):
        overlap = jax_suppression_matrix(jnp.asarray(boxes[b]), use_diou=True)
        want = np.asarray(jax_greedy_keep(overlap, jnp.asarray(valid[b]), thr))
        np.testing.assert_array_equal(got[b].numpy(), want)
    # DIoU is a different metric: at these thresholds it keeps other boxes
    iou = torch.ops.yololite.nms_suppress(tb, tv, thr)
    assert thr > 0.5 or not torch.equal(iou, got)


def test_deep_chain_is_exact_greedy():
    """The port's suppression is exact greedy (JAX unroll=0), not the JAX
    deploy graph's bounded unroll, which diverges on this chain."""
    n = 30
    boxes = chain_boxes(n)
    scores = np.linspace(0.9, 0.3, n).astype(np.float32)
    classes = np.zeros(n, np.int32)
    kw = dict(iou_th=0.5, conf_th=0.001, max_det=n, pre_nms_topk=n,
              class_aware=False)
    exact = jax_nms_single(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), **kw)
    unroll2 = jax_nms_single(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(classes), fixpoint_unroll=2, **kw)
    got = batched_nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                      torch.from_numpy(classes)[None], **kw)
    _assert_same([g[0] for g in got], exact)
    assert not np.array_equal(got[3][0].numpy(), np.asarray(unroll2[3]))
    assert int(got[3].sum()) == n // 2
    # the bounded-unroll variant of the plain fixpoint matches JAX's too
    overlap = jax_suppression_matrix(jnp.asarray(boxes), use_diou=False)
    valid = np.ones(n, bool)
    for unroll in (0, 2, 8):
        want = np.asarray(jax_greedy_keep(overlap, jnp.asarray(valid), 0.5, unroll=unroll))
        port = _port_greedy_keep(torch.tensor(np.asarray(overlap)),
                                 torch.from_numpy(valid), 0.5, unroll=unroll)
        np.testing.assert_array_equal(port.numpy(), want)


def test_yolo_scores_and_nms_numpy_match():
    rng = np.random.RandomState(7)
    obj = rng.normal(0, 2, (2, 50)).astype(np.float32)
    cls = rng.normal(0, 2, (2, 50, 4)).astype(np.float32)
    s, c = yolo_scores(torch.from_numpy(obj), torch.from_numpy(cls))
    js, jc = jax_yolo_scores(jnp.asarray(obj), jnp.asarray(cls))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    boxes = random_boxes(rng, (60,))
    scores = rng.rand(60).astype(np.float32)
    np.testing.assert_array_equal(nms_numpy(boxes, scores, 0.5),
                                  jax_nms_numpy(boxes, scores, 0.5))


def test_wrapper_rejects_other_devices():
    boxes = torch.zeros(1, 8, 4, device="meta")
    valid = torch.zeros(1, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_nms.greedy_keep(boxes, valid, 0.5)


@pytest.mark.parametrize("conf", [0.05, 0.001])
def test_batched_nms_matches_jax_above_1024_candidates(conf):
    """k = min(pre_nms_topk, N) = 2048: the port takes any k, as JAX does."""
    boxes, scores, classes = _nms_inputs(seed=11, B=2, n=2100)
    kw = dict(iou_th=0.5, conf_th=conf, max_det=300, pre_nms_topk=2048)
    want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), fixpoint_unroll=0, **kw)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), **kw)
    _assert_same(got, want)


MASK_WARPS = 8        # column words per mask-pass block (kMaskWarps)
SCAN_HELPERS = 8      # helper warps of the scan (kScanHelpers)


def _bits(flags):
    """[..., 32] bool -> [...] int: bit l set where flags[..., l]."""
    return (flags.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)


def _kernel_model_keep(overlap, valid, thr, rng):
    """Numpy model of csrc/nms_suppress.cu, in its index arithmetic: the mask
    pass's blocks, staging and word layout (bit i & 31 of word i >> 5, upper
    triangle of valid rows only), then the scan's chunks with warp 0's
    `carry` and the helpers one chunk behind (near words by warp and lane,
    far words by owner thread). Words the mask pass does not write hold
    random bits, and every word the scan uses must be written."""
    k = len(valid)
    words = (k + 31) // 32
    mask = rng.randint(0, 2 ** 32, (k, words), dtype=np.uint64).astype(np.uint32)
    written = np.zeros((k, words), bool)
    sup = overlap > thr
    for c in range(words):                               # blockIdx.y
        for w0 in range(0, words, MASK_WARPS):           # blockIdx.z * 8
            if w0 + MASK_WARPS - 1 < c:
                continue
            staged = 32 * w0 + np.arange(32 * MASK_WARPS)   # scol[t]
            for warp in range(MASK_WARPS):
                w = w0 + warp
                if w < c or w >= words:
                    continue
                cols = staged[32 * warp:32 * warp + 32]      # sc[l]
                assert (cols == 32 * w + np.arange(32)).all()
                rows = 32 * c + np.arange(32)                # lanes
                row_valid = (rows < k) & valid[np.minimum(rows, k - 1)]
                if not row_valid.any():
                    continue
                for j in rows[row_valid]:
                    lo, hi = max(j + 1 - 32 * w, 0), min(k - 32 * w, 32)
                    keep_cols = np.zeros(32, bool)
                    keep_cols[lo:hi] = True                  # `cols` bitmask
                    iou_bits = sup[j, np.minimum(cols, k - 1)] & (cols < k)
                    mask[j, w] = _bits(iou_bits & keep_cols)
                    written[j, w] = True
    vpad = np.zeros(words * 32, bool)
    vpad[:k] = valid
    validbits = [int(_bits(vpad[32 * c:32 * c + 32])) for c in range(words)]
    removed = [0] * words
    keep = np.zeros(words * 32, bool)
    carry, kept_prev = 0, 0
    for c in range(words):
        # warp 0: (a) resolve chunk c, then word c+1 of its kept rows -> carry
        vb, kept = validbits[c], 0
        if vb:
            cur = removed[c] | carry | (~vb & 0xFFFFFFFF)
            for r in range(32):
                if not (cur >> r) & 1:
                    assert written[32 * c + r, c]
                    cur |= int(mask[32 * c + r, c])
            kept = ~cur & vb & 0xFFFFFFFF
        carry = 0
        for r in range(32):
            keep[32 * c + r] = (kept >> r) & 1
            if (kept >> r) & 1 and c + 1 < words:
                assert written[32 * c + r, c + 1]
                carry |= int(mask[32 * c + r, c + 1])
        # helpers: (b) chunk c-1's kept rows into words c+1 .. c+32 with the
        # values loaded in the step before (warp g: rows g + 8q, lane l: word
        # c+1+l), then into each word beyond through its owner thread
        if c > 0 and kept_prev:
            for g in range(SCAN_HELPERS):
                for lane in range(32):
                    w = c + 1 + lane
                    assert w == (c - 1) + 2 + lane               # loaded ahead
                    for r in range(g, 32, SCAN_HELPERS):
                        if (kept_prev >> r) & 1 and w < words:
                            assert written[32 * (c - 1) + r, w]
                            removed[w] |= int(mask[32 * (c - 1) + r, w])
            for h in range(256):
                w = h
                if w < c + 33:
                    w += ((c + 33 - w + 255) >> 8) << 8
                assert w >= c + 33 and w % 256 == h and w - 256 < c + 33
                for w in range(w, words, 256):
                    for r in range(32):
                        if (kept_prev >> r) & 1:
                            assert written[32 * (c - 1) + r, w]
                            removed[w] |= int(mask[32 * (c - 1) + r, w])
        kept_prev = kept
    return keep[:k]


@pytest.mark.parametrize("k", [1, 33, 64, 100, 300, 1025, 2100, "chain"])
def test_kernel_layout_model_matches_jax_greedy(k):
    """One tile of 8 column words (k <= 256), two (k = 300), five (k = 1025),
    words beyond the helpers' near stripe (k = 2100), ragged last words, and
    the 100-box chain across four words."""
    rng = np.random.RandomState(17)
    if k == "chain":
        boxes = chain_boxes(100)
        valid = np.ones(100, bool)
    else:
        boxes = random_boxes(rng, (k,), span=400.0)
        valid = rng.rand(k) > 0.15
    overlap = jax_suppression_matrix(jnp.asarray(boxes), use_diou=False)
    want = np.asarray(jax_greedy_keep(overlap, jnp.asarray(valid), 0.5))
    got = _kernel_model_keep(np.asarray(overlap), valid, 0.5, rng)
    np.testing.assert_array_equal(got, want)
    if k == "chain":
        assert got.tolist() == [i % 2 == 0 for i in range(100)]
