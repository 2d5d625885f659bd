"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device   a CUDA card must be present; prints `nvidia-smi` name, power limit
  2. build    compiles every CUDA source of the serving path (build/kernels/)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the serving path's shapes and beyond (nms_suppress: B=128 at
              k = 256, 512, 1024, 2048; B=1 at k=512; B=8 at k=8,400 and
              k=8,683): the keep masks must be equal; prints kernel, mask-pass, scan and
              plain ms beside the bound
  4. fp32     edge_n @640, 2 images, TF32 off: card (kernel) against CPU
              (plain version)
  5. serve    edge_n @640 at full width, seeded heads and the bundled
              MobileNetV4 backbone weights, bf16 channels_last, through
              Predictor.infer_batched_stream (b128), Predictor.infer_image and
              YoloLite.predict; the kernel launch counts must grow; prints
              img/s and per-stage ms
  6. zoo      every detection config under configs/ (15; read with the port's
              own YAML reader, 3 classes) at full width and depth, seeded
              weights with BatchNorm statistics set from one forward: fp32
              card vs CPU at 640 (TF32 off; batched_nms on equal inputs
              bit-exact), then bf16 channels_last serving at 640 b128
              (Predictor.infer_batched_stream, device-resident, 2 runs of 4
              batches, and one YoloLite.predict frame) with the kernel's
              launches counted; prints params, img/s, forward ms, top kernel
Then one JSON line with every kernel's numbers, and last the result line
{"ok": true, "device": {...}}. A copy of the numbers goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from yololite_tpu_torch.api import YoloLite  # noqa: E402
from yololite_tpu_torch.config import read_yaml  # noqa: E402
from yololite_tpu_torch.config.config import MODEL_DIRS  # noqa: E402
from yololite_tpu_torch.convert import load_flax  # noqa: E402
from yololite_tpu_torch.csrc import build as kbuild  # noqa: E402
from yololite_tpu_torch.deploy.fold_norm import normalize_images  # noqa: E402
from yololite_tpu_torch.deploy.predictor import PRE_NMS_TOPK, Predictor  # noqa: E402
from yololite_tpu_torch.models.detector import (  # noqa: E402
    build_model_from_config, count_params, init_weights,
)
from yololite_tpu_torch.models.layers import BatchNorm  # noqa: E402
from yololite_tpu_torch.ops import cuda_nms  # noqa: E402
from yololite_tpu_torch.ops.decode import decode_anchorfree  # noqa: E402
from yololite_tpu_torch.ops.nms import (  # noqa: E402
    batched_nms, finalize_detections, select_candidates, yolo_scores,
)
from yololite_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402

IMG = 640
BATCH = 128
EDGE_N = {"model": {"arch": "YOLOLiteMS_CPU", "backbone": "mobilenetv4_conv_small_050",
                    "depth_multiple": 0.65, "width_multiple": 0.60,
                    "fpn_channels": 160, "head_depth": 1, "num_classes": 3,
                    "num_anchors_per_level": 1}}
BACKBONE_CKPT = os.path.join(ROOT, "weights", "mnv4_050_cls20.ckpt")
# H100 SXM published peaks (NVIDIA H100 datasheet): fp32 outside the
# tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
IOU_FLOPS_PER_PAIR = 15   # 4 min/max, 4 sub, 2 clamp, 1 mul, 2 add, 1 div, 1 cmp
SLEEP_CYCLES_PER_MS = 2.0e6   # at most ~2 GHz SM clock: a sleep at least this long
NMS_CASES = [(BATCH, 256), (BATCH, PRE_NMS_TOPK), (BATCH, 1024), (BATCH, 2048),
             (1, PRE_NMS_TOPK), (8, 8400),    # (B, k); k=8,400: every anchor at 640
             (8, 8683)]                       # ConvNeXtV2-tiny's 81²+41²+21² anchors
# every detection config, with its parameter count at 3 classes (the JAX
# package's count, held in tests/test_torch_port_zoo_detectors.py)
ZOO_PARAMS = {
    "configs/models/edge_l.yaml": 4_351_608,
    "configs/models/edge_m.yaml": 2_948_948,
    "configs/models/edge_n.yaml": 549_640,
    "configs/models/edge_s.yaml": 2_359_736,
    "configs/models/edge_xl.yaml": 9_344_168,
    "configs/models/yololite_l.yaml": 30_379_544,
    "configs/models/yololite_m.yaml": 13_924_752,
    "configs/models/yololite_n.yaml": 6_293_616,
    "configs/models/yololite_s.yaml": 9_369_368,
    "configs/models/yololite_xl.yaml": 44_597_528,
    "configs/v2_models/yololite_l.yaml": 52_219_704,
    "configs/v2_models/yololite_m.yaml": 17_913_598,
    "configs/v2_models/yololite_n.yaml": 8_921_632,
    "configs/v2_models/yololite_s.yaml": 12_431_916,
    "configs/custom/custom.yaml": 5_338_840,
}
# fp32 card vs CPU, two checks. (1) Both are fp32 evaluations of one
# function, so each is held against the CPU's fp64 forward of the same
# weights and image: the card's max abs error there must stay within
# ZOO_FP32_FACTOR times the CPU fp32 forward's own (cuDNN may pick other conv
# algorithms, such as Winograd, whose rounding differs by a small factor; a
# wrong op or weight errs by the outputs' scale). (2) Card vs CPU directly,
# within ZOO_FP32_RTOL of the outputs' scale. The seeded nets' BatchNorm
# divides some channels by a small calibrated std, which amplifies rounding:
# the CPU fp32's own error against fp64 reaches ~1.4e-4 of the scale
# (HGNetV2-B0, whose ReLU taps leave channels of small std), so two fp32
# forwards may differ by about twice that; 1e-3 leaves room.
ZOO_FP32_FACTOR = 10.0
ZOO_FP32_RTOL = 1e-3
ZOO_BATCHES, ZOO_RUNS = 4, 2
KERNELS = [{"name": "nms_suppress", "route": "cuda", "source": cuda_nms.SOURCE,
            "replaces": "yololite_tpu/ops/pallas_nms.py:74"}]


def log(msg=""):
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events).

    The calls are queued behind a sleep kernel that outlasts their host-side
    launch time, so the device runs them back to back and a short kernel is
    not paced by the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * iters * host_ms + 1.0, 200.0) * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    secs = kbuild.build([k["name"] for k in KERNELS])
    for name, s in secs.items():
        log(f"build {name}: {s:.2f} s")
        for line in kbuild.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {line.strip()}")
    log(f"build total: {time.perf_counter() - t0:.2f} s")


def _dense_boxes(rng, b, k):
    """Dense overlapping boxes in a 640 px image, class-shifted like the
    serving path (3 classes, coord_bound 8192), and the 30-box alternating
    suppression chain in the first slots of image 0."""
    cx, cy = rng.rand(2, b, k) * IMG
    w, h = rng.rand(2, b, k) * 120 + 8
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes += (rng.randint(0, 3, (b, k)) * 8192.0)[..., None]
    n = min(30, k)
    boxes[0, :n] = np.stack([np.arange(n) * 20.0, np.zeros(n),
                             np.arange(n) * 20.0 + 100.0, np.full(n, 50.0)], 1)
    valid = rng.rand(b, k) > 0.1
    valid[0, :n] = True
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


def nms_bound_ms(keep: torch.Tensor, valid: torch.Tensor):
    """Least time for the suppression on this data: the IoUs exact greedy
    needs (each kept box against every later valid candidate) at the fp32
    rate, or the bytes (boxes and valid in, keep out) at the memory rate."""
    later_valid = valid.flip(-1).cumsum(-1).flip(-1) - valid.long()
    pairs = int((later_valid * keep).sum())
    b, k = keep.shape
    ops = pairs * IOU_FLOPS_PER_PAIR
    nbytes = b * k * (16 + 1 + 1)                # boxes f32, valid, keep
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations", pairs) if t_ops >= t_bytes else (t_bytes, "bytes", pairs)


def _launch_split(boxes, valid, iou_th):
    """The kernel's two launches as separate calls, for timing them apart
    (not counted in cuda_nms.LAUNCHES)."""
    lib = cuda_nms.library()
    b, k = valid.shape
    scratch = torch.empty((b, k, cuda_nms.mask_words(k)), dtype=torch.int32, device="cuda")
    keep = torch.empty((b, k), dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    def mask():
        check(lib.yl_nms_mask(boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
                              b, k, iou_th, stream), "yl_nms_mask")

    def scan():
        check(lib.yl_nms_scan(scratch.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                              b, k, stream), "yl_nms_scan")
    return mask, scan, keep


def phase_kernels(card: str):
    rng = np.random.RandomState(0)
    rows, max_err, thr = {}, 0, 0.65
    for b, k in NMS_CASES:
        boxes, valid = _dense_boxes(rng, b, k)
        got = cuda_nms.greedy_keep(boxes, valid, thr)
        want = cuda_nms.greedy_keep_reference(boxes, valid, thr)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        if err:
            bad = int((got != want).sum())
            raise AssertionError(f"nms_suppress B={b} k={k}: {bad} keep bits differ")
        if k >= 30 and int(got[0, :30].sum()) != 15:
            raise AssertionError("nms_suppress: the 30-box chain must keep 15")
        mask, scan, split_keep = _launch_split(boxes, valid, thr)
        mask()
        scan()
        torch.cuda.synchronize()
        if not torch.equal(split_keep, got):
            raise AssertionError(f"nms_suppress B={b} k={k}: split launches differ")
        many = 50 if b * k <= 2 ** 17 else 20
        ms = cuda_ms(lambda: cuda_nms.greedy_keep(boxes, valid, thr), many)
        ms_mask = cuda_ms(mask, many)
        ms_scan = cuda_ms(scan, many)
        plain = cuda_ms(lambda: cuda_nms.greedy_keep_reference(boxes, valid, thr), 3, 1)
        bound, by, pairs = nms_bound_ms(got, valid)
        key = f"B{b}_k{k}"
        rows[key] = {"batch": b, "k": k, "ms": ms, "ms_mask": ms_mask, "ms_scan": ms_scan,
                     "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                     "pairs": pairs, "kept": int(got.sum())}
        log(f"kernel nms_suppress B={b} k={k}: equal keep masks ({int(got.sum())} kept); "
            f"kernel {ms:.4f} ms (mask {ms_mask:.4f}, scan {ms_scan:.4f}), "
            f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}, {pairs} pairs) [{card}]")
        del boxes, valid, got, want, mask, scan, split_keep
        torch.cuda.empty_cache()
    chain = torch.tensor([[i * 20.0, 0.0, i * 20.0 + 100.0, 50.0] for i in range(30)],
                         device="cuda")[None]
    keep = cuda_nms.greedy_keep(chain.contiguous(),
                                torch.ones(1, 30, dtype=torch.bool, device="cuda"), 0.5)
    if keep[0].tolist() != [i % 2 == 0 for i in range(30)]:
        raise AssertionError("nms_suppress: chain of 30 must keep every other box")
    log("kernel nms_suppress: 30-box chain keeps every other box (exact greedy)")
    return rows, max_err


def _edge_n_model(seed: int = 0):
    model = init_weights(build_model_from_config(EDGE_N), seed)
    sd, meta = load_checkpoint(BACKBONE_CKPT)      # backbone subtree at top level
    load_flax(model.backbone, sd["params"], sd["batch_stats"])
    return model.eval()


def _match(card_dets, cpu_dets, box_tol, score_tol):
    """Fraction of card detections with a CPU detection of the same class,
    box within box_tol px and score within score_tol."""
    hits = 0
    for (b, s, c), (cb, cs, cc) in zip(card_dets, cpu_dets):
        for i in range(len(b)):
            same = ((cc == c[i]) & (np.abs(cb - b[i]).max(-1) <= box_tol)
                    & (np.abs(cs - s[i]) <= score_tol))
            hits += bool(same.any())
    total = sum(len(b) for b, _, _ in card_dets)
    return hits / max(total, 1), total


def phase_fp32(card: str):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = _edge_n_model()
        meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
        gpu = Predictor((model, model.state_dict(), meta), device="cuda",
                        dtype=torch.float32)
        cpu = Predictor((model, model.state_dict(), meta), device="cpu",
                        dtype=torch.float32)
        imgs = (np.random.RandomState(1).rand(2, IMG, IMG, 3) * 255).astype(np.uint8)
        with torch.inference_mode():
            og = gpu.forward(torch.from_numpy(imgs).cuda())
            oc = cpu.forward(torch.from_numpy(imgs))
            err = max(float((a.cpu() - b).abs().max()) for a, b in zip(og, oc))
            scale = max(float(b.abs().max()) for b in oc)
            dec_c = _decode_scores(oc)
            dec_g = _decode_scores([o.cuda() for o in oc])
            dec_err = float((dec_g[0].cpu() - dec_c[0]).abs().max())
            # NMS of the SAME decoded inputs: kernel on the card vs the plain
            # fixpoint on the CPU must agree bit for bit, padding included
            kw = dict(iou_th=0.45, conf_th=0.001, max_det=300, pre_nms_topk=PRE_NMS_TOPK)
            ng = batched_nms(*(t.cuda() for t in dec_c), **kw)
            nc = batched_nms(*dec_c, **kw)
            for name, a, b in zip(("boxes", "scores", "classes", "valid", "idx"), ng, nc):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"fp32 batched_nms {name}: card != CPU")
        log(f"fp32 forward card vs CPU: max abs err {err:.3e} over |x| <= {scale:.2f} "
            f"(tolerance 1e-3); decoded boxes max abs err {dec_err:.3e} px "
            f"(tolerance 1e-2); batched_nms on equal inputs bit-exact")
        if err > 1e-3 or dec_err > 1e-2:
            raise AssertionError(f"fp32 forward/decode differ: {err}, {dec_err}")
        dets_g = [gpu.infer_image(im[..., ::-1], conf=0.001) for im in imgs]
        dets_c = [cpu.infer_image(im[..., ::-1], conf=0.001) for im in imgs]
        frac, total = _match(dets_g, dets_c, 1e-2, 1e-5)
        n_c = sum(len(d[0]) for d in dets_c)
        log(f"fp32 end to end: {total} card / {n_c} CPU detections, "
            f"{frac:.4f} of card detections matched (need >= 0.99)")
        if total == 0 or frac < 0.99 or abs(total - n_c) > 0.01 * n_c:
            raise AssertionError("fp32 end-to-end detections disagree")
        return {"fwd_max_abs_err": err, "dets": total, "matched": frac}
    finally:
        torch.backends.cudnn.allow_tf32 = True


def phase_serve(card: str, n_batches: int = 8, rounds: int = 3, n_single: int = 20):
    model = _edge_n_model()
    log(f"edge_n: {count_params(model)} params, img {IMG}, batch {BATCH}, bf16 channels_last")
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    pred = Predictor((model, model.state_dict(), meta), device="cuda",
                     dtype=torch.bfloat16)
    rng = np.random.RandomState(2)
    host = [(rng.rand(BATCH, IMG, IMG, 3) * 255).astype(np.uint8) for _ in range(2)]
    dev = [torch.from_numpy(h).cuda() for h in host]
    frames = [(rng.rand(480, 640, 3) * 255).astype(np.uint8) for _ in range(3)]
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    pred.warmup(**kw)
    list(pred.infer_batched_stream(dev[:1], prepared=True, **kw))
    torch.cuda.synchronize()

    def stream(batches):
        """img/s and detections of one infer_batched_stream pass (depth 2)."""
        t0 = time.perf_counter()
        dets = sum(len(r["boxes"]) for out in pred.infer_batched_stream(
            (batches[i % 2] for i in range(n_batches)), prepared=True, depth=2, **kw)
            for r in out)
        return n_batches * BATCH / (time.perf_counter() - t0), dets

    cuda_nms.LAUNCHES = 0
    runs_host = [stream(host) for _ in range(rounds)]
    runs_dev = [stream(dev) for _ in range(rounds)]
    singles = [pred.infer_image_profiled(frames[i % len(frames)], **kw)
               for i in range(n_single)]
    api = YoloLite((model, model.state_dict(), meta)).predict(frames[:2], **kw)
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    expected = 2 * rounds * n_batches + n_single + 1
    log(f"serve: nms_suppress launched {launches} times in the main path "
        f"(expected {expected}: one per graph call)")
    if launches != expected:
        raise AssertionError("the serving path did not go through the kernel")
    n_dets = [d for _, d in runs_host + runs_dev] + [
        sum(len(r["boxes"]) for r in singles + api)]
    if min(n_dets) == 0:
        raise AssertionError("serving returned no detections")
    for r in singles + api:
        b = r["boxes"]
        if not (np.isfinite(b).all() and b.shape[1] == 4 and (b[:, 2] <= 639).all()
                and (b[:, 3] <= 479).all()):
            raise AssertionError("single-frame boxes not finite / not in the frame")
    ips_host = [r for r, _ in runs_host]
    ips_dev = [r for r, _ in runs_dev]
    single_ms = np.array([r["speed"]["total_ms"] for r in singles])
    log(f"serve: img/s at b{BATCH} from host uint8 batches (upload included), "
        f"{rounds} runs of {n_batches} batches: "
        f"{', '.join(f'{v:.1f}' for v in ips_host)} [{card}]")
    log(f"serve: img/s at b{BATCH} from device-resident batches, {rounds} runs of "
        f"{n_batches} batches: {', '.join(f'{v:.1f}' for v in ips_dev)} [{card}]")
    log(f"serve: infer_image per 480x640 frame (host letterbox included), "
        f"n={n_single}: median {np.median(single_ms):.2f} ms, "
        f"p90 {np.percentile(single_ms, 90):.2f} ms [{card}]")

    # per-stage device time at b128 (outside the launch-count window)
    x = dev[0]
    with torch.inference_mode():
        stages = {"forward": cuda_ms(lambda: pred.forward(x), 10)}
        outs = pred.forward(x)
        stages["decode+scores"] = cuda_ms(lambda: _decode_scores(outs), 10)
        box, scores, classes = _decode_scores(outs)
        sel = lambda: select_candidates(box, scores, classes, conf_th=kw["conf"],
                                        k=PRE_NMS_TOPK, class_aware=True)
        stages["topk+gather"] = cuda_ms(sel, 10)
        top, idx, boxes_k, cls_k, valid, shifted = sel()
        shifted = shifted.contiguous()
        stages["suppression"] = cuda_ms(
            lambda: cuda_nms.greedy_keep(shifted, valid, kw["iou"]), 20)
        keep = cuda_nms.greedy_keep(shifted, valid, kw["iou"])
        stages["final top-k"] = cuda_ms(
            lambda: finalize_detections(keep, top, idx, boxes_k, cls_k,
                                        max_det=kw["max_det"]), 10)
        stages["whole graph"] = cuda_ms(
            lambda: pred.postprocess(pred.forward(x), IMG, **kw), 10)
        # the stage split must reproduce the composed path
        ref = batched_nms(box, scores, classes, iou_th=kw["iou"], conf_th=kw["conf"],
                          max_det=kw["max_det"], pre_nms_topk=PRE_NMS_TOPK)
        fin = finalize_detections(keep, top, idx, boxes_k, cls_k, max_det=kw["max_det"])
        if not all(torch.equal(a, b) for a, b in zip(ref, fin)):
            raise AssertionError("stage split disagrees with batched_nms")
    for name, ms in stages.items():
        log(f"stage {name}: {ms:.3f} ms per b{BATCH} batch [{card}]")
    log(f"stage whole graph: {BATCH / stages['whole graph'] * 1e3:.1f} img/s "
        f"device-only [{card}]")
    return {"launches": launches, "img_s_host": ips_host, "img_s_device_stream": ips_dev,
            "infer_image_ms": single_ms.tolist(), "stages_ms": stages,
            "profile": profile_graph(pred, x, card, kw)}


def profile_graph(pred, x, card: str, kw, iters: int = 3, rows: int = 10):
    """torch.profiler over `iters` device-resident b128 graph calls: device
    busy share of the window and the `rows` kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                pred.postprocess(pred.forward(x), IMG, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:rows]
    log(f"profile: {iters} graph calls, device busy {dev_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall ({100 * dev_ms / wall_ms:.1f}% busy; profiler on) [{card}]")
    rows = []
    for e in top:
        ms = e.self_device_time_total / 1e3 / iters
        rows.append({"kernel": e.key[:120], "ms_per_call": ms, "count": e.count // iters})
        log(f"  {ms:8.3f} ms/call  x{e.count // iters:<4d} {e.key[:100]}")
    return {"busy_ms": dev_ms, "wall_ms": wall_ms, "iters": iters, "top": rows}


def zoo_configs():
    """(path relative to the repo, config) of every detection config under
    configs/, read with the port's own YAML reader, at 3 classes."""
    out = []
    for sub in MODEL_DIRS:
        for path in sorted(glob.glob(os.path.join(ROOT, "configs", sub, "*.yaml"))):
            cfg = read_yaml(path)
            if "model" in cfg and not cfg["model"].get("with_masks"):
                cfg["model"]["num_classes"] = 3
                out.append((os.path.relpath(path, ROOT), cfg))
    if sorted(rel for rel, _ in out) != sorted(ZOO_PARAMS):
        raise AssertionError(f"detection configs {[r for r, _ in out]} "
                             f"!= {sorted(ZOO_PARAMS)}")
    return out


@torch.no_grad()
def calibrate_batchnorm(model: torch.nn.Module, x: torch.Tensor) -> torch.nn.Module:
    """Set every BatchNorm's running mean and variance to the statistics of
    its input over one forward of `x` (layer by layer, in order), as training
    would. A seeded model otherwise fades to nothing through depth: its
    convs shrink each signal (U(+-1/sqrt(fan_in)) has gain 1/sqrt(3)) and
    identity BatchNorm does not restore it, so every level output would be
    its head bias."""
    def set_stats(mod, args):
        h = args[0].float()
        mod.running_mean.copy_(h.mean((0, 2, 3)))
        mod.running_var.copy_(h.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return model


def _zoo_model(cfg, images_u8: torch.Tensor):
    """Seeded full-size model (seed 0) whose BatchNorm statistics come from
    one fp32 forward of `images_u8` on the card, so that activations keep
    their scale through depth (see calibrate_batchnorm)."""
    model = init_weights(build_model_from_config(cfg), seed=0).cuda().eval()
    calibrate_batchnorm(model, normalize_images(images_u8.permute(0, 3, 1, 2)))
    return model.cpu()


def zoo_fp32(model, meta, img: torch.Tensor, kw):
    """One image at 640, TF32 off: the card's fp32 level maps against the
    CPU's, and each against the CPU's fp64 forward (see ZOO_FP32_FACTOR and
    ZOO_FP32_RTOL); batched_nms of
    the CPU's decoded outputs on the card (kernel) and the CPU (plain
    version) bit-exact."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        triple = (model, model.state_dict(), meta)
        gpu = Predictor(triple, device="cuda", dtype=torch.float32)
        cpu = Predictor(triple, device="cpu", dtype=torch.float32)
        cpu64 = Predictor(triple, device="cpu", dtype=torch.float64)
        with torch.inference_mode():
            og = [o.cpu() for o in gpu.forward(img.cuda())]
            t1 = time.perf_counter()
            oc = cpu.forward(img)
            t_cpu = time.perf_counter() - t1
            o64 = cpu64.forward(img)

            def max_err(outs):
                return max(float((a.double() - b).abs().max()) for a, b in zip(outs, o64))
            err_card, err_cpu = max_err(og), max_err(oc)
            err = max(float((a - b).abs().max()) for a, b in zip(og, oc))
            scale = max(float(o.abs().max()) for o in o64)
            dec = _decode_scores(oc)
            got = batched_nms(*(t.cuda() for t in dec), **kw)
            want = batched_nms(*dec, **kw)
            names = ("boxes", "scores", "classes", "valid", "idx")
            for name, a, b in zip(names, got, want):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"zoo fp32 batched_nms {name}: card != CPU")
        if not (err_card <= ZOO_FP32_FACTOR * err_cpu and err <= ZOO_FP32_RTOL * scale):
            raise AssertionError(f"zoo fp32 forward: card vs CPU {err}, card vs fp64 "
                                 f"{err_card}, CPU fp32 vs fp64 {err_cpu} (scale {scale})")
        return {"fwd_max_abs_err": err, "card_vs_fp64": err_card, "cpu_vs_fp64": err_cpu,
                "scale": scale, "anchors": int(dec[0].shape[1]),
                "nms_kept": int(want[3].sum()), "cpu_forward_s": t_cpu,
                "s": time.perf_counter() - t0}
    finally:
        torch.backends.cudnn.allow_tf32 = True


def zoo_serve(model, meta, dev, frame, card: str, kw):
    """bf16 channels_last Predictor, device-resident b128 batches: warmup,
    then ZOO_RUNS runs of ZOO_BATCHES batches and one YoloLite.predict frame
    with the kernel's launches counted; forward ms and the top kernels."""
    pred = Predictor((model, model.state_dict(), meta), device="cuda", dtype=torch.bfloat16)
    pred.warmup(**kw)
    list(pred.infer_batched_stream(dev[:1], prepared=True, **kw))
    torch.cuda.synchronize()

    def stream():
        t0 = time.perf_counter()
        dets = sum(len(r["boxes"]) for out in pred.infer_batched_stream(
            (dev[i % len(dev)] for i in range(ZOO_BATCHES)), prepared=True, depth=2, **kw)
            for r in out)
        return ZOO_BATCHES * BATCH / (time.perf_counter() - t0), dets

    cuda_nms.LAUNCHES = 0
    runs = [stream() for _ in range(ZOO_RUNS)]
    api = YoloLite((model, model.state_dict(), meta)).predict(frame, **kw)[0]
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    expected = ZOO_RUNS * ZOO_BATCHES + 1
    if launches != expected:
        raise AssertionError(f"zoo: nms_suppress launched {launches} times, "
                             f"expected {expected} (one per graph call)")
    b = api["boxes"]
    if min(d for _, d in runs) == 0 or len(b) == 0:
        raise AssertionError("zoo: serving returned no detections")
    if not (np.isfinite(b).all() and (b[:, 2] <= frame.shape[1] - 1).all()
            and (b[:, 3] <= frame.shape[0] - 1).all()):
        raise AssertionError("zoo: predict boxes not finite / not in the frame")
    x = dev[0]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.forward(x), 5, 1)
    prof = profile_graph(pred, x, card, kw, iters=1, rows=3)
    return {"launches": launches, "img_s": [r for r, _ in runs],
            "dets": [d for _, d in runs], "forward_ms": fwd_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "profile": prof}


def phase_zoo(card: str):
    rng = np.random.RandomState(3)
    dev = [torch.from_numpy((rng.rand(BATCH, IMG, IMG, 3) * 255).astype(np.uint8)).cuda()
           for _ in range(2)]
    calib = dev[0][:2].clone()
    img = torch.from_numpy((rng.rand(1, IMG, IMG, 3) * 255).astype(np.uint8))
    frame = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    meta = {"img_size": IMG, "names": ["c0", "c1", "c2"]}
    kw_nms = dict(iou_th=0.45, conf_th=0.001, max_det=300, pre_nms_topk=PRE_NMS_TOPK)
    kw = dict(conf=0.001, iou=0.45, max_det=300)
    rows = {}
    for rel, cfg in zoo_configs():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = _zoo_model(cfg, calib)
        params = count_params(model)
        if params != ZOO_PARAMS[rel]:
            raise AssertionError(f"{rel}: {params} params, JAX has {ZOO_PARAMS[rel]}")
        fp32 = zoo_fp32(model, meta, img, kw_nms)
        serve = zoo_serve(model, meta, dev, frame, card, kw)
        top = serve["profile"]["top"][0]
        rows[rel] = {"backbone": cfg["model"]["backbone"], "params": params,
                     "fp32": fp32, **serve, "s": time.perf_counter() - t0}
        log(f"zoo {rel} ({cfg['model']['backbone']}): {params} params; fp32 card vs CPU "
            f"max abs err {fp32['fwd_max_abs_err']:.3e} over |x| <= {fp32['scale']:.2f} "
            f"(tolerance {ZOO_FP32_RTOL:g} x scale); "
            f"against CPU fp64: card {fp32['card_vs_fp64']:.3e}, CPU fp32 "
            f"{fp32['cpu_vs_fp64']:.3e} (card must stay within {ZOO_FP32_FACTOR:g}x); "
            f"batched_nms over {fp32['anchors']} anchors bit-exact ({fp32['nms_kept']} "
            f"kept); CPU fp32 forward {fp32['cpu_forward_s']:.2f} s")
        ips = ", ".join(f"{v:.1f}" for v in serve["img_s"])
        log(f"zoo {rel}: bf16 b{BATCH} img/s {ips}"
            f"; forward {serve['forward_ms']:.3f} ms; nms_suppress launches "
            f"{serve['launches']}; peak {serve['peak_gb']:.2f} GB; top kernel "
            f"{top['ms_per_call']:.3f} ms {top['kernel'][:80]}; "
            f"{rows[rel]['s']:.1f} s [{card}]")
        del model
        torch.cuda.empty_cache()
    return rows


def _decode_scores(outs):
    d = decode_anchorfree([o.float() for o in outs], IMG)
    scores, classes = yolo_scores(d["obj"][..., 0], d["cls"])
    return d["box"], scores, classes


def main():
    card = phase_device()
    phase_build()
    krows, max_err = phase_kernels(card)
    fp32 = phase_fp32(card)
    serve = phase_serve(card)
    t_zoo = time.perf_counter()
    zoo = phase_zoo(card)
    log(f"zoo: {len(zoo)} configs in {time.perf_counter() - t_zoo:.1f} s")
    main_k = krows[f"B{BATCH}_k{PRE_NMS_TOPK}"]
    kernels = [dict(KERNELS[0], launches=serve["launches"], max_abs_err=float(max_err),
                    ms=main_k["ms"], plain_ms=main_k["plain_ms"],
                    bound_ms=main_k["bound_ms"], bound_by=main_k["bound_by"],
                    library_ms=None, ms_mask=main_k["ms_mask"], ms_scan=main_k["ms_scan"],
                    ms_b1=krows[f"B1_k{PRE_NMS_TOPK}"]["ms"],
                    ms_by_k={key: r["ms"] for key, r in krows.items()})]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels_by_k": krows, "fp32": fp32,
                   "serve": serve, "zoo": zoo}, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
