"""A/B of the int8 conv kernels on one NVIDIA card: this tree's
`int8_conv_dense` and `int8_conv_depthwise` (csrc/int8_conv.cu) against an
older build of the same file, at every distinct quantized conv call of the
edge_n @640 b128 bf16 int8 forward, in turns (old, new, new, old); with
--parent, the bf16 and int8 serving graphs of an older checkout against this
tree's, one process each, in turns (parent, change, change, parent).

    mkdir -p build/int8_ab/parent
    git show <commit>:yololite_tpu_torch/csrc/int8_conv.cu > build/int8_ab/int8_conv_old.cu
    git archive <commit> | tar -x -C build/int8_ab/parent
    python3 chip_int8_ab.py --old build/int8_ab/int8_conv_old.cu --parent build/int8_ab/parent

The old file must have the C interface it had before the launch plans
(`yl_int8_conv_dense` with 15 ints after the pointers, the depthwise with
13), and its kernels must equal the plain versions as the new ones must: a
call where either differs fails the run. Per call it prints both kernels'
ms in each turn beside the bytes/operations bound and, for the 1x1 calls,
`torch._int_mm` on the same operands; then the sums over one forward (each
distinct call times its calls a forward) and the calls where the new kernel
is slower than the old in both turns. Writes chiprun_out/int8_ab.json.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from yololite_tpu_torch.csrc import build as kbuild  # noqa: E402
from yololite_tpu_torch.deploy.predictor import Predictor  # noqa: E402
from yololite_tpu_torch.ops import cuda_int8, quant  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "int8_ab.json")
ITERS = 5
# one process of a tree: edge_n bf16 and int8 Predictors at b128, whole
# graph ms (CUDA events) and img/s from device and host batches
GRAPH_RUN = r"""
import json, numpy as np, torch
import chip_smoke as c
from yololite_tpu_torch.deploy.predictor import Predictor
card = c.phase_device(); c.phase_build()
model = c._edge_n_model(); meta = {"img_size": c.IMG, "names": ["c0", "c1", "c2"]}
rng = np.random.RandomState(9)
host = [(rng.rand(c.BATCH, c.IMG, c.IMG, 3) * 255).astype(np.uint8) for _ in range(2)]
dev = [torch.from_numpy(h).cuda() for h in host]
kw = dict(conf=0.001, iou=0.45, max_det=300)
w = (model, model.state_dict(), meta)
preds = {"bf16": Predictor(w, device="cuda", dtype=torch.bfloat16),
         "int8": Predictor(w, device="cuda", dtype=torch.bfloat16, quantize="int8")}
for p in preds.values():
    list(p.infer_batched_stream([dev[0], host[0]], prepared=True, **kw))
out = {"card": card}
with torch.inference_mode():
    for name, p in preds.items():
        out[name + "_graph_ms"] = c.cuda_ms(
            lambda p=p: p.postprocess(p.forward(dev[0]), c.IMG, **kw), 5)
order = ("bf16", "int8", "int8", "bf16")
batches = dict.fromkeys(preds, {"device": dev, "host": host})
out["img_s"], _ = c._serve_turns(preds, batches, kw, order)
print("AB_RESULT " + json.dumps(out), flush=True)
"""


def load_old(path: str) -> ctypes.CDLL:
    """nvcc the old source with this tree's flags into build/int8_ab/."""
    src = open(path, "rb").read()
    h = hashlib.sha256(src + " ".join(kbuild.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "int8_ab", f"int8_conv_old-{h}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        r = subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", out, path],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {path}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(out)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.yl_int8_conv_dense.argtypes = [ptr] * 6 + [i32] * 15 + [ptr]
    lib.yl_int8_conv_depthwise.argtypes = [ptr] * 6 + [i32] * 13 + [ptr]
    lib.yl_int8_conv_dense.restype = lib.yl_int8_conv_depthwise.restype = i32
    return lib


def old_conv(lib, mod, q, s, out_dtype):
    """The old kernels' launch (no plan: the argument list before launch plans)."""
    n, c, h, w = q.shape
    kh, kw = mod.kernel_size
    oh, ow = cuda_int8._out_size(h, w, mod.kernel_size, mod.stride, mod.padding)
    o = mod.out_channels
    out = torch.empty((n, o, oh, ow), dtype=out_dtype, device=q.device,
                      memory_format=torch.channels_last)
    bias = 0 if mod.bias_f32 is None else mod.bias_f32.data_ptr()
    ptrs = (q.data_ptr(), mod.w_packed.data_ptr(), s.data_ptr(), mod.s_w.data_ptr(), bias,
            out.data_ptr(), cuda_int8._OUT_TYPES[out_dtype])
    geo = (n, h, w, c, oh, ow)
    sp = (mod.stride[0], mod.stride[1], mod.padding[0], mod.padding[1])
    stream = torch.cuda.current_stream().cuda_stream
    if mod.depthwise:
        err = lib.yl_int8_conv_depthwise(*ptrs, *geo, kh, kw, *sp, stream)
    else:
        err = lib.yl_int8_conv_dense(*ptrs, *geo, o, kh, kw, *sp, mod.w_packed.shape[1], stream)
    if err:
        raise RuntimeError(f"old int8 kernel: CUDA error {err}")
    return out


def ab_calls(lib, card: str):
    model = cs._edge_n_model()
    meta = {"img_size": cs.IMG, "names": ["c0", "c1", "c2"]}
    pred = Predictor((model, model.state_dict(), meta), device="cuda", dtype=torch.bfloat16,
                     quantize="int8")
    rng = np.random.RandomState(9)
    x0 = torch.from_numpy((rng.rand(cs.BATCH, cs.IMG, cs.IMG, 3) * 255).astype(np.uint8)).cuda()
    rows, calls = {}, {}

    def hook(mod, args):
        x = args[0]
        if not quant.should_quantize(x):
            return
        key = cs._conv_key(mod, x)
        calls[key] = calls.get(key, 0) + 1
        if key in rows:
            return
        q, s = cuda_int8.quantize(x)
        args_p = cs._int8_args(mod)
        new = lambda: cs._int8_kernel(mod)(q, s, *args_p, x.dtype)    # noqa: E731
        old = lambda: old_conv(lib, mod, q, s, x.dtype)                # noqa: E731
        plain = cuda_int8.conv_depthwise_reference if mod.depthwise else \
            cuda_int8.conv_dense_reference
        want = plain(q, s, *args_p, x.dtype)
        got_new, got_old = new(), old()
        torch.cuda.synchronize()
        if not (torch.equal(got_new, want) and torch.equal(got_old, want)):
            raise AssertionError(f"int8 kernels differ from the plain version at {key}: "
                                 f"new {torch.equal(got_new, want)}, "
                                 f"old {torch.equal(got_old, want)}")
        t = [cs.cuda_ms(f, ITERS) for f in (old, new, new, old)]
        _, bound, by = cs._int8_bounds(mod, x, want.numel())
        lib_ms = None
        if not mod.depthwise and mod.kernel_size == (1, 1) and mod.stride == (1, 1):
            m, c = x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
            if m > 16 and c % 8 == 0 and mod.out_channels % 8 == 0:
                a2 = q.permute(0, 2, 3, 1).reshape(m, c)
                b2 = mod.w_packed[:, :c].contiguous().t()
                lib_ms = cs.cuda_ms(lambda: torch._int_mm(a2, b2), ITERS)
        kind = "int8_conv_depthwise" if mod.depthwise else "int8_conv_dense"
        plan = (cuda_int8.plan_depthwise(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                                         mod.kernel_size, mod.stride, mod.padding, x.dtype)
                if mod.depthwise else
                cuda_int8.plan_dense(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                                     mod.out_channels, mod.kernel_size, mod.stride,
                                     mod.padding, x.dtype))
        rows[key] = {"kernel": kind, "shape": list(x.shape), "cout": mod.out_channels,
                     "ksize": list(mod.kernel_size), "stride": list(mod.stride),
                     "bias": mod.bias is not None, "variant": plan.variant,
                     "old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]], "bound_ms": bound,
                     "bound_by": by, "int_mm_ms": lib_ms}
        cs.log(f"ab {kind} {tuple(x.shape)}->{mod.out_channels} {mod.kernel_size} "
               f"s{mod.stride[0]} [{plan.variant}]: old {t[0]:.4f}/{t[3]:.4f} new "
               f"{t[1]:.4f}/{t[2]:.4f} ms, bound {bound:.4f} ({by})"
               + (f", _int_mm {lib_ms:.4f}" if lib_ms is not None else ""))

    hooks = [m.register_forward_pre_hook(hook) for m in pred.model.modules()
             if isinstance(m, quant.Int8Conv2d)]
    try:
        with torch.inference_mode():
            pred.forward(x0)
    finally:
        for h in hooks:
            h.remove()
    for key, r in rows.items():
        r["calls"] = calls[key]
    return list(rows.values())


def totals(rows, card: str):
    out = {}
    for kind in ("int8_conv_dense", "int8_conv_depthwise"):
        rs = [r for r in rows if r["kernel"] == kind]
        t = {"calls": sum(r["calls"] for r in rs),
             "bound_ms": sum(r["calls"] * r["bound_ms"] for r in rs),
             "old_ms": [sum(r["calls"] * r["old_ms"][i] for r in rs) for i in (0, 1)],
             "new_ms": [sum(r["calls"] * r["new_ms"][i] for r in rs) for i in (0, 1)],
             "slower": [(r["shape"], r["cout"], r["ksize"], r["stride"])
                        for r in rs if min(r["new_ms"]) > max(r["old_ms"])]}
        mm = [r for r in rs if r["int_mm_ms"] is not None]
        if mm:
            t["int_mm_ms"] = sum(r["calls"] * r["int_mm_ms"] for r in mm)
            t["ms_1x1_old"] = [sum(r["calls"] * r["old_ms"][i] for r in mm) for i in (0, 1)]
            t["ms_1x1_new"] = [sum(r["calls"] * r["new_ms"][i] for r in mm) for i in (0, 1)]
        worst = sorted(rs, key=lambda r: -r["calls"] * max(r["old_ms"]))[:5]
        t["worst_old"] = [(r["shape"], r["cout"], r["ksize"], r["stride"], r["calls"],
                           r["old_ms"], r["new_ms"], r["bound_ms"]) for r in worst]
        out[kind] = t
        cs.log(f"ab sum {kind} over {t['calls']} calls a b{cs.BATCH} forward: old "
               f"{t['old_ms'][0]:.3f}/{t['old_ms'][1]:.3f} ms, new {t['new_ms'][0]:.3f}/"
               f"{t['new_ms'][1]:.3f} ms, bound {t['bound_ms']:.3f} ms"
               + (f"; 1x1 calls old {t['ms_1x1_old'][0]:.3f}/{t['ms_1x1_old'][1]:.3f}, new "
                  f"{t['ms_1x1_new'][0]:.3f}/{t['ms_1x1_new'][1]:.3f}, torch._int_mm "
                  f"{t['int_mm_ms']:.3f}" if mm else "")
               + f"; new slower than old at {len(t['slower'])} calls [{card}]")
    return out


def graph_turns(parent: str, card: str):
    """bf16 and int8 graph ms and img/s of the parent tree and this one, one
    process each, parent / change / change / parent."""
    res = []
    for label, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        r = subprocess.run([sys.executable, "-c", GRAPH_RUN], cwd=tree, capture_output=True,
                           text=True, timeout=900)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB_RESULT ")]
        if r.returncode or not line:
            raise RuntimeError(f"{label} graph run failed ({r.returncode}):\n"
                               f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        out = json.loads(line[0][len("AB_RESULT "):])
        out["tree"] = label
        res.append(out)
        ips = out["img_s"]
        cs.log(f"ab graph {label}: bf16 {out['bf16_graph_ms']:.3f} ms, int8 "
               f"{out['int8_graph_ms']:.3f} ms; img/s device bf16 "
               f"{', '.join(f'{v:.1f}' for v in ips['bf16']['device'])} int8 "
               f"{', '.join(f'{v:.1f}' for v in ips['int8']['device'])}; host bf16 "
               f"{', '.join(f'{v:.1f}' for v in ips['bf16']['host'])} int8 "
               f"{', '.join(f'{v:.1f}' for v in ips['int8']['host'])} [{out['card']}]")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="the older csrc/int8_conv.cu")
    ap.add_argument("--parent", help="a checkout of the older tree for the graph turns")
    args = ap.parse_args()
    card = cs.phase_device()
    cs.phase_build()
    lib = load_old(args.old)
    rows = ab_calls(lib, card)
    out = {"card": card, "rows": rows, "totals": totals(rows, card)}
    torch.cuda.empty_cache()
    if args.parent:
        out["graphs"] = graph_turns(os.path.abspath(args.parent), card)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    cs.log(f"wrote {OUT}")


if __name__ == "__main__":
    main()
