"""A/B of the int8 quantize on one NVIDIA card: this tree's `int8_quantize`
(csrc/int8_conv.cu, one cooperative launch) against an older build of the
same file (a memset, a max pass and a quantize pass), at every distinct quantized
input of the edge_n @640 b128 bf16 int8 forward, in turns (old, new, new,
old); with --parent, the bf16 and int8 serving graphs of an older checkout
against this tree's, one process each, in turns (parent, change, change,
parent).

    mkdir -p build/int8_ab/parent
    git show <commit>:yololite_tpu_torch/csrc/int8_conv.cu > build/int8_ab/int8_conv_old.cu
    git archive <commit> | tar -x -C build/int8_ab/parent
    python3 chip_int8_ab.py --old build/int8_ab/int8_conv_old.cu --parent build/int8_ab/parent

The old file must have the quantize's C interface before the launch plan
(`yl_int8_quantize(x, in_type, n, scratch, q, s, stream)`, a 4-byte
scratch), and its output must equal the plain version as the new one's
must: a call where either differs fails the run. Per distinct input it
prints both kernels' ms in each turn beside the bytes bound and, as a
yardstick for the max pass alone, `torch.linalg.vector_norm(x, inf)` (one
read of x; the port never calls it); then the sums over one forward (each
distinct input times its calls a forward) and the inputs where the new
kernel is slower than the old in both turns. Writes chiprun_out/int8_ab.json.
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
    ptr = ctypes.c_void_p
    lib.yl_int8_quantize.argtypes = [ptr, ctypes.c_int, ctypes.c_longlong] + [ptr] * 4
    lib.yl_int8_quantize.restype = ctypes.c_int
    return lib


def old_quantize(lib, x):
    """The old kernels' launch: a memset of the 4-byte atomic max, then the
    max and quantize passes."""
    q = torch.empty_like(x, dtype=torch.int8, memory_format=torch.channels_last)
    s = torch.empty(1, dtype=torch.float32, device=x.device)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device)
    err = lib.yl_int8_quantize(x.data_ptr(), cuda_int8._IN_TYPES[x.dtype], x.numel(),
                               scratch.data_ptr(), q.data_ptr(), s.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old int8_quantize: CUDA error {err}")
    return q, s


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
        key = (tuple(x.shape), str(x.dtype))
        calls[key] = calls.get(key, 0) + 1
        if key in rows:
            return
        want = cuda_int8.quantize_reference(x)
        got_new, got_old = cuda_int8.quantize(x), old_quantize(lib, x)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for got in (got_new, got_old) for a, b in zip(got, want)]
        if not all(same):
            raise AssertionError(f"quantize differs from the plain version at {key}: "
                                 f"(x_q, s_x) new {same[:2]}, old {same[2:]}")
        new = lambda: cuda_int8.quantize(x)                    # noqa: E731
        old = lambda: old_quantize(lib, x)                     # noqa: E731
        t = [cs.cuda_ms(f, ITERS) for f in (old, new, new, old)]
        norm = cs.cuda_ms(lambda: torch.linalg.vector_norm(x, float("inf")), ITERS)
        bound = (x.numel() * (x.element_size() + 1) + 4) / cs.PEAK_BYTES_S * 1e3
        plan = cuda_int8.quantize_plan(x)
        rows[key] = {"shape": list(x.shape), "dtype": str(x.dtype), "route": plan.route,
                     "grid": plan.grid, "vec": plan.vec, "block_elems": plan.block_elems,
                     "old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]], "bound_ms": bound,
                     "vector_norm_ms": norm}
        cs.log(f"ab quantize {tuple(x.shape)} [{plan.route}, grid {plan.grid}, vec "
               f"{plan.vec}, {plan.block_elems} elements a block]: old {t[0]:.4f}/{t[3]:.4f} "
               f"new {t[1]:.4f}/{t[2]:.4f} ms; bound {bound:.4f} (bytes); "
               f"vector_norm(inf) {norm:.4f} (yardstick: the max pass alone)")

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
    t = {"calls": sum(r["calls"] for r in rows)}
    for k in ("bound_ms", "vector_norm_ms"):
        t[k] = sum(r["calls"] * r[k] for r in rows)
    for k in ("old_ms", "new_ms"):
        t[k] = [sum(r["calls"] * r[k][i] for r in rows) for i in (0, 1)]
    t["slower"] = [r["shape"] for r in rows if min(r["new_ms"]) > max(r["old_ms"])]
    cs.log(f"ab sum int8_quantize over {t['calls']} calls a b{cs.BATCH} forward: old "
           f"{t['old_ms'][0]:.3f}/{t['old_ms'][1]:.3f} ms, new {t['new_ms'][0]:.3f}/"
           f"{t['new_ms'][1]:.3f} ms, bound {t['bound_ms']:.3f} ms, vector_norm(inf) "
           f"{t['vector_norm_ms']:.3f} ms (the max pass alone); new slower than old at "
           f"{len(t['slower'])} inputs {t['slower']} [{card}]")
    return t


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
