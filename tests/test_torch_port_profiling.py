"""PyTorch port parity: `yololite_tpu_torch/utils/profiling.py` against the
JAX package's `utils/profiling.py` (the StageTimer's report, equal on the
same samples), the profiler trace it writes, and the training loop's
`profile` flag (a trace of batches 3-7 of epoch 1, closed at that epoch's
end when it has fewer batches), on the CPU."""

import glob
import json
import os

import pytest
import torch

from yololite_tpu.utils.profiling import StageTimer as JaxStageTimer

import chip_smoke
import yololite_tpu_torch.utils as port_utils
from yololite_tpu_torch.api import YoloLite
from yololite_tpu_torch.utils.profiling import StageTimer, trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these small CPU runs: the test files run in
    parallel processes, and torch's default of one thread a core in each of
    them oversubscribes the machine (this file's runs took 50-100x longer
    so in a 4-process run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_utils_exports_only_the_profiling_names():
    """The package exports what JAX's `utils` exports: the profiling names
    and, since utils/viz.py was ported, the drawing helpers."""
    import yololite_tpu.utils as jax_utils
    assert port_utils.__all__ == jax_utils.__all__
    assert {"trace", "StageTimer"} <= set(port_utils.__all__)


def test_stage_timer_report_equals_jax():
    samples = {"pre": [1.5, 2.25, 0.75, 9.0, 3.0], "graph": [12.0], "post": [0.1, 0.3]}
    port, ref = StageTimer(), JaxStageTimer()
    for t in (port, ref):
        t.samples = {k: list(v) for k, v in samples.items()}
    assert port.report() == ref.report()
    with port.time("pre"):
        pass
    assert port.report()["pre"]["n"] == 6 and port.samples["pre"][-1] >= 0


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path)):
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    files = glob.glob(str(tmp_path / "profile" / "trace_*.json"))
    assert len(files) == 1
    assert any(e.get("name") == "aten::mm" for e in _events(files[0]))


def test_loop_profile_flag_writes_a_trace(tmp_path, capsys):
    """12 train images at batch 4: epoch 1 has 3 batches, so the trace opens
    before its 3rd batch and is closed at the epoch's end (JAX's would stay
    open); one trace, printed once, holding that batch's train step."""
    data = chip_smoke.make_synth_set(str(tmp_path / "s"), 12, 4, w=80, h=60)
    res = YoloLite("edge_n", device="cpu").train(
        data=data, epochs=2, batch_size=4, img_size=64, workers=0,
        run_dir=str(tmp_path / "runs"), profile=True)
    out = capsys.readouterr().out
    prof = os.path.join(res["log_dir"], "profile")
    assert out.count(f"[profile] trace saved to {prof}") == 1
    files = glob.glob(os.path.join(prof, "trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in _events(files[0])}
    assert "aten::convolution" in names and "aten::convolution_backward" in names
