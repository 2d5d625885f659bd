"""PyTorch port parity: `yololite_tpu_torch/tools/benchmark.py` against the
JAX package's `tools/benchmark.py`, on the CPU: the CSV header and rows in
the same layout (the same bytes for the same values), one run end to end on
a small synthetic set (train, val, the latency calls and the batched graph,
each reaching NMS as many times as on the card), and the zero row of a pair
that fails."""

import csv
import importlib.util
import os
import tempfile

import pytest
import torch

import chip_smoke
from yololite_tpu_torch.ops import cuda_nms
from yololite_tpu_torch.tools import benchmark

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_benchmark", os.path.join(ROOT, "tools", "benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JBENCH = _jax_tool()


def _jax_header():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "h.csv")
        JBENCH.init_csv(path)
        with open(path) as f:
            return next(csv.reader(f))


JBENCH_HEADER = _jax_header()


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


def test_csv_layout_equals_jax(tmp_path):
    rows = [["d/data.yaml", "edge_n", "0.5000", "0.2500", "0.6000", "7.88", "603", "3",
             "2026-01-02T03:04:05"],
            ["d/data.yaml", "edge_m", 0, 0, 0, 0, 0, 0, "2026-01-02T03:04:05"]]
    paths = {}
    for name, mod in (("port", benchmark), ("jax", JBENCH)):
        paths[name] = str(tmp_path / f"{name}.csv")
        mod.init_csv(paths[name])
        mod.init_csv(paths[name])            # a second call keeps the file
        for r in rows:
            mod.save_result(paths[name], r)
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    with open(paths["port"]) as f:
        assert next(csv.reader(f)) == benchmark.HEADER


@pytest.fixture
def counted_nms(monkeypatch):
    """CPU calls of the suppression op's plain version (one a graph call)."""
    calls = []
    real = cuda_nms.greedy_keep_reference

    def wrapped(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(cuda_nms, "greedy_keep_reference", wrapped)
    return calls


def test_benchmark_end_to_end_on_cpu(tmp_path, monkeypatch, counted_nms, capsys):
    data = chip_smoke.make_synth_set(str(tmp_path / "s"), 8, 4, w=80, h=60)
    monkeypatch.chdir(tmp_path)
    rows = benchmark.main(["--data", data, "--epochs", "1", "--batch_size", "4",
                           "--img_size", "64", "--bench_batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "FAILED" not in out and len(rows) == 1
    row = rows[0]
    assert row[:2] == [data, "edge_n"] and len(row) == len(JBENCH_HEADER)
    assert float(row[5]) > 0 and float(row[6]) > 0
    for v in row[2:5]:
        assert 0.0 <= float(v) <= 1.0 and v == f"{float(v):.4f}"
    # train: its val batch and the final evaluate_model; val(split="test")
    # (no test split: val); warmup + 50 latency calls; 3 + 10 graph calls
    assert len(counted_nms) == 2 + 1 + 1 + benchmark.LATENCY_CALLS + \
        benchmark.GRAPH_WARM + benchmark.GRAPH_TIMED
    with open(tmp_path / "benchmark_results.csv") as f:
        assert list(csv.reader(f)) == [JBENCH_HEADER, [str(v) for v in row]]


def test_failed_pair_writes_the_zero_row(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rows = benchmark.main(["--data", str(tmp_path / "missing.yaml"), "--models", "edge_n",
                           "--device", "cpu"])
    assert "FAILED: " in capsys.readouterr().out
    assert rows[0][:8] == [str(tmp_path / "missing.yaml"), "edge_n", 0, 0, 0, 0, 0, 0]

