"""The harness on the CPU at a tiny size: cells, configurations, traffic,
drivers and metrics found by name as files alone; the result line; the
command's refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT, write

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
                 "checks"}


def _run(root, workload, trace=False, seconds=0.5, seed=2 ** 31 + 12345):
    return harness.run_cell(workload, seed, seconds, trace,
                            device=torch.device("cpu"),
                            started=time.perf_counter(), root=root)


@pytest.mark.parametrize("workload",
                         ["tiny-index", "tiny-query-pq", "tiny-query-co"])
def test_cell_added_as_files_runs_and_is_correct(tiny_root, workload):
    out, notes = _run(tiny_root, workload)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    e2e = {"tiny-index": "index_img_per_s.b32", "tiny-query-pq": "query_qps",
           "tiny-query-co": "query_qps"}
    assert set(out["metrics"]) == {"setup_s", e2e[workload]}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert "setup_stages" in notes
    # the plain versions on the CPU launch no kernel
    assert notes["launches"] == {}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys_only(tiny_root, trace):
    out, _ = _run(tiny_root, "tiny-index", trace=trace)
    assert set(out) == CONTRACT_KEYS
    # the numbers compared, each beside its limit, come last
    assert list(out)[-1] == "checks"
    assert set(out["checks"]["emb_gap"]) == {"value", "limit"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.loads(json.dumps(out, allow_nan=False))


@pytest.mark.parametrize("workload", ["tiny-query-pq", "tiny-query-co"])
def test_traced_run_reports_the_per_layer_metrics_it_can_read(tiny_root,
                                                              workload):
    out, _ = _run(tiny_root, workload, trace=True)
    # no device trace on the CPU: the device metrics are left out, the
    # host's and the program's counters are read
    assert set(out["metrics"]) == {"mfu.query", "query_p95_ms.closed"}
    assert out["metrics"]["query_p95_ms.closed"]["value"] > 0


def test_metric_and_driver_added_as_files(tiny_root):
    """A later change adds a driver, a traffic mix, a cell and a per-layer
    metric as new files and entries, editing no file the harness has."""
    bench_dir = os.path.join(tiny_root, "benchmark")
    shutil.copy(os.path.join(bench_dir, "drivers", "encode_stream.py"),
                os.path.join(bench_dir, "drivers", "encode_stream_b.py"))
    write(os.path.join(bench_dir, "traffic", "tiny-encode-b.json"),
          {"driver": "encode_stream_b", "batch": 8, "depth": 1,
           "pool_batches": 2})
    write(os.path.join(bench_dir, "limits", "tiny-index-b.json"),
          {"emb_gap": 1e-4})
    with open(os.path.join(bench_dir, "metrics", "batches.index.py"),
              "w") as f:
        f.write("def read(run):\n    return float(run.notes['batches'])\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny-index-b", "config": "tiny",
                               "traffic": "tiny-encode-b", "chips": 1,
                               "why": "tests"})
    bench["end_to_end"].append({"name": "index_img_per_s.tiny_b",
                                "unit": "img/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-index-b"]})
    bench["per_layer"].append({"name": "batches.index", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "encoder",
                               "moves": "index_img_per_s.tiny_b",
                               "workloads": ["tiny-index-b"]})
    write(path, bench)
    out, notes = _run(tiny_root, "tiny-index-b", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["batches.index"]["value"] == notes["batches"] > 0
    out, _ = _run(tiny_root, "tiny-index-b")
    assert set(out["metrics"]) == {"setup_s", "index_img_per_s.tiny_b"}


def test_same_seed_same_inputs(tiny_root):
    from benchmark import corpus, weights

    cfg = harness.load_json(tiny_root, "benchmark", "configs", "tiny.json")
    a = weights.make_params(cfg, 2 ** 31 + 7, "cpu")
    b = weights.make_params(cfg, 2 ** 31 + 7, "cpu")
    c = weights.make_params(cfg, 2 ** 31 + 8, "cpu")
    wa, wb, wc = (t["visual"]["blocks"]["mlp"]["w1"] for t in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert corpus.prompts(5, 8, [3, 9], [3, 7]) == corpus.prompts(
        5, 8, [3, 9], [3, 7])
    x = corpus.pq_library(9, 64, 32, 2, "cpu")
    y = corpus.pq_library(9, 64, 32, 2, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(x, y))


def _command(cwd, *args, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_command_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    res = _command(ROOT, "--workload", "index-b32", "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert res.returncode != 0 and res.stdout == ""


def test_command_ignores_bench_run(tiny_root):
    """BENCH_RUN in the environment changes nothing of a run."""
    env = dict(os.environ, BENCH_RUN="anything")
    res = subprocess.run(
        [sys.executable, "-c",
         "import time, torch; from benchmark import harness; "
         "out, _ = harness.run_cell('tiny-index', 3, 0.3, False, "
         f"device=torch.device('cpu'), started=time.perf_counter(), "
         f"root={tiny_root!r}); print(out['correct'], out['checks'])"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("True")


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, a run
    finds no program and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c",
         "import time, torch; from benchmark import harness; "
         "harness.run_cell('index-b32', 1, 1.0, False, "
         "device=torch.device('cpu'), started=time.perf_counter())"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0
    assert "clipx_torch" in res.stderr and res.stdout == ""
    res = _command(tmp_path, "--workload", "index-b32", "--seed", "1",
                   "--seconds", "1", "--trace", "0", env=env)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of each cell on the card (run with ``-m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for workload in ("index-b32", "index-l14-336", "query-b32-pq"):
        res = _command(ROOT, "--workload", workload, "--seed",
                       str(2 ** 31 + 99), "--seconds", "2", "--trace", "1")
        assert res.returncode == 0, res.stderr[-2000:]
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["correct"] is True
        assert out["device"]["busy_s"] > 0


def test_traffic_environment_is_restored(tiny_root, monkeypatch):
    monkeypatch.delenv("CLIPX_SERVE_COALESCE", raising=False)
    _run(tiny_root, "tiny-query-pq")
    assert "CLIPX_SERVE_COALESCE" not in os.environ
