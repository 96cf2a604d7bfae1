"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary root, with a tiny configuration and tiny traffic added as files,
as a later change would add them."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "name": "tiny-test",
    "source": "https://github.com/openai/CLIP/blob/main/clip/model.py",
    "reduced": ["vision", "text"],
    "vision": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2,
               "heads": 2, "embed_dim": 32},
    "text": {"context_length": 77, "vocab_size": 49408, "width": 32,
             "layers": 2, "heads": 2, "embed_dim": 32},
    "quick_gelu": True,
    "layernorm_eps": 1e-05,
    "image_mean": [0.48145466, 0.4578275, 0.40821073],
    "image_std": [0.26862954, 0.26130258, 0.27577711],
}
TRAFFIC = {
    "tiny-encode": {"driver": "encode_stream", "batch": 8, "depth": 2,
                    "pool_batches": 3, "reference_chunk": 8},
    # the query cell's traffic (one client, coalescers off) ...
    "tiny-query": {"driver": "query_closed", "clients": 1, "k": 10,
                   "rows": 8192, "dsub": 2, "prompt_pool": 64,
                   "words": [3, 9], "letters": [3, 7],
                   "env": {"CLIPX_SERVE_WARMUP_K": "10",
                           "CLIPX_SERVE_COALESCE": "0"}},
    # ... and the same driver with clients sharing the coalescers
    "tiny-query-co": {"driver": "query_closed", "clients": 3, "k": 10,
                      "rows": 8192, "dsub": 2, "prompt_pool": 64,
                      "words": [3, 9], "letters": [3, 7],
                      "env": {"CLIPX_SERVE_WARMUP_K": "10"}},
}
# on the CPU the port computes in f32: its gaps to the f32 reference are
# rounding, far under these
LIMITS = {"tiny-index": {"emb_gap": 1e-4},
          "tiny-query-pq": {"text_gap": 1e-4, "score_gap": 1e-5},
          "tiny-query-co": {"text_gap": 1e-4, "score_gap": 1e-5}}


def write(path, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A root holding a copy of BENCHMARK.json and benchmark/, plus the
    tiny configuration, two tiny traffic mixes, their cells and limits."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": TINY["source"],
                             "file": "benchmark/configs/tiny.json",
                             "reduced": TINY["reduced"], "why": "tests"})
    bench["workloads"] += [
        {"name": "tiny-index", "config": "tiny", "traffic": "tiny-encode",
         "chips": 1, "why": "tests"},
        {"name": "tiny-query-pq", "config": "tiny", "traffic": "tiny-query",
         "chips": 1, "why": "tests"},
        {"name": "tiny-query-co", "config": "tiny", "traffic": "tiny-query-co",
         "chips": 1, "why": "tests"}]
    # the tiny cells report what the ViT-B/32 cells report
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "index-b32" in m.get("workloads", []):
            m["workloads"].append("tiny-index")
        if "query-b32-pq" in m.get("workloads", []):
            m["workloads"] += ["tiny-query-pq", "tiny-query-co"]
    write(str(root / "BENCHMARK.json"), bench)
    write(str(root / "benchmark" / "configs" / "tiny.json"), TINY)
    for name, traffic in TRAFFIC.items():
        write(str(root / "benchmark" / "traffic" / f"{name}.json"), traffic)
    for name, limits in LIMITS.items():
        write(str(root / "benchmark" / "limits" / f"{name}.json"), limits)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    monkeypatch.setenv("CLIPX_BPE_PATH", "")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return str(root)
