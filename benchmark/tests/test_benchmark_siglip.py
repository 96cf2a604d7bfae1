"""The SigLIP cell's pieces on the CPU: each new reader's exact value on a
made-up run (None where there is nothing to read), a tiny SigLIP cell run
whole through the harness, and planted faults in the program (QuickGELU for
the tanh GELU, a causal text mask, the pooling head's MLP dropped, a class
token added) that each read over the tiny cell's limit, as the altered
answers of ``test_benchmark_control.py`` do; the control reads over the
committed limit of ``index-so400m``."""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control_siglip, counts, counts_siglip, harness
from benchmark.checks import embedding_gap
from benchmark.harness import ROOT, load_json, load_module
from benchmark.tests.conftest import write
from benchmark.trace import Trace
from clipx_torch.utils import profiling

TINY_SIGLIP = {
    "name": "tiny-siglip",
    "source": "https://huggingface.co/google/siglip-so400m-patch14-384/blob/main/config.json",
    "reduced": ["vision", "text"],
    "vision": {"image_size": 60, "patch_size": 14, "width": 144, "layers": 2,
               "heads": 2, "embed_dim": 144, "mlp_dim": 200,
               "class_token": False, "ln_pre": False, "patch_bias": True,
               "pool": "map"},
    "text": {"context_length": 16, "vocab_size": 512, "width": 144,
             "layers": 2, "heads": 2, "embed_dim": 144, "mlp_dim": 200,
             "causal": False, "pool": "last"},
    "quick_gelu": False, "activation": "gelu_tanh", "layernorm_eps": 1e-06,
    "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5],
    "center_crop": False, "logit_bias": True, "tokenizer": "sentencepiece",
}
LIMIT = load_json(ROOT, "benchmark", "limits", "index-so400m.json")["emb_gap"]
# on the CPU the port computes in f32: its gaps to the f32 reference are
# rounding, far under this (conftest's limit of the tiny CLIP cell)
TINY_LIMIT = 1e-4
SO400M = load_json(ROOT, "benchmark", "configs", "siglip-so400m-14-384.json")


@pytest.fixture
def siglip_root(tiny_root):
    """``tiny_root`` plus a tiny SigLIP cell, ``tiny-so400m``, reporting
    what ``index-so400m`` reports."""
    bench = load_json(tiny_root, "BENCHMARK.json")
    bench["configs"].append({"name": "tiny-siglip",
                             "source": TINY_SIGLIP["source"],
                             "file": "benchmark/configs/tiny-siglip.json",
                             "reduced": TINY_SIGLIP["reduced"],
                             "why": "tests"})
    bench["workloads"].append({"name": "tiny-so400m", "config": "tiny-siglip",
                               "traffic": "tiny-siglip-encode", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "index-so400m" in m.get("workloads", []):
            m["workloads"].append("tiny-so400m")
    write(f"{tiny_root}/BENCHMARK.json", bench)
    write(f"{tiny_root}/benchmark/configs/tiny-siglip.json", TINY_SIGLIP)
    write(f"{tiny_root}/benchmark/traffic/tiny-siglip-encode.json",
          {"driver": "encode_siglip", "batch": 4, "depth": 2,
           "pool_batches": 2, "reference_chunk": 4})
    write(f"{tiny_root}/benchmark/limits/tiny-so400m.json",
          {"emb_gap": TINY_LIMIT})
    return tiny_root


def _run(root, seed=2 ** 31 + 7):
    out, _ = harness.run_cell("tiny-so400m", seed, 0.3, False,
                              device=torch.device("cpu"),
                              started=time.perf_counter(), root=root)
    return out


def test_tiny_cell_runs_correct(siglip_root):
    out = _run(siglip_root)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "index_img_per_s.l14_336"}


def _quick_gelu(monkeypatch):
    from clipx_torch.models import layers

    monkeypatch.setattr(layers, "_activation",
                        lambda h, act: layers.quick_gelu(h))


def _head_mlp_dropped(monkeypatch):
    from clipx_torch.models import clip

    real = clip.map_head

    def map_head(x, p, heads, **kw):
        none = {k: torch.zeros_like(v) for k, v in p["mlp"].items()}
        return real(x, dict(p, mlp=none), heads, **kw)

    monkeypatch.setattr(clip, "map_head", map_head)


def _class_token_added(monkeypatch):
    from clipx_torch.models import clip

    real = clip.transformer

    def transformer(x, stacked, heads, **kw):
        x = torch.cat([torch.zeros_like(x[:, :1]), x], dim=1)
        return real(x, stacked, heads, **kw)[:, 1:]

    monkeypatch.setattr(clip, "transformer", transformer)


@pytest.mark.parametrize("fault", [_quick_gelu, _head_mlp_dropped,
                                   _class_token_added])
def test_an_image_tower_fault_is_not_correct(siglip_root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(siglip_root)
    c = out["checks"]["emb_gap"]
    assert out["correct"] is False and c["value"] > c["limit"] == TINY_LIMIT


def test_a_causal_text_mask_reads_over_the_tiny_limit():
    from benchmark import weights_siglip
    from benchmark.reference.siglip import encode_texts
    from clipx_torch.models import clip

    driver = load_module(ROOT, "drivers", "encode_siglip")
    cfg = driver.program_config(TINY_SIGLIP)
    params = weights_siglip.make_params(TINY_SIGLIP, 3, "cpu")
    ids = torch.randint(0, 512, (16, 16),
                        generator=torch.Generator().manual_seed(3))
    want = encode_texts(params, TINY_SIGLIP, ids).numpy()
    got = clip.encode_text(params, cfg, ids, normalize=True).numpy()
    assert embedding_gap(got, want) < TINY_LIMIT
    causal = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                               causal=True))
    got = clip.encode_text(params, causal, ids, normalize=True).numpy()
    assert embedding_gap(got, want) > TINY_LIMIT


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11])
def test_control_reads_above_the_committed_limit(siglip_root, seed):
    got = control_siglip.readings("tiny-so400m", seed, torch.device("cpu"),
                                  root=siglip_root)
    assert got["emb_gap"] > LIMIT


# -- the readers on a made-up run -------------------------------------------

T0 = 100.0
B8_NAME = "void clipx::sm90::sdpa_sm90_kernel<72>(CUtensorMap_st, ...)"


def _trace(events, start=0.0, stop=10.0):
    t = Trace.__new__(Trace)
    t.start, t.stop_at, t.events = start, stop, events
    return t


def _made_up_run(trace=True, rate=300.0, launches=27 * 24):
    events = [(B8_NAME, 0.5, 2.0), ("nvjet_gemm", 3.0, 6.0)]
    return SimpleNamespace(
        trace=_trace(events) if trace else None, t0=T0,
        config=SO400M, traffic={"batch": 128},
        e2e={"index_img_per_s": rate} if rate else {},
        launches={"fused_sdpa_long": launches} if launches else {})


def _span(name, start, end, n):
    ns = lambda s: round((T0 + s) * 1e9)  # noqa: E731
    return profiling.SpanRecord(name, ns(start), ns(end), 0, 0, 0, 0, n)


def test_counts_at_the_published_shapes():
    v = SO400M["vision"]
    w, h, s = 1152, 4304, 729
    block = 2 * s * w * 4 * w + 4 * s * w * h + 4 * 16 * s * s * 72
    head = 4 * w * w + 4 * s * w * w + 4 * 16 * s * 72 + 4 * w * h
    flops = 2 * s * 588 * w + 27 * block + head
    assert counts_siglip.image_tower_flops(v) == flops
    assert 669e9 < flops < 671e9  # 670 GFLOP an image
    ops, nbytes = counts_siglip.fused_sdpa_long(128, 729, 16, 72)
    assert (ops, nbytes) == (4 * 128 * 16 * 729 ** 2 * 72,
                             4 * 128 * 729 * 1152 * 2)
    assert counts.bound_s(ops, nbytes) == pytest.approx(
        (3.1698e-4, "operations"), rel=1e-3)


def test_reader_values(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [
        _span("tower.map_head", -1.0, -0.5, 128),   # before the window
        _span("tower.map_head", 1.0, 1.0002, 128),
        _span("encoder.launch", 1.0, 1.3, 128),
        _span("tower.map_head", 2.0, 2.0004, 128)])
    run = _made_up_run()
    read = {m: load_module(ROOT, "metrics", m).read for m in (
        "mfu.so400m", "fused_sdpa_long_roofline.so400m", "idle_pct.so400m",
        "map_head_ms.so400m")}
    flops = counts_siglip.image_tower_flops(SO400M["vision"])
    assert read["mfu.so400m"](run) == pytest.approx(
        100 * flops * 300 / 989e12)
    ops = 4 * 128 * 16 * 729 ** 2 * 72
    assert read["fused_sdpa_long_roofline.so400m"](run) == pytest.approx(
        100 * 27 * 24 * (ops / 989e12) / 2.0)
    # busy [0.5, 2.5] and [3, 9] of [0, 10]
    assert read["idle_pct.so400m"](run) == pytest.approx(20.0)
    assert read["map_head_ms.so400m"](run) == pytest.approx(0.3, rel=1e-3)


def test_readers_read_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [])
    for metric, run in [
            ("mfu.so400m", _made_up_run(rate=None)),
            ("fused_sdpa_long_roofline.so400m", _made_up_run(trace=False)),
            ("fused_sdpa_long_roofline.so400m", _made_up_run(launches=0)),
            ("idle_pct.so400m", _made_up_run(trace=False)),
            ("map_head_ms.so400m", _made_up_run()),
            ("map_head_ms.so400m", _made_up_run(trace=False))]:
        assert load_module(ROOT, "metrics", metric).read(run) is None, metric
    # a program without the recorder (an older one)
    monkeypatch.delattr(profiling, "recorded_spans")
    assert load_module(ROOT, "metrics", "map_head_ms.so400m").read(
        _made_up_run()) is None


def test_benchmark_entries_are_appended():
    bench = load_json(ROOT, "BENCHMARK.json")
    assert bench["configs"][-1]["name"] == "siglip-so400m-14-384"
    assert bench["workloads"][-1] == {
        "name": "index-so400m", "config": "siglip-so400m-14-384",
        "traffic": "encode-siglip-b128-d2", "chips": 1,
        "why": bench["workloads"][-1]["why"]}
    # the cell reports the other card-bound index cell's metric (bound 0.01):
    # the end-to-end list gains no entry, only the cell in one workloads list
    assert [m["name"] for m in bench["end_to_end"]] == [
        "setup_s", "index_img_per_s.b32", "index_img_per_s.l14_336",
        "query_qps"]
    assert [m["name"] for m in bench["end_to_end"]
            if "index-so400m" in m.get("workloads", [])] == [
        "index_img_per_s.l14_336"]
    assert bench["end_to_end"][2]["workloads"] == [
        "index-l14-336", "index-so400m"]
    assert [m["name"] for m in bench["per_layer"][-4:]] == [
        "mfu.so400m", "fused_sdpa_long_roofline.so400m", "idle_pct.so400m",
        "map_head_ms.so400m"]
    assert np.all([m["workloads"] == ["index-so400m"]
                   and m["moves"] == "index_img_per_s.l14_336"
                   for m in bench["per_layer"][-4:]])
