"""The port's span recorder (``clipx_torch/utils/profiling.py``) and the
spans at its layer boundaries, on the CPU.

Spans record only inside a ``torch.profiler`` session: with none, ``span``
hands out one shared no-op context. Inside one they nest by thread, share
their root's id, carry ``n``, stop at the cap, and ``device_trace`` writes
them into its ``trace.json`` on the profiler's timestamps. The encoder's
batch enqueue records ``encoder.stage`` then ``encoder.launch``; a search
through the service records ``serve.search`` around ``index.search`` and
then ``serve.answer``.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clipx_torch import serve as tserve
from clipx_torch.runtime.encoder import Encoder
from clipx_torch.search.engine import IndexWriter
from clipx_torch.utils import profiling

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

DIM = 32  # tiny-test's embedding width
K = 5


def _session():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def encoder():
    return Encoder.create("tiny-test", device="cpu", batch_buckets=(1, 4))


@pytest.fixture
def service(tmp_path, monkeypatch, encoder):
    """The service over a 64-row pq library (an empty store: every lookup
    misses), coalescers off, as the text-query cell runs it."""
    monkeypatch.setenv("CLIPX_SERVE_COALESCE", "0")
    rows = np.random.default_rng(0).standard_normal((64, DIM))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index = str(tmp_path / "images.index")
    w = IndexWriter(index, rows.shape[0], DIM)
    w.write(rows)
    w.close()
    args = tserve.build_parser().parse_args([
        "--model", "tiny-test", "--db", str(tmp_path / "db"), "--index",
        index, "--corpus-dtype", "pq", "--device", "cpu", "--sharded", "off",
        "--port", "0", "--no-warmup"])
    svc = tserve.SearchService(args, encoder=encoder)
    yield svc
    svc.close()
    svc.env.close()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_profiler_flag_follows_every_session():
    """The switch ``span`` reads: torch's module flag, set while any
    torch.profiler session records and cleared after."""
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False
    with _session():
        assert flag._is_profiler_enabled is True
    assert flag._is_profiler_enabled is False
    with torch.autograd.profiler.profile():
        assert flag._is_profiler_enabled is True
    assert flag._is_profiler_enabled is False


def test_no_session_records_nothing(encoder, service):
    off = profiling.span("a", 3)
    assert off is profiling.span("b")
    with off as entered:
        assert entered is None
    encoder.finalize(encoder.encode_images_async(
        np.zeros((2, 32, 32, 3), np.uint8)))
    feats = service.encode_texts(["a red photo"])
    service.search(feats, K)
    assert profiling.recorded_spans() == []
    assert profiling.dropped_spans() == 0


def test_spans_nest_and_share_their_root():
    with _session():
        with profiling.span("outer", 7):
            with profiling.span("mid") as mid:
                with profiling.span("inner", 2):
                    pass
                mid.n = 4
        with profiling.span("second"):
            pass
    spans = _by_name(profiling.recorded_spans())
    outer, mid = spans["outer"][0], spans["mid"][0]
    inner, second = spans["inner"][0], spans["second"][0]
    assert (outer.parent, outer.root) == (0, outer.id)
    assert (mid.parent, mid.root) == (outer.id, outer.id)
    assert (inner.parent, inner.root) == (mid.id, outer.id)
    assert (second.parent, second.root) == (0, second.id)
    assert len({outer.id, mid.id, inner.id, second.id}) == 4
    assert [outer.n, mid.n, inner.n, second.n] == [7, 4, 2, 0]
    assert outer.start_ns <= mid.start_ns <= inner.start_ns
    assert inner.end_ns <= mid.end_ns <= outer.end_ns <= second.start_ns
    assert len({s.thread for s in profiling.recorded_spans()}) == 1


def test_threads_keep_their_stacks_apart():
    """Two threads open their spans in turns: each inner span's parent is
    its own thread's outer span."""
    step = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span("outer." + tag):
            step.wait()  # both outer spans are open
            with profiling.span("inner." + tag):
                step.wait()  # both inner spans are open

    with _session():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in profiling.recorded_spans()}
    assert len(spans) == 4
    for tag in "ab":
        outer, inner = spans["outer." + tag], spans["inner." + tag]
        assert (inner.parent, inner.root) == (outer.id, outer.id)
        assert inner.thread == outer.thread
    assert spans["outer.a"].thread != spans["outer.b"].thread


def test_cap_counts_what_it_drops():
    rec = profiling.SpanRecorder(cap=3)
    with _session():
        for i in range(5):
            with rec.span("s", i):
                pass
    assert [s.n for s in rec.records()] == [0, 1, 2]
    assert rec.dropped() == 2
    rec.clear()
    assert rec.records() == [] and rec.dropped() == 0
    assert profiling.SPAN_CAP == 1 << 20
    assert profiling.RECORDER.cap == profiling.SPAN_CAP


def test_encoder_stage_then_launch(encoder):
    batch = np.random.default_rng(1).integers(0, 255, (3, 32, 32, 3),
                                              dtype=np.uint8)
    with _session():
        handle = encoder.encode_images_async(batch)
        encoder.encode_texts(["a cat", "a dog"])
    emb = encoder.finalize(handle)
    np.testing.assert_array_equal(emb, encoder.encode_images(batch))
    spans = profiling.recorded_spans()
    assert [s.name for s in spans] == ["encoder.stage", "encoder.launch",
                                       "encoder.encode_texts"]
    stage, launch, text = spans
    assert stage.end_ns <= launch.start_ns
    assert stage.parent == launch.parent == 0 and stage.root != launch.root
    assert (stage.n, launch.n, text.n) == (3, 3, 2)


def test_service_search_spans(service):
    feats = service.encode_texts(["a red photo"])
    with _session():
        res = service.search(feats, K)
    assert len(res["results"]) == K
    spans = _by_name(profiling.recorded_spans())
    assert sorted(spans) == ["index.search", "serve.answer", "serve.search"]
    whole, idx = spans["serve.search"][0], spans["index.search"][0]
    answer = spans["serve.answer"][0]
    assert (whole.parent, whole.root, whole.n) == (0, whole.id, 1)
    assert (idx.parent, idx.root, idx.n) == (whole.id, whole.id, 1)
    assert (answer.parent, answer.root, answer.n) == (whole.id, whole.id, K)
    assert whole.start_ns <= idx.start_ns <= idx.end_ns <= answer.start_ns
    assert answer.end_ns <= whole.end_ns


def test_device_trace_writes_spans_on_the_trace_clock(tmp_path):
    """A span around ``torch.mm`` contains the op's event; a span of an
    earlier session stays out of the file."""
    a = torch.randn(256, 256)
    with _session():
        with profiling.span("before"):
            pass
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("mm", 1):
            torch.mm(a, a)
    assert [s.name for s in profiling.recorded_spans()] == ["before", "mm"]
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    (mm_op,) = [e for e in events if e.get("name") == "aten::mm"]
    assert [s["name"] for s in spans] == ["mm"]
    span = spans[0]
    assert span["pid"] != mm_op["pid"] and span["args"]["n"] == 1
    assert span["ts"] <= mm_op["ts"]
    assert mm_op["ts"] + mm_op["dur"] <= span["ts"] + span["dur"]
