"""The port's HTTP service (``clipx_torch/serve.py``) against clipx's.

Both packages index one fixture folder with ``--model tiny-test`` and a
checkpoint saved by ``clipx.models.convert.save_params``, each into its own
work directory, and serve it in-process on port 0 (the port with
``--device cpu``; clipx with ``--sharded off``, the single-device index the
port has). The same request sequence goes to both:

- results: the same ids, ranks and paths, scores within ``SCORE_TOL``
  (f32 summation order);
- embeddings: within ``EMB_TOL``, the tolerance of
  ``tests/test_torch_runtime.py``;
- errors: the same status codes and the same JSON;
- ``/metrics``: the same keys and the same counters after the sequence.

Then the scenarios of ``tests/test_serve.py`` run against the port
(coalescer, cold-shape gate, warm-up manifest both ways between the
packages, ``/reload`` in both modes beside clipx's answers, coded tiers,
IVF through one shared ``.ivf``, ``--compute int8``, SIGTERM), with the
port's refusals and the thread safety of the search's TF32 guard.
"""

import base64
import json
import os
import shutil
import signal
import sys
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clipx import config as jcfg
from clipx import serve as jserve
from clipx.cli import build_index as jbuild
from clipx.models import clip as jclip
from clipx.models import convert as jconvert
from clipx_torch import serve as tserve
from clipx_torch.cli import build_index as tbuild
from clipx_torch.runtime import device as tdev
from clipx_torch.search import engine as teng

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

SCORE_TOL = 1e-4
EMB_TOL = 1e-5
DIM = 32  # tiny-test's embedding width
PHOTOS = ["a.jpg", "b.jpg", "c.png", "d.jpeg", "e.jpg"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    jconvert.save_params(path, jclip.init_params(
        jcfg.get_config("tiny-test"), jax.random.PRNGKey(0)))
    return path


def _save_photos(folder, names, seed):
    folder.mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)
                        ).save(folder / name)


def _flags(pkg, work, ckpt, *extra):
    flags = ["--model", "tiny-test", "--checkpoint", ckpt,
             "--db", str(work / "vectors.lmdb"),
             "--index", str(work / "images.index"), *extra]
    return flags + (["--device", "cpu"] if pkg == "port" else [])


def _build(pkg, photos, work, ckpt, *extra):
    work.mkdir(exist_ok=True)
    main = jbuild.main if pkg == "clipx" else tbuild.main
    assert main(_flags(pkg, work, ckpt, *extra) + [str(photos) + os.sep]) == 0


def _serve_args(pkg, work, ckpt, *extra):
    mod = jserve if pkg == "clipx" else tserve
    flags = _flags(pkg, work, ckpt, "--port", "0", *extra)
    if pkg == "clipx":
        flags += ["--sharded", "off"]
    return mod.build_parser().parse_args(flags)


def _start(pkg, work, ckpt, *extra):
    mod = jserve if pkg == "clipx" else tserve
    server = mod.make_server(_serve_args(pkg, work, ckpt, *extra))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _stop(server):
    server.shutdown()
    server.server_close()
    if getattr(server, "_warmup_stop", None) is not None:
        server._warmup_stop.set()
        server._warmup_thread.join(timeout=120)
        assert not server._warmup_thread.is_alive()
    service = server.RequestHandlerClass.service
    service.close()
    service.env.close()


def _service(server):
    return server.RequestHandlerClass.service


def _port_of(server):
    return server.server_address[1]


def _req(port, method, path, body=None, headers=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    if body is not None and not isinstance(body, (bytes, str)):
        body = json.dumps(body)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read()), dict(resp.getheaders())
    conn.close()
    return out


def _get(port, path):
    return _req(port, "GET", path)[:2]


def _post(port, path, payload):
    return _req(port, "POST", path, payload,
                {"Content-Type": "application/json"})[:2]


def _wait_warm(port, timeout=180):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status, h = _get(port, "/healthz")
        if status == 200 and h.get("warm", True):
            return
        time.sleep(0.05)
    raise AssertionError("server never reported warm")


def _retry_cold(fn, timeout=120):
    """Repeat a request while the gate answers 503 (a novel shape runs
    off-thread); the first other answer."""
    deadline = time.time() + timeout
    while True:
        out = fn()
        if out[0] != 503 or time.time() > deadline:
            return out
        time.sleep(0.05)


def _b64(path):
    return base64.b64encode(path.read_bytes()).decode()


def _assert_same_results(ours, ref):
    assert len(ours["results"]) == len(ref["results"]), (ours, ref)
    for a, b in zip(ours["results"], ref["results"]):
        assert (a["rank"], a["id"], a["path"]) == (b["rank"], b["id"],
                                                   b["path"]), (ours, ref)
        assert abs(a["score"] - b["score"]) <= SCORE_TOL, (a, b)
    assert ours["search_time_s"] > 0


# -- endpoint parity ------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory, ckpt):
    """(port's port, clipx's port, photos): both services warm, each over
    its own build of the same folder."""
    root = tmp_path_factory.mktemp("pair")
    photos = root / "photos"
    _save_photos(photos, PHOTOS, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLIPX_SERVE_WARMUP_K", "10")
        servers = {}
        for pkg in ("port", "clipx"):
            _build(pkg, photos, root / pkg, ckpt)
            servers[pkg] = _start(pkg, root / pkg, ckpt)
        try:
            for server in servers.values():
                _wait_warm(_port_of(server))
            yield (_port_of(servers["port"]), _port_of(servers["clipx"]),
                   photos)
        finally:
            for server in servers.values():
                _stop(server)


def _vector():
    v = np.random.RandomState(3).randn(DIM).astype(np.float32)
    return (v / np.linalg.norm(v)).tolist()


# (name, method, path, body or a callable of the photos folder, kind);
# kind: "results" (ranked rows), "embeddings" or "exact" (the same JSON)
CASES = [
    ("healthz", "GET", "/healthz", None, "exact"),
    ("search", "GET", "/search?q=a+photo+of+a+cat&k=3", None, "results"),
    ("search_offset", "GET", "/search?q=photo&k=2&offset=2", None,
     "results"),
    ("similar", "GET", "/similar?id=1&k=4", None, "results"),
    ("similar_nprobe_ignored", "GET", "/similar?id=1&k=2&nprobe=7", None,
     "results"),
    ("search_vector", "POST", "/search_vector",
     lambda p: {"vector": _vector(), "k": 3}, "results"),
    ("search_image", "POST", "/search_image",
     lambda p: {"image_b64": _b64(p / "a.jpg"), "k": 2}, "results"),
    ("encode_text", "POST", "/encode_text",
     lambda p: {"texts": ["hello", "a cat"]}, "embeddings"),
    ("encode_image", "POST", "/encode_image",
     lambda p: {"images_b64": [_b64(p / n) for n in PHOTOS[:3]]},
     "embeddings"),
    ("missing_q", "GET", "/search", None, "exact"),
    ("bad_k", "GET", "/search?q=x&k=0", None, "exact"),
    ("junk_k", "GET", "/search?q=x&k=junk", None, "exact"),
    ("bad_nprobe", "GET", "/similar?id=1&k=2&nprobe=999", None, "exact"),
    ("unknown_id", "GET", "/similar?id=99", None, "exact"),
    ("unknown_get", "GET", "/nope", None, "exact"),
    ("unknown_post", "POST", "/nope", lambda p: {}, "exact"),
    ("malformed_json", "POST", "/encode_text", lambda p: "{not json",
     "exact"),
    ("empty_texts", "POST", "/encode_text", lambda p: {"texts": []},
     "exact"),
    ("wrong_dim", "POST", "/search_vector",
     lambda p: {"vector": [1.0, 2.0]}, "exact"),
    ("vector_bad_k", "POST", "/search_vector",
     lambda p: {"vector": [0.0] * DIM, "k": 1001}, "exact"),
    ("too_many_images", "POST", "/encode_image",
     lambda p: {"images_b64": [_b64(p / "a.jpg")] * 65}, "exact"),
    ("no_images", "POST", "/encode_image", lambda p: {"images_b64": []},
     "exact"),
    ("bad_base64", "POST", "/encode_image",
     lambda p: {"images_b64": ["!!!not-base64!!!"]}, "exact"),
    ("undecodable_image", "POST", "/search_image",
     lambda p: {"image_b64": base64.b64encode(b"junk").decode()}, "exact"),
]


@pytest.mark.parametrize("name,method,path,body,kind", CASES,
                         ids=[c[0] for c in CASES])
def test_endpoint_parity(pair, name, method, path, body, kind):
    port, ref_port, photos = pair
    payload = body(photos) if body is not None else None
    headers = {"Content-Type": "application/json"} if method == "POST" else {}
    (status, ours, _), (ref_status, ref, _) = (
        _req(p, method, path, payload, headers) for p in (port, ref_port))
    assert status == ref_status, (ours, ref)
    if kind == "results":
        assert status == 200, ours
        _assert_same_results(ours, ref)
    elif kind == "embeddings":
        assert status == 200, ours
        np.testing.assert_allclose(np.asarray(ours["embeddings"]),
                                   np.asarray(ref["embeddings"]),
                                   atol=EMB_TOL, rtol=0)
    else:
        assert ours == ref


def test_body_cap_parity(pair):
    """A hostile Content-Length is refused before the read: 413 from both,
    the same error."""
    port, ref_port, _ = pair
    out = [_req(p, "POST", "/encode_text", b"x",
                {"Content-Length": str(3 * 1024 ** 3)})[:2]
           for p in (port, ref_port)]
    assert out[0] == out[1] and out[0][0] == 413
    assert "exceeds" in out[0][1]["error"]


def test_metrics_parity(pair):
    """After the same sequence: the same keys, the same counters (the
    warm-up's 3 text, 5 search Q and 2 image shapes included), the same
    coalescer counts and index provenance."""
    port, ref_port, _ = pair
    _, ours = _get(port, "/metrics")
    _, ref = _get(ref_port, "/metrics")
    assert set(ours) == set(ref)
    for key in ("counters", "coalesce", "text_coalesce", "index", "ntotal",
                "encoder_loaded"):
        assert ours[key] == ref[key], key
    counters = ours["counters"]
    assert (counters["warmup_text_shapes"], counters["warmup_search_shapes"],
            counters["warmup_image_shapes"]) == (3, 5, 2)
    assert counters["errors"] >= 10 and ours["search_latency_avg_s"] > 0


def test_posted_copy_finds_itself_and_concurrent_requests(pair):
    """A posted copy of an indexed photo reproduces its vector (top hit
    itself at score ~1), also while searchers and an encoder race."""
    port, _, photos = pair
    status, data = _post(port, "/search_image",
                         {"image_b64": _b64(photos / "a.jpg"), "k": 2})
    assert status == 200
    top = data["results"][0]
    assert top["path"].endswith("a.jpg") and top["score"] > 0.999
    errors = []

    def searcher(i):
        try:
            for _ in range(5):
                status, data = _get(port, "/similar?id=%d&k=3" % (i % 4))
                assert status == 200
                assert data["results"][0]["id"] == i % 4
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    def encoder():
        try:
            for _ in range(3):
                status, data = _post(port, "/encode_text",
                                     {"texts": ["busy", "bee"]})
                assert status == 200 and len(data["embeddings"]) == 2
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=searcher, args=(i,))
               for i in range(4)] + [threading.Thread(target=encoder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors


# -- the port's service on its own builds ----------------------------------------

def _port_work(tmp_path, ckpt, n_images=5, seed=7, *extra):
    photos = tmp_path / "photos"
    _save_photos(photos, [f"p{i}.jpg" for i in range(n_images)], seed)
    work = tmp_path / "work"
    _build("port", photos, work, ckpt, *extra)
    return photos, work


def _unit_queries(n, dim, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, dim).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _standalone(tmp_path, ckpt, n_images=5, *extra):
    """A SearchService over a fresh tiny port build (no HTTP)."""
    _, work = _port_work(tmp_path, ckpt, n_images)
    return tserve.SearchService(_serve_args("port", work, ckpt, *extra))


def _close(service):
    service.close()
    service.env.close()


def test_coalesced_search_batches_16_concurrent_queries(tmp_path, ckpt,
                                                        monkeypatch):
    """Block the dispatcher inside query 0, queue 16 more, release: the
    backlog rides one batched index.search, each request still getting
    its own k rows in the exact per-query ranking."""
    monkeypatch.setenv("CLIPX_SERVE_INFLIGHT", "1")
    service = _standalone(tmp_path, ckpt)
    try:
        idx = service.index
        orig = idx.search
        calls = []
        entered, release = threading.Event(), threading.Event()

        def gated(feats, k):
            calls.append(feats.shape[0])
            if len(calls) == 1:
                entered.set()
                assert release.wait(30)
            return orig(feats, k)

        idx.search = gated
        qs = _unit_queries(17, idx.dim)
        ks = [3] + [2 + (i % 3) for i in range(1, 17)]
        results = [None] * 17

        def do(i):
            results[i] = service.search(qs[i: i + 1], ks[i])

        threads = [threading.Thread(target=do, args=(0,))]
        threads[0].start()
        assert entered.wait(30)
        for i in range(1, 17):
            threads.append(threading.Thread(target=do, args=(i,)))
            threads[-1].start()
        deadline = time.time() + 30
        while True:
            with service._search_co._cv:
                if len(service._search_co._queue) == 16:
                    break
            assert time.time() < deadline, "queries never queued"
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(30)
        assert calls == [1, 16]
        for i in range(17):
            rows = results[i]["results"]
            assert len(rows) == min(ks[i], idx.ntotal)
            _, I = orig(qs[i: i + 1], ks[i])
            assert [r["id"] for r in rows] == [int(x) for x in
                                               I[0][: len(rows)]]
        m = service.metrics()
        assert (m["coalesce"]["queries"], m["coalesce"]["batches"]) == (17, 2)
    finally:
        _close(service)


def test_coalesced_search_error_propagates(tmp_path, ckpt):
    service = _standalone(tmp_path, ckpt, 3)
    try:
        q = _unit_queries(1, service.index.dim)

        def bad(feats, k):
            raise RuntimeError("device fell over")

        service.index.search = bad
        with pytest.raises(RuntimeError, match="device fell over"):
            service.search(q, 2)
        del service.index.__dict__["search"]
        assert len(service.search(q, 2)["results"]) == 2
    finally:
        _close(service)


@pytest.mark.parametrize("case", ["coalesce_off", "multirow"])
def test_inline_dispatch(tmp_path, ckpt, monkeypatch, case):
    """CLIPX_SERVE_COALESCE=0 has no dispatcher; a multi-row search goes
    inline with the coalescer on. Either way the request thread runs the
    search."""
    if case == "coalesce_off":
        monkeypatch.setenv("CLIPX_SERVE_COALESCE", "0")
    service = _standalone(tmp_path, ckpt, 4)
    try:
        assert (service._search_co is None) == (case == "coalesce_off")
        seen = {}
        orig = service.index.search

        def spy(feats, k):
            seen["tid"] = threading.get_ident()
            return orig(feats, k)

        service.index.search = spy
        nq = 1 if case == "coalesce_off" else 2
        out = service.search(_unit_queries(nq, service.index.dim), 2)
        assert len(out["results"]) == 2
        assert seen["tid"] == threading.get_ident()
    finally:
        _close(service)


def test_coalesced_batches_pipeline(tmp_path, ckpt, monkeypatch):
    """INFLIGHT=2: a second batch dispatches while the first is still in
    flight."""
    monkeypatch.setenv("CLIPX_SERVE_INFLIGHT", "2")
    service = _standalone(tmp_path, ckpt)
    try:
        idx = service.index
        orig = idx.search
        first_in, second_in, release = (threading.Event(), threading.Event(),
                                        threading.Event())
        calls = []

        def gated(feats, k):
            calls.append(feats.shape[0])
            if len(calls) == 1:
                first_in.set()
                assert release.wait(30)
            else:
                second_in.set()
            return orig(feats, k)

        idx.search = gated
        qs = _unit_queries(2, idx.dim)
        results = [None, None]

        def do(i):
            results[i] = service.search(qs[i: i + 1], 2)

        t0 = threading.Thread(target=do, args=(0,))
        t0.start()
        assert first_in.wait(30)
        t1 = threading.Thread(target=do, args=(1,))
        t1.start()
        assert second_in.wait(30), "second batch never overlapped"
        release.set()
        t0.join(30)
        t1.join(30)
        assert all(len(r["results"]) == 2 for r in results)
    finally:
        _close(service)


def test_coalesced_text_encode_batches_concurrent_queries(tmp_path, ckpt,
                                                          monkeypatch):
    monkeypatch.setenv("CLIPX_SERVE_INFLIGHT", "1")
    service = _standalone(tmp_path, ckpt, 3)
    try:
        enc = service.encoder()
        orig = enc.encode_texts
        calls = []
        entered, release = threading.Event(), threading.Event()

        def gated(texts):
            calls.append(len(texts))
            if len(calls) == 1:
                entered.set()
                assert release.wait(30)
            return orig(texts)

        enc.encode_texts = gated
        texts = [f"a {w} photo" for w in
                 ("red", "green", "blue", "gray", "pink")]
        results = [None] * len(texts)

        def do(i):
            results[i] = service.encode_texts([texts[i]])

        threads = [threading.Thread(target=do, args=(0,))]
        threads[0].start()
        assert entered.wait(30)
        for i in range(1, len(texts)):
            threads.append(threading.Thread(target=do, args=(i,)))
            threads[-1].start()
        deadline = time.time() + 30
        while True:
            with service._text_co._cv:
                if len(service._text_co._queue) == len(texts) - 1:
                    break
            assert time.time() < deadline, "texts never queued"
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(30)
        assert calls == [1, len(texts) - 1]
        for i, t in enumerate(texts):
            np.testing.assert_allclose(results[i], orig([t]), rtol=1e-5,
                                       atol=1e-6)
        m = service.metrics()
        assert (m["text_coalesce"]["queries"],
                m["text_coalesce"]["batches"]) == (len(texts), 2)
    finally:
        _close(service)


def test_coalescer_submit_after_close_runs_inline():
    co = tserve._Coalescer(lambda items: [x * 10 for x in items],
                           cap=4, inflight=2, name="t")
    assert co.submit(3) == 30
    co.close()
    t0 = time.time()
    assert co.submit(5) == 50
    assert time.time() - t0 < 5


def _booted(tmp_path, ckpt, *extra, n_images=3, seed=3):
    photos, work = _port_work(tmp_path, ckpt, n_images, seed)
    server = _start("port", work, ckpt, *extra)
    return photos, work, server


def test_cold_shape_guard(tmp_path, ckpt):
    """A hand-attached gate: every shape family answers 503 with
    Retry-After until marked; after the family phase a novel shape key
    answers 503 once while it runs off-thread, then passes."""
    _, _, server = _booted(tmp_path, ckpt, "--no-warmup")
    service, port = _service(server), _port_of(server)
    try:
        gate = tserve._WarmGate(retry_after=7)
        service._warm_gate = gate
        status, h = _get(port, "/healthz")
        assert status == 200 and h["warm"] is False
        status, body, headers = _req(port, "GET", "/similar?id=1&k=2")
        assert status == 503 and headers.get("Retry-After") == "7"
        assert body["warming"] == "search" and body["retry_after_s"] == 7
        status, body = _post(port, "/encode_text", {"texts": ["x"]})
        assert status == 503 and body["warming"] == "text"
        status, body = _get(port, "/search?q=anything&k=2")
        assert status == 503 and body["warming"] == "text"
        status, body = _post(port, "/encode_image", {"images_b64": ["aGk="]})
        assert status == 503 and body["warming"] == "image"
        assert _get(port, "/metrics")[0] == 200
        gate.mark("search")
        status, data = _retry_cold(lambda: _get(port, "/similar?id=1&k=2"))
        assert status == 200 and data["results"][0]["id"] == 1
        assert _get(port, "/similar?id=1&k=2")[0] == 200
        assert _post(port, "/encode_text", {"texts": ["x"]})[0] == 503
        gate.mark_all()
        assert _get(port, "/healthz")[1]["warm"] is True
        status, _ = _retry_cold(lambda: _get(port, "/search?q=anything&k=2"))
        assert status == 200
        _, m = _get(port, "/metrics")
        assert m["counters"].get("cold_rejects", 0) >= 4
        assert m["counters"].get("errors", 0) == 0
    finally:
        _stop(server)


def test_warmup_attaches_gate_and_disarms(tmp_path, ckpt, monkeypatch):
    monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
    _, work, server = _booted(tmp_path, ckpt, n_images=2)
    try:
        assert _service(server)._warm_gate is not None
        _wait_warm(_port_of(server))
        assert _service(server)._warm_gate.all_ready()
        assert _get(_port_of(server), "/search?q=x&k=1")[0] == 200
    finally:
        _stop(server)
    monkeypatch.setenv("CLIPX_SERVE_COLD_GUARD", "off")
    server2 = tserve.make_server(_serve_args("port", work, ckpt))
    try:
        assert _service(server2)._warm_gate is None
    finally:
        server2.server_close()
        server2._warmup_stop.set()
        server2._warmup_thread.join(timeout=120)
        _close(_service(server2))


@pytest.mark.parametrize("writer", ["port", "clipx"])
def test_warmup_manifest_replays_across_packages(tmp_path, ckpt, monkeypatch,
                                                 writer):
    """A novel shape (k = 17, bucket 32) after warm-up answers 503 once,
    runs off-thread and lands in <index>.warmup.json; a second boot, of
    the other package, replays that manifest: the same request answers
    200 with no 503."""
    monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
    photos = tmp_path / "photos"
    _save_photos(photos, [f"p{i}.jpg" for i in range(4)], 5)
    work = tmp_path / "work"
    _build("clipx", photos, work, ckpt)
    reader = "clipx" if writer == "port" else "port"
    server = _start(writer, work, ckpt)
    try:
        port = _port_of(server)
        _wait_warm(port)
        status, _, headers = _req(port, "GET", "/similar?id=1&k=17")
        assert status == 503 and "Retry-After" in headers
        status, data = _retry_cold(lambda: _get(port, "/similar?id=1&k=17"))
        assert status == 200 and data["results"][0]["id"] == 1
        counters = _get(port, "/metrics")[1]["counters"]
        assert counters.get("bg_compiles", 0) >= 1
    finally:
        _stop(server)
    with open(work / "images.index.warmup.json") as f:
        written = json.load(f)
    assert {"family": "search", "k": 17, "nprobe": None} in written["entries"]
    server = _start(reader, work, ckpt)
    try:
        port = _port_of(server)
        _wait_warm(port)
        status, data = _get(port, "/similar?id=1&k=17")
        assert status == 200 and data["results"][0]["id"] == 1
        assert _get(port, "/metrics")[1]["counters"].get("cold_rejects",
                                                         0) == 0
    finally:
        _stop(server)


# -- /reload ----------------------------------------------------------------------

def test_reload_modes_match_clipx(tmp_path, ckpt, monkeypatch):
    """Grow the folder with names that sort last (incremental: the prefix
    hash matches) and then with one that sorts first (every id shifts:
    drop-first rebuild). Each package rebuilds its own work directory;
    the port's /reload answers what clipx's SearchService.reload answers,
    and the new ids resolve through the refreshed store."""
    monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
    photos = tmp_path / "photos"
    rng = np.random.RandomState(3)

    def add(name):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(photos / name)

    photos.mkdir()
    for i in range(3):
        add(f"p{i}.jpg")
    works = {pkg: tmp_path / pkg for pkg in ("port", "clipx")}
    for pkg, work in works.items():
        _build(pkg, photos, work, ckpt)
    server = _start("port", works["port"], ckpt)
    ref = jserve.SearchService(_serve_args("clipx", works["clipx"], ckpt))
    try:
        port = _port_of(server)
        _wait_warm(port)
        assert _get(port, "/healthz")[1]["ntotal"] == 3
        for i in range(3, 6):
            add(f"p{i}.jpg")
        for pkg, work in works.items():
            _build(pkg, photos, work, ckpt)
        assert _get(port, "/healthz")[1]["ntotal"] == 3  # old snapshot
        status, r = _post(port, "/reload", {})
        assert status == 200 and r == ref.reload()
        assert r == {"ntotal": 6, "previous_ntotal": 3,
                     "mode": "incremental"}
        status, sim = _get(port, "/similar?id=5&k=1")
        assert status == 200 and sim["results"][0]["id"] == 5
        add("a0.jpg")
        for pkg, work in works.items():
            _build(pkg, photos, work, ckpt)
        status, r = _post(port, "/reload", {})
        assert status == 200 and r == ref.reload()
        assert r["mode"] == "rebuild" and r["ntotal"] == 7
        status, sim = _retry_cold(lambda: _get(port, "/similar?id=0&k=1"))
        assert status == 200 and sim["results"][0]["path"].endswith("a0.jpg")
    finally:
        _stop(server)
        _close(ref)


@pytest.mark.parametrize("mode", ["rebuild", "incremental"])
def test_searches_during_reload_succeed(tmp_path, ckpt, monkeypatch, mode):
    """Searches racing a slowed reload all answer 200 with the right
    hit: they wait out the no-index window of a rebuild, or the
    mutation window of an in-place add."""
    photos, work, server = _booted(tmp_path, ckpt, "--no-warmup",
                                   n_images=4, seed=9)
    service, port = _service(server), _port_of(server)
    try:
        entered = threading.Event()
        if mode == "rebuild":
            service._sidecar_hash = b"not-the-real-hash"
            real_build = tserve.common.build_index_from_vectors

            def slow_build(vectors, a):
                entered.set()
                time.sleep(0.5)
                return real_build(vectors, a)

            monkeypatch.setattr(tserve.common, "build_index_from_vectors",
                                slow_build)
        else:
            _save_photos(photos, ["p4.jpg", "p5.jpg"], 10)
            _build("port", photos, work, ckpt)
            cls = type(service.index)
            real_add = cls.add

            def slow_add(self_idx, vectors):
                entered.set()
                time.sleep(0.5)
                return real_add(self_idx, vectors)

            monkeypatch.setattr(cls, "add", slow_add)
        errors, results = [], []

        def searcher():
            try:
                status, data = _get(port, "/similar?id=1&k=2")
                assert status == 200, data
                assert data["results"][0]["id"] == 1
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        rt = threading.Thread(target=lambda: results.append(
            _post(port, "/reload", {})))
        rt.start()
        assert entered.wait(30)
        threads = [threading.Thread(target=searcher) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads + [rt]:
            t.join(timeout=60)
        assert not errors, errors
        status, r = results[0]
        assert status == 200 and r["mode"] == mode, r
        if mode == "incremental":
            status, sim = _get(port, "/similar?id=5&k=1")
            assert status == 200 and sim["results"][0]["id"] == 5
    finally:
        _stop(server)


def test_rebuild_reload_waits_for_readers(tmp_path, ckpt, monkeypatch):
    """The rebuild drops the old corpus only after running searches
    finish (else a search's reference keeps it on the card through the
    upload)."""
    _, _, server = _booted(tmp_path, ckpt, "--no-warmup", seed=22)
    service = _service(server)
    try:
        service._sidecar_hash = b"force-rebuild"
        entered = threading.Event()
        real_build = tserve.common.build_index_from_vectors

        def marking_build(vectors, a):
            entered.set()
            return real_build(vectors, a)

        monkeypatch.setattr(tserve.common, "build_index_from_vectors",
                            marking_build)
        service._begin_read()
        reload_thread = threading.Thread(target=service.reload)
        reload_thread.start()
        assert not entered.wait(1.0), \
            "rebuild dropped the old corpus while a reader was in flight"
        service._end_read()
        assert entered.wait(30)
        reload_thread.join(timeout=60)
        assert not reload_thread.is_alive() and service.index is not None
    finally:
        _stop(server)


def test_healthz_nonblocking_during_rebuild(tmp_path, ckpt, monkeypatch):
    _, _, server = _booted(tmp_path, ckpt, "--no-warmup", seed=21)
    service, port = _service(server), _port_of(server)
    release = threading.Event()
    try:
        service._sidecar_hash = b"force-rebuild"
        real_build = tserve.common.build_index_from_vectors
        entered = threading.Event()

        def slow_build(vectors, a):
            entered.set()
            release.wait(30)
            return real_build(vectors, a)

        monkeypatch.setattr(tserve.common, "build_index_from_vectors",
                            slow_build)
        rt = threading.Thread(target=lambda: _post(port, "/reload", {}))
        rt.start()
        assert entered.wait(30)
        t0 = time.time()
        status, data = _get(port, "/healthz")
        assert status == 503 and data["status"] == "reloading"
        assert time.time() - t0 < 5
        release.set()
        rt.join(timeout=60)
        status, data = _get(port, "/healthz")
        assert status == 200 and data["status"] == "ok"
    finally:
        release.set()
        _stop(server)


def test_current_index_times_out_when_reload_stalls(tmp_path, ckpt):
    service = _standalone(tmp_path, ckpt, 1)
    try:
        service._index_ready.clear()
        service.index = None
        with pytest.raises(RuntimeError, match="reloading"):
            service.current_index(timeout=0.2)
    finally:
        _close(service)


@pytest.mark.parametrize("cdtype", ["bf16", "int8", "int4", "pq"])
def test_corpus_dtype_search_and_incremental_reload(tmp_path, ckpt,
                                                    monkeypatch, cdtype):
    """Each coded tier serves, and an append-only rebuild reloads
    incrementally (the delta add differs per tier)."""
    monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
    photos, work, server = _booted(tmp_path, ckpt, "--corpus-dtype", cdtype,
                                   n_images=4, seed=9)
    try:
        svc, port = _service(server), _port_of(server)
        assert svc.index.dtype == cdtype
        _wait_warm(port)
        status, data = _get(port, "/search?q=anything&k=2")
        assert status == 200 and len(data["results"]) == 2
        status, sim = _get(port, "/similar?id=1&k=2")
        assert status == 200 and sim["results"][0]["id"] == 1
        _save_photos(photos, [f"p{i}.jpg" for i in range(4, 7)], 19)
        _build("port", photos, work, ckpt, "--corpus-dtype", cdtype)
        status, r = _post(port, "/reload", {})
        assert status == 200 and r["mode"] == "incremental", r
        assert r["ntotal"] == 7
        status, sim = _get(port, "/similar?id=6&k=1")
        assert status == 200 and sim["results"][0]["id"] == 6
    finally:
        _stop(server)


def test_metrics_index_provenance(tmp_path, ckpt):
    """A second boot of an int8 deployment loads the codes file: /metrics
    says so, and the codes' content hash keeps reload incremental."""
    _, work = _port_work(tmp_path, ckpt, 3, 6)
    args = _serve_args("port", work, ckpt, "--no-warmup",
                       "--corpus-dtype", "int8")
    _close(tserve.SearchService(args))  # encodes and writes the codes
    server = tserve.make_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, m = _get(_port_of(server), "/metrics")
        assert status == 200
        assert m["index"] == {"class": "VectorIndex", "storage": "int8",
                              "booted_from_codes": True}
        svc = _service(server)
        assert svc._sidecar_hash == svc.index._boot_content_hash
        status, r = _post(_port_of(server), "/reload", {})
        assert status == 200 and r["mode"] == "incremental"
    finally:
        _stop(server)


def test_ivf_mode_through_a_shared_ivf_matches_clipx(tmp_path, ckpt,
                                                     monkeypatch):
    """--search-mode ivf: clipx's service trains and writes
    images.index.ivf, the port's loads a copy of clipx's files; per-request
    nprobe answers equal clipx's and leave the global knob alone. Then an
    append reloads incrementally into the port's exact tail."""
    monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
    photos = tmp_path / "photos"
    _save_photos(photos, [f"p{i}.jpg" for i in range(5)], 11)
    ref_work, work = tmp_path / "clipx", tmp_path / "port"
    _build("clipx", photos, ref_work, ckpt)
    ref = _start("clipx", ref_work, ckpt, "--search-mode", "ivf")
    work.mkdir()
    for name in ("images.index", "images.index.ivf"):
        shutil.copy(ref_work / name, work / name)
    shutil.copytree(ref_work / "vectors.lmdb", work / "vectors.lmdb")
    server = _start("port", work, ckpt, "--search-mode", "ivf")
    try:
        svc, port, ref_port = _service(server), _port_of(server), _port_of(ref)
        assert type(svc.index).__name__ == "IVFIndex"
        np.testing.assert_array_equal(svc.index._row_ext,
                                      np.asarray(_service(ref).index._row_ext))
        _wait_warm(port)
        _wait_warm(ref_port)
        vec = svc.index.reconstruct(2).tolist()
        for body in ({"vector": vec, "k": 3}, {"vector": vec, "k": 3,
                                                "nprobe": 100},
                     {"vector": vec, "k": 2, "nprobe": 1}):
            outs = [_retry_cold(lambda p=p: _post(p, "/search_vector", body))
                    for p in (port, ref_port)]
            assert outs[0][0] == outs[1][0] == 200
            _assert_same_results(outs[0][1], outs[1][1])
            assert outs[0][1]["results"][0]["id"] == 2
        assert svc.index.nprobe == 32
        for path in ("/similar?id=2&k=2&nprobe=101",):
            assert _get(port, path) == _get(ref_port, path)
        status, _ = _post(port, "/search_vector",
                          {"vector": vec, "k": 2, "nprobe": 0})
        assert status == 400
        _save_photos(photos, ["p5.jpg", "p6.jpg"], 12)
        _build("port", photos, work, ckpt)
        status, r = _post(port, "/reload", {})
        assert status == 200 and r["mode"] == "incremental"
        assert r["ntotal"] == 7 and svc.index.tail_fraction > 0
        status, sim = _retry_cold(lambda: _get(port, "/similar?id=6&k=1"))
        assert status == 200 and sim["results"][0]["id"] == 6
    finally:
        _stop(server)
        _stop(ref)


def test_serve_compute_int8(tmp_path, ckpt, monkeypatch):
    """--compute int8: the encoder's image MLP is W8A8 and every endpoint
    answers."""
    monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
    photos, _, server = _booted(tmp_path, ckpt, "--compute", "int8")
    try:
        port = _port_of(server)
        _wait_warm(port)
        status, data = _get(port, "/search?q=a+red+photo&k=2")
        assert status == 200 and len(data["results"]) == 2
        enc = _service(server).encoder()
        assert enc.compute_quant == "int8"
        assert enc.params["visual"]["blocks"]["mlp"]["w1_q"].dtype == \
            torch.int8
        status, data = _post(port, "/search_image",
                             {"image_b64": _b64(photos / "p0.jpg"), "k": 1})
        assert status == 200 and data["results"][0]["id"] == 0
    finally:
        _stop(server)


def test_sigterm_shuts_down_cleanly(tmp_path, ckpt):
    """SIGTERM ends python -m clipx_torch.serve like Ctrl-C: drained, exit
    code 0, 'bye'."""
    from tests._subproc import finish, read_until, spawn

    _, work = _port_work(tmp_path, ckpt, 2, 23)
    argv = _flags("port", work, ckpt, "--port", "0", "--no-warmup")
    proc = spawn("from clipx_torch.serve import main; "
                 f"raise SystemExit(main({argv!r}))", cwd=work)
    buf = ""
    try:
        buf = read_until(proc, lambda t: "clipx-serve on" in t, timeout=120)
        assert "clipx-serve on" in buf, buf
        proc.send_signal(signal.SIGTERM)
        out = finish(proc, timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            finish(proc, timeout=30)
    assert proc.returncode == 0, buf + out
    assert "bye" in out


def test_refusals_exit_with_a_message(tmp_path, ckpt, monkeypatch):
    """cuda with no GPU visible exits naming the device."""
    _, work = _port_work(tmp_path, ckpt, 1, 1)
    argv = _flags("port", work, ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tserve.main(argv[:-2])


@pytest.mark.parametrize("cdtype", ["f32", "pq"])
def test_sharded_on_service_answers_as_unsharded(tmp_path, ckpt, monkeypatch,
                                                 cdtype):
    """--sharded on (one CPU shard) serves a ShardedVectorIndex whose
    /search_vector, /search and /similar answers equal --sharded off's,
    before and after the same incremental /reload of a grown folder (the
    sharded add gets only the delta)."""
    monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
    flags = ("--corpus-dtype", cdtype)
    photos, work = _port_work(tmp_path, ckpt, 4, 9, *flags)
    requests = [("POST", "/search_vector",
                 {"vector": _unit_queries(1, DIM, 3)[0].tolist(), "k": 3}),
                ("GET", "/search?q=a+red+photo&k=3", None),
                ("GET", "/similar?id=1&k=2", None),
                ("GET", "/similar?id=3&k=5", None)]

    def ask(port):
        return [_retry_cold(lambda: _req(port, m, path, body)[:2])
                for m, path, body in requests]

    def answers(sharded):
        """(index class, answers, answers after growing the folder and an
        incremental /reload)"""
        server = _start("port", work, ckpt, *flags, "--sharded", sharded)
        try:
            port = _port_of(server)
            _wait_warm(port)
            out = [_get(port, "/metrics")[1]["index"]["class"], ask(port)]
            _save_photos(photos, [f"p{i}.jpg" for i in range(4, 7)], 19)
            _build("port", photos, work, ckpt, *flags)
            index = _service(server).index
            calls, add = [], index.add
            monkeypatch.setattr(index, "add", lambda v: (
                calls.append(len(v)), add(v))[1])
            status, r = _post(port, "/reload", {})
            assert status == 200 and r["mode"] == "incremental", r
            assert calls == [3] and r["ntotal"] == 7
            return out + [ask(port)]
        finally:
            _stop(server)

    shutil.copytree(work, tmp_path / "work4")
    cls_off, off4, off7 = answers("off")
    # the same 4-image deployment again, for the sharded service
    shutil.rmtree(work)
    shutil.copytree(tmp_path / "work4", work)
    for i in range(4, 7):
        (photos / f"p{i}.jpg").unlink()
    cls_on, on4, on7 = answers("on")
    assert (cls_on, cls_off) == ("ShardedVectorIndex", "VectorIndex")
    for on, off in ((on4, off4), (on7, off7)):
        for (s_on, a), (s_off, b) in zip(on, off):
            assert s_on == s_off == 200
            _assert_same_results(a, b)
    assert max(r["id"] for r in on7[-1][1]["results"]) >= 4  # new rows


def test_sharded_auto_with_two_gpus_builds_a_two_shard_mesh(monkeypatch,
                                                            capsys):
    """--sharded auto with two GPUs visible (mocked) shards the index over
    both, and the indexer's encode; off uses one; on the CPU auto never
    shards. No path prints anything about it."""
    from clipx_torch.cli import common

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    parse = tserve.build_parser().parse_args
    for sharded, shards in (("auto", 2), ("on", 2), ("off", None)):
        args = parse(["--sharded", sharded])
        common.check_device(args)
        mesh = common.search_mesh(args)
        if shards is None:
            assert mesh is None and common.encode_mesh(args) is None
        else:
            assert mesh.shape == {"shard": 2}
            assert mesh.devices == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
            assert common.encode_mesh(args).shape == {"dp": 2}
    assert common.search_mesh(parse(["--sharded", "auto", "--device",
                                     "cpu"])) is None
    assert common.search_mesh(parse(["--sharded", "on", "--device",
                                     "cpu"])).devices == [torch.device("cpu")]
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_concurrent_first_searches_quantize_once(monkeypatch, tmp_path,
                                                 kind):
    """The first searches of a quantized index on several threads at once
    (the coalescer's workers after a reload's add) build the int8 scan
    copy once, and all answer alike."""
    from clipx_torch.search import ivf as tivf

    rng = np.random.RandomState(0)
    corpus = rng.randn(3000, DIM).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    if kind == "flat":
        idx = teng.VectorIndex.from_vectors(corpus, quantized=True,
                                            device="cpu")
    else:
        idx = tivf.IVFIndex.from_vectors(
            corpus, quantized=True, device="cpu",
            cache_path=str(tmp_path / "images.index.ivf"))
    calls = []
    real = teng._quantize_device

    def counting(rows):
        calls.append(1)
        time.sleep(0.05)  # widen the window a second build would hit
        return real(rows)

    monkeypatch.setattr(teng, "_quantize_device", counting)
    out = [None] * 8
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def search(i):
            out[i] = idx.search(corpus[:2], 5)

        threads = [threading.Thread(target=search, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    for D, I in out[1:]:
        np.testing.assert_array_equal(I, out[0][1])
        np.testing.assert_array_equal(D, out[0][0])


def test_full_f32_guard_holds_under_overlapping_threads():
    """Two searches' TF32 guards overlap: TF32 reads off while either is
    inside, and the caller's setting comes back once both have left (a
    per-call save and restore let the first leaver turn TF32 back on under
    the second)."""
    cuda = torch.device("cuda")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    a_in, b_in, a_out = (threading.Event(), threading.Event(),
                         threading.Event())

    def a():
        with tdev.full_f32(cuda):
            a_in.set()
            assert b_in.wait(30)
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        a_out.set()

    def b():
        assert a_in.wait(30)
        with tdev.full_f32(cuda):
            b_in.set()
            assert a_out.wait(30)
            seen.append(torch.backends.cuda.matmul.allow_tf32)

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert seen == [False, False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
