"""``runtime/graphs.py``'s bookkeeping on the CPU, with stand-ins for
``torch.cuda``'s stream, pool and graph: what a replay counts, a failed
capture's eager key and note, when the pool retires, ``clear``, and many
threads at once; and the forward counts it forms its names from
(``ops/_launch.py``). The real captures and replays are the ``cuda`` tests
of ``tests/test_torch_cuda.py``."""

import contextlib
import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from clipx_torch.ops import _launch
from clipx_torch.runtime.graphs import CudaGraphs

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("family", ["text_tower", "pq_search"])
def test_launches_has_the_forward_counts(family):
    """Each family's two forward counts sit beside the kernels' from
    import, are the helper's names, add and reset with them."""
    assert _launch.FORWARD_COUNTS == ("text_tower_graph", "text_tower_eager",
                                      "pq_search_graph", "pq_search_eager")
    graphs = CudaGraphs(CPU, family, str)
    names = (graphs.graph_count, graphs.eager_count)
    assert names == (f"{family}_graph", f"{family}_eager")
    counts = _launch.launch_counts()
    assert set(_launch.FORWARD_COUNTS) <= set(counts)
    _launch.count({names[0]: 3, names[1]: 1})
    after = _launch.launch_counts()
    assert {k: after[k] - counts[k] for k in after
            if after[k] != counts[k]} == {names[0]: 3, names[1]: 1}
    _launch.reset_launches()
    assert not any(_launch.launch_counts().values())


def test_a_family_without_forward_counts_is_refused():
    with pytest.raises(ValueError, match="image_tower"):
        CudaGraphs(CPU, "image_tower", str)


class _Graph:
    """torch.cuda.CUDAGraph's stand-in: it records nothing, so a replay
    leaves the static output as the capture's forward wrote it."""

    made = 0
    capturing = threading.local()

    def __init__(self):
        _Graph.made += 1
        self.replays = 0

    def capture_begin(self, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        self.pool = pool
        _Graph.capturing.on = True

    def capture_end(self):
        _Graph.capturing.on = False

    def replay(self):
        self.replays += 1


class _Stream:
    cuda_stream = 0

    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    pools = itertools.count()
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", next(pools)))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    _Graph.made = 0
    _Graph.capturing.on = False


def _ok(*args):
    return 0  # a C entry point that succeeds


def _tower(x, fail_rows=None):
    """Two launches of a kernel and the doubled input; raises inside a
    capture at ``fail_rows`` rows."""
    if getattr(_Graph.capturing, "on", False) and x.shape[0] == fail_rows:
        raise RuntimeError("forced capture failure")
    _launch.launch("fused_mlp", _ok, x.device)
    _launch.launch("fused_mlp", _ok, x.device)
    return x * 2


def _diff(before):
    after = _launch.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _host(rows, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((rows, 3)))


def test_a_replay_counts_its_graph_and_the_captured_launches(fake_cuda):
    """The first run counts the eager pass before the capture (its two
    launches and one eager), then its replay; every run's replay counts
    one graph and the two launches the capture recorded. The input is
    copied into the static buffer and ``read`` sees the static output
    under the lock."""
    graphs = CudaGraphs(CPU, "text_tower", lambda key: f"text bucket {key}")
    seen = []

    def read(out):
        seen.append((out, graphs._lock.locked()))
        return out[:1].clone()

    before = _launch.launch_counts()
    graphs.run(4, _host(4), _tower, read)
    assert _diff(before) == {"fused_mlp": 4, "text_tower_eager": 1,
                             "text_tower_graph": 1}
    g = graphs.graphs[4]
    assert g.counts == {"fused_mlp": 2, "text_tower_graph": 1}
    before = _launch.launch_counts()
    host = _host(4, seed=1)
    graphs.run(4, host, _tower, read)
    assert _diff(before) == {"fused_mlp": 2, "text_tower_graph": 1}
    assert _Graph.made == 1 and g.graph.replays == 2
    assert torch.equal(g.input, host)
    assert all(out is g.output and locked for out, locked in seen)
    with pytest.raises(TypeError):
        graphs.graphs[1] = None  # the dict is the helper's to write


def test_a_failed_capture_leaves_its_key_eager(fake_cuda, capsys):
    """A capture that raises leaves its key None for good, with the
    caller's note: the first run counts two eager forwards (the pass
    before the capture and the fallback), each later run one and no new
    capture; the result is the eager forward's."""
    graphs = CudaGraphs(CPU, "pq_search",
                        lambda key: f"pq search at Q bucket {key[0]}, "
                                    f"k bucket {key[1]}")
    fn = lambda x: _tower(x, fail_rows=4)  # noqa: E731
    host = _host(4)
    before = _launch.launch_counts()
    got = graphs.run((4, 64), host, fn, lambda out: out.clone())
    assert ("(pq search at Q bucket 4, k bucket 64 runs eagerly: its CUDA "
            "graph capture failed: forced capture failure)"
            in capsys.readouterr().err)
    assert _diff(before) == {"fused_mlp": 4, "pq_search_eager": 2}
    assert graphs.graphs == {(4, 64): None}
    torch.testing.assert_close(got, host * 2, rtol=0, atol=0)
    for _ in range(3):
        before = _launch.launch_counts()
        again = graphs.run((4, 64), host, fn, lambda out: out.clone())
        assert _diff(before) == {"fused_mlp": 2, "pq_search_eager": 1}
        assert torch.equal(again, got)
    assert _Graph.made == 1 and capsys.readouterr().err == ""


def test_the_pool_retires_only_when_no_other_graph_is_live(fake_cuda):
    """A failed capture keeps the pool while another graph of the owner
    is live and retires it when none is; ``clear`` empties the dict and
    retires the pool, and the next capture takes a new one."""
    graphs = CudaGraphs(CPU, "text_tower", lambda key: f"text bucket {key}")
    fn = lambda x: _tower(x, fail_rows=4)  # noqa: E731
    read = lambda out: out  # noqa: E731
    graphs.run(4, _host(4), fn, read)         # fails: its pool retires
    assert graphs._pool is None
    graphs.run(1, _host(1), fn, read)         # a new pool
    first = graphs._pool
    assert first == ("pool", 1) and graphs.graphs[1].graph.pool == first
    graphs.run(16, _host(16), lambda x: _tower(x, fail_rows=16), read)
    assert graphs.graphs[16] is None and graphs._pool == first
    graphs.clear()
    assert graphs.graphs == {} and graphs._pool is None
    before = _launch.launch_counts()
    graphs.run(1, _host(1), fn, read)         # captures anew, in a new pool
    assert _diff(before) == {"fused_mlp": 4, "text_tower_eager": 1,
                             "text_tower_graph": 1}
    assert graphs._pool == ("pool", 2)


def test_eight_threads_share_the_graphs(fake_cuda):
    """Eight threads, 25 runs each over two keys, all at once: one
    capture a key, and every run one replay."""
    graphs = CudaGraphs(CPU, "pq_search", str)
    errors, calls = [], 25

    def client(t):
        try:
            rows = 1 + 2 * (t % 2)
            for _ in range(calls):
                graphs.run(rows, _host(rows, seed=t), _tower,
                           lambda out: out.clone())
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        before = _launch.launch_counts()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
    finally:
        sys.setswitchinterval(interval)
    assert _Graph.made == 2
    assert _diff(before) == {"fused_mlp": 2 * 2 + 2 * 8 * calls,
                             "pq_search_eager": 2,
                             "pq_search_graph": 8 * calls}
