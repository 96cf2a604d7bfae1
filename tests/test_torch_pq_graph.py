"""The flat pq search's CUDA graphs (``VectorIndex.search`` on the card), as
far as the CPU can see them: a CPU index never captures and moves neither
of the two search counts, every change to the codes empties an index's
graphs, and the graph key follows what a capture holds fixed. The replays
themselves are the ``cuda`` tests of ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from clipx_torch.ops import _launch
from clipx_torch.search import engine as teng
from clipx_torch.search import pq as tpq

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

DIM, ROWS = 64, 3000
COUNTS = ("pq_search_graph", "pq_search_eager")


def _index(rows=ROWS, seed=0):
    """A pq index straight from seeded codes and centroids (no k-means)."""
    rng = np.random.default_rng(seed)
    m = DIM // 2
    return teng.VectorIndex.from_codes({
        "tier": "pq", "dim": DIM, "code_dim": m // 2, "ntotal": rows,
        "centroids": rng.standard_normal((m, tpq.PQ_K, 2)).astype(
            np.float32),
        "codes": rng.integers(-128, 128, (rows, m // 2), dtype=np.int8)},
        device="cpu")


def _queries(nq, seed=1):
    q = np.random.default_rng(seed).standard_normal((nq, DIM))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _search_counts():
    return {k: n for k, n in _launch.launch_counts().items() if k in COUNTS}


@pytest.mark.parametrize("nq,k", [(1, 50), (3, 1), (16, 300)])
def test_cpu_pq_search_stays_eager_and_uncounted(nq, k):
    """A CPU search captures nothing and moves neither count; its (D, I)
    are ``_pq_topk``'s on the rotated queries padded to their Q bucket,
    bitwise."""
    idx = _index()
    queries = _queries(nq, seed=nq + k)
    before = _search_counts()
    D, I = idx.search(queries, k)
    assert _search_counts() == before
    assert idx._pq_graphs.graphs == {} and idx._pq_graphs._pool is None
    padded, n = teng._pad_q(teng.rotate_rows(queries, idx._rot))
    kk = min(teng._bucket_k(k), idx._codes.shape[0])
    with torch.inference_mode():
        want_d, want_i = tpq._pq_topk(idx._codes, idx._pq.device("cpu"),
                                      idx.ntotal, torch.from_numpy(padded),
                                      kk)
    assert n == nq and idx._center is None
    np.testing.assert_array_equal(D, want_d[:nq, :k].numpy())
    np.testing.assert_array_equal(I, want_i[:nq, :k].numpy())


def _append_in_place(idx):
    codes = idx._codes
    idx.add(_queries(10, seed=5))
    assert idx._codes is codes and idx.ntotal == ROWS + 10


def _grow(idx):
    idx._grow(idx._codes.shape[0] + 1)


def _place(idx):
    idx._place_pq(idx._codes[:idx.ntotal].numpy())


@pytest.mark.parametrize("change", [_append_in_place, _grow, _place],
                         ids=["add", "grow", "place_pq"])
def test_a_change_to_the_codes_drops_the_graphs(change):
    """Each capture holds the codes' address and ntotal: an in-place
    append, a growth and a placement each empty the graph dict and retire
    its pool."""
    idx = _index()
    idx._pq_graphs._graphs[("sentinel",)] = None
    idx._pq_graphs._pool = (0, 1)
    change(idx)
    assert idx._pq_graphs.graphs == {} and idx._pq_graphs._pool is None


@pytest.mark.parametrize("moved", ["q_bucket", "k_bucket", "ntotal"])
def test_the_graph_key_follows_what_a_capture_holds(moved):
    """The key of a capture changes with the Q bucket, the k bucket and
    ntotal; an append that fits keeps the capacity."""
    idx = _index()
    base = idx._pq_key(1, 64)
    assert base == (1, 64, ROWS, idx._codes.shape[0])
    if moved == "q_bucket":
        key = idx._pq_key(teng._bucket_q(3), 64)
    elif moved == "k_bucket":
        key = idx._pq_key(1, teng._bucket_k(100))
    else:
        _append_in_place(idx)
        key = idx._pq_key(1, 64)
        assert key[3] == base[3]
    assert key != base
