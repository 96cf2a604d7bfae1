"""The port's IVF search (``clipx_torch/search/ivf.py``) against clipx's, on
the CPU, at D = 64 over the 4,096-row clustered corpus of
``tests/test_ivf.py``.

- Shared layout: one package writes the ``.ivf`` cache, the other loads it,
  and both search every tier at nprobe 1, 17, 32 and 100, k 1, 10 and 50,
  Q 1, 3 and 37 (37 splits into query chunks): the same ids, scores within
  1e-5 (the port's PQ probe chunks its rows otherwise than clipx's, which
  changes no result). The probe's exact f32 scores are summed in another
  order than XLA's, so two rows whose scores lie within ``TIE`` of each
  other may come in either order; everything else must be identical.
- The raw int8 and int4 probe scans bitwise, and the layout helpers, the
  residual encoder and the cache format equal to clipx's.
- The port's own k-means (its layout differs from clipx's: it draws from
  numpy's generator), and the single-device cases of ``tests/test_ivf.py``
  and the IVF cases of ``tests/test_codes_only.py``, run against the port.
"""

import argparse
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipx.search import engine as jeng
from clipx.search import ivf as jivf
from clipx_torch.cli import common as tcommon
from clipx_torch.search import codes_io as tcodes
from clipx_torch.search import engine as teng
from clipx_torch.search import ivf as tivf

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

DIM = 64
SCORE_TOL = 1e-5
# scores closer than this are ties up to f32 summation order (a few ulps)
TIE = 2e-6
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
              "int4": jnp.int4, "pq": "pq"}
# tier -> (storage dtype, quantized scan, residual pq)
TIERS = {"f32": ("f32", False, False), "f32_quant": ("f32", True, False),
         "bf16": ("bf16", False, False), "int8": ("int8", False, False),
         "int4": ("int4", False, False), "pq": ("pq", False, False),
         "pq_residual": ("pq", False, True)}


def _clustered_corpus(n, dim, n_clusters, seed=0, spread=0.05):
    """tests/test_ivf.py's synthetic clustered unit vectors."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.randint(n_clusters, size=n)
    x = centers[which] + spread * rng.randn(n, dim).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    return _clustered_corpus(4096, DIM, 24)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.RandomState(7)
    q = corpus[rng.choice(corpus.shape[0], 37, replace=False)]
    q = q + 0.01 * rng.randn(*q.shape).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _assert_same_results(D, I, Dr, Ir):
    """(D, I) equal to clipx's (Dr, Ir): scores within SCORE_TOL; ids
    identical, except within a run of reference scores closer than TIE
    (the same set there, or, for a run that reaches rank k, scores within
    TIE of the run's)."""
    assert I.shape == Ir.shape and I.dtype == np.int64
    np.testing.assert_allclose(D, Dr, atol=SCORE_TOL, rtol=0)
    for row in range(Ir.shape[0]):
        d, k = Dr[row], Ir.shape[1]
        start = 0
        while start < k:
            end = start + 1
            while (end < k and np.isfinite(d[end])
                   and d[end - 1] - d[end] <= TIE):
                end += 1
            ours, ref = I[row, start:end], Ir[row, start:end]
            if end - start == 1 or not np.isfinite(d[start]):
                np.testing.assert_array_equal(ours, ref)
            elif end < k:
                assert set(ours) == set(ref), (row, start, ours, ref)
            start = end


def _recall(I, Ie):
    return sum(len(set(a) & set(e)) for a, e in zip(I, Ie)) / Ie.size


# -- shared-layout parity ---------------------------------------------------------

@pytest.mark.parametrize("writer", ["clipx", "port"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_shared_layout_parity(corpus, queries, tmp_path, monkeypatch, tier,
                              writer):
    """One package writes the .ivf cache (its own k-means), the other
    loads it: one layout, then the same search results everywhere."""
    dtype, quantized, residual = TIERS[tier]
    monkeypatch.setenv("CLIPX_PQ_RESIDUAL", "on" if residual else "off")
    cache = str(tmp_path / "images.index.ivf")

    def clipx():
        return jivf.IVFIndex.from_vectors(corpus, quantized=quantized,
                                          cache_path=cache,
                                          dtype=JAX_DTYPES[dtype])

    def port():
        return tivf.IVFIndex.from_vectors(corpus, quantized=quantized,
                                          cache_path=cache, dtype=dtype,
                                          device="cpu")

    if writer == "clipx":
        ref, ours = clipx(), port()
    else:
        ours, ref = port(), clipx()
    np.testing.assert_array_equal(ours._row_ext, ref._row_ext)
    assert ours._residual == ref._residual == residual
    for nprobe in (1, 17, 32, 100):
        ref.nprobe = ours.nprobe = nprobe
        for k in (1, 10, 50):
            for nq in (1, 3, 37):
                Dr, Ir = ref.search(queries[:nq], k)
                D, I = ours.search(queries[:nq], k)
                _assert_same_results(D, I, Dr, Ir)
    np.testing.assert_allclose(ours.vectors(), ref.vectors(), atol=1e-6,
                               rtol=0)
    for row in (0, 1234, corpus.shape[0] - 1):
        np.testing.assert_allclose(ours.reconstruct(row),
                                   ref.reconstruct(row), atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk_rows", [64, 320, 32768])
@pytest.mark.parametrize("residual", ["off", "on"])
def test_pq_probe_chunking_keeps_clipx_results(corpus, queries, tmp_path,
                                               monkeypatch, residual,
                                               chunk_rows):
    """The port's PQ probe scans fixed-size chunks (the last one ragged),
    clipx's the chunks of its divisor rule: one segment a chunk, five with
    a ragged last chunk, or every probed row in one chunk all give clipx's
    results."""
    monkeypatch.setenv("CLIPX_PQ_RESIDUAL", residual)
    cache = str(tmp_path / "images.index.ivf")
    ref = jivf.IVFIndex.from_vectors(corpus, cache_path=cache, dtype="pq")
    ours = tivf.IVFIndex.from_vectors(corpus, cache_path=cache, dtype="pq",
                                      device="cpu")
    monkeypatch.setattr(tivf, "_PROBE_CHUNK_ROWS", chunk_rows)
    for nprobe in (17, 100):
        P = ours.probe_bucket(50, nprobe)
        assert (P % tivf._pq_chunk_segs(P, 64) != 0) == (
            chunk_rows == 320 and P % 5 != 0)
        for k in (1, 50):
            Dr, Ir = ref.search(queries[:5], k, nprobe=nprobe)
            D, I = ours.search(queries[:5], k, nprobe=nprobe)
            _assert_same_results(D, I, Dr, Ir)


# -- helpers equal to clipx's -----------------------------------------------------

def _probe_inputs(seed, segs=40, P=9, nq=3, width=DIM):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (segs, 64, width), dtype=np.int8)
    q_codes = rng.integers(-127, 128, (nq, 2 * width if width < DIM
                                       else width), dtype=np.int8)
    seg_idx = np.stack([rng.choice(segs, P, replace=False)
                        for _ in range(nq)]).astype(np.int32)
    return codes, q_codes, seg_idx


def test_int8_probe_scan_is_bitwise_clipx():
    codes, q_codes, seg_idx = _probe_inputs(0)
    ref = np.asarray(jnp.einsum(
        "qd,qpwd->qpw", jnp.asarray(q_codes), jnp.asarray(codes)[seg_idx],
        preferred_element_type=jnp.int32))
    ours = tivf._scan_raw_int8(torch.from_numpy(codes))(
        torch.from_numpy(seg_idx).long(), torch.from_numpy(q_codes))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.float32))


def test_int4_probe_scan_is_bitwise_clipx():
    packed, q_codes, seg_idx = _probe_inputs(1, width=DIM // 2)
    ref = np.asarray(jivf._scan_raw_int4(jnp.asarray(packed))(
        jnp.asarray(seg_idx), jnp.asarray(q_codes)))
    ours = tivf._scan_raw_int4(torch.from_numpy(packed))(
        torch.from_numpy(seg_idx).long(), torch.from_numpy(q_codes))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.float32))


def test_layout_helpers_equal_clipx():
    for p in range(1, 3000):
        assert tivf._bucket_probe(p) == jivf._bucket_probe(p)
    for P in (1, 3, 48, 512, 2048, 16384):
        for dim in (64, 512, 768):
            for k in (1, 50, 300, 4096):
                for quantized, int8 in ((False, False), (True, False),
                                        (True, True)):
                    assert tivf._qcap(P, dim, quantized, k, int8) == \
                        jivf._qcap(P, dim, quantized, k, int8)
    for n in (0, 5, 300, 4096, 1 << 20, 1 << 24):
        assert tivf._num_clusters(n) == jivf._num_clusters(n)
    rng = np.random.default_rng(3)
    assign = rng.integers(0, 37, 5000).astype(np.int32)
    layout = tivf.cluster_layout(assign)
    np.testing.assert_array_equal(layout, jivf.cluster_layout(assign))
    assert tivf.layout_digest(layout) == jivf.layout_digest(layout)
    x = _unit(np.random.RandomState(4), 5000, DIM)
    np.testing.assert_array_equal(tivf._segment_sums(x, layout, 7),
                                  jivf._segment_sums(x, layout))
    live = layout >= 0
    for tier in ("int8", "pq"):
        coded = tcodes.encode_corpus(x, tier,
                                     rot=teng.corpus_rotation(DIM))
        for a, b in zip(tivf._permute_coded(coded, layout, live, 999),
                        jivf._permute_coded(coded, layout, live)):
            np.testing.assert_array_equal(a, b)
    assert teng.content_hash(x) == jeng.content_hash(x)
    assert teng.content_hash(x[::2]) == jeng.content_hash(x[::2])


def test_residual_codes_are_byte_equal_under_one_layout(corpus):
    assign, _ = jivf.train_clusters(corpus)
    layout = jivf.cluster_layout(assign)
    sums = jivf._segment_sums(corpus, layout)
    counts = (layout >= 0).reshape(-1, 64).sum(axis=1).astype(np.float32)
    rot = teng.corpus_rotation(DIM)
    ref = jivf._encode_residual_flat(corpus, layout, sums, counts, rot)
    ours = tivf._encode_residual_flat(corpus, layout, sums, counts, rot)
    assert ours["codes"].tobytes() == ref["codes"].tobytes()
    np.testing.assert_array_equal(ours["centroids"], ref["centroids"])
    np.testing.assert_array_equal(ours["rot_matrix"], ref["rot_matrix"])


def test_cache_files_load_in_both_packages(corpus, tmp_path):
    """Array contents of the two packages' .ivf files are equal, and each
    loads the other's (the zip entries carry timestamps: the bytes of the
    two files are not compared)."""
    ours, ref = str(tmp_path / "ours.ivf"), str(tmp_path / "ref.ivf")
    assign, _ = tivf.train_clusters(corpus, device="cpu")
    layout = tivf.cluster_layout(assign)
    tivf._save_cache(ours, corpus, layout)
    jivf._save_cache(ref, corpus, layout)
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name], b[name])
    for path in (ours, ref):
        np.testing.assert_array_equal(jivf._load_cache(path, corpus), layout)
        np.testing.assert_array_equal(tivf._load_cache(path, corpus), layout)


# -- the port's own k-means ---------------------------------------------------------

def test_kmeans_layout_segments_are_cluster_pure():
    x = _clustered_corpus(1024, 32, 4, seed=4, spread=0.01)
    assign, cent = tivf.train_clusters(x, seed=0, device="cpu")
    assert assign.shape == (1024,)
    assert np.allclose(np.linalg.norm(cent, axis=1), 1.0, atol=1e-4)
    layout = tivf.cluster_layout(assign)
    assert len(layout) % 64 == 0
    assert sorted(layout[layout >= 0].tolist()) == list(range(1024))
    for seg in layout.reshape(-1, 64):
        members = seg[seg >= 0]
        assert len(set(assign[members])) <= 1
        if len(members) > 1:
            v = x[members]
            assert np.einsum("wd,vd->wv", v, v).mean() > 0.95


def test_kmeans_builds_are_deterministic(corpus):
    a, ca = tivf.train_clusters(corpus, device="cpu")
    b, cb = tivf.train_clusters(corpus, device="cpu")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    assert (tivf.layout_digest(tivf.cluster_layout(a))
            == tivf.layout_digest(tivf.cluster_layout(b)))
    # the training sample path (n > _TRAIN_CAP) too, at a small cap
    tivf_cap = tivf._TRAIN_CAP
    try:
        tivf._TRAIN_CAP = 1000
        c, _ = tivf.train_clusters(corpus, device="cpu")
        d, _ = tivf.train_clusters(corpus, device="cpu")
    finally:
        tivf._TRAIN_CAP = tivf_cap
    np.testing.assert_array_equal(c, d)


def test_port_kmeans_recall_and_full_probe(corpus, queries):
    exact = teng.VectorIndex.from_vectors(corpus, device="cpu")
    De, Ie = exact.search(queries, 10)
    idx = tivf.IVFIndex.from_vectors(corpus, device="cpu")
    assert idx.nprobe == 32
    _, Ia = idx.search(queries, 10)
    assert _recall(Ia, Ie) >= 0.95
    Df, If = idx.search(queries, 10, nprobe=100)
    assert idx.nprobe == 32  # the per-call override leaves the knob alone
    np.testing.assert_array_equal(If, Ie)
    np.testing.assert_allclose(Df, De, rtol=1e-5, atol=1e-6)


# -- the single-device cases of tests/test_ivf.py ------------------------------------

def test_nprobe_clamped_like_reference():
    idx = tivf.IVFIndex(dim=8, device="cpu")
    idx.nprobe = 0
    assert idx.nprobe == 1
    idx.nprobe = 1000
    assert idx.nprobe == 100


def test_nprobe_knob_monotonic_recall(corpus, queries):
    _, Ie = teng.VectorIndex.from_vectors(corpus, device="cpu").search(
        queries, 10)
    idx = tivf.IVFIndex.from_vectors(corpus, device="cpu")
    recalls = []
    for p in (2, 25, 100):
        idx.nprobe = p
        recalls.append(_recall(idx.search(queries, 10)[1], Ie))
    assert recalls[-1] == 1.0
    assert recalls[0] <= recalls[1] + 1e-9 <= recalls[2] + 2e-9


def test_quantized_probe_rescores_exactly(corpus, queries):
    idx = tivf.IVFIndex.from_vectors(corpus, quantized=True, device="cpu")
    D, I = idx.search(queries[:8], 5, nprobe=100)
    for qi in range(8):
        for d, i in zip(D[qi], I[qi]):
            assert i >= 0
            np.testing.assert_allclose(d, float(corpus[i] @ queries[qi]),
                                       rtol=1e-5, atol=1e-5)


def test_add_tail_merges(corpus):
    idx = tivf.IVFIndex.from_vectors(corpus, device="cpu")
    idx.nprobe = 100
    n0 = idx.ntotal
    extra = _unit(np.random.RandomState(3), 5, DIM)
    idx.add(extra)
    assert idx.ntotal == n0 + 5
    assert 0 < idx.tail_fraction < 1
    D, I = idx.search(extra[2][None], 1)
    assert I[0, 0] == n0 + 2
    np.testing.assert_allclose(idx.reconstruct(n0 + 2), extra[2], rtol=1e-6)
    np.testing.assert_allclose(idx.reconstruct(11), corpus[11], rtol=1e-6)
    v = idx.vectors()
    np.testing.assert_allclose(v[:n0], corpus, rtol=1e-6)
    np.testing.assert_allclose(v[n0:], extra, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "pq"])
def test_coded_tail_matches_clipx(corpus, queries, tmp_path, monkeypatch,
                                  dtype):
    """add() on a coded base (non-residual pq: the tail shares the base
    codebooks) gives clipx's results, the tail merged in."""
    monkeypatch.setenv("CLIPX_PQ_RESIDUAL", "off")
    cache = str(tmp_path / "images.index.ivf")
    ref = jivf.IVFIndex.from_vectors(corpus, cache_path=cache,
                                     dtype=JAX_DTYPES[dtype])
    ours = tivf.IVFIndex.from_vectors(corpus, cache_path=cache, dtype=dtype,
                                      device="cpu")
    extra = _unit(np.random.RandomState(5), 20, DIM)
    ref.add(extra)
    ours.add(extra)
    q = np.concatenate([queries[:4], extra[:3]])
    for nprobe in (1, 100):
        Dr, Ir = ref.search(q, 10, nprobe=nprobe)
        D, I = ours.search(q, 10, nprobe=nprobe)
        _assert_same_results(D, I, Dr, Ir)
    np.testing.assert_allclose(ours.vectors(), ref.vectors(), atol=1e-6,
                               rtol=0)


def test_empty_and_tiny_corpora():
    idx = tivf.IVFIndex(dim=16, device="cpu")
    D, I = idx.search(np.zeros((2, 16), np.float32), 4)
    assert (I == -1).all() and np.isneginf(D).all()
    tiny = _clustered_corpus(10, 16, 2, seed=1)
    idx = tivf.IVFIndex.from_vectors(tiny, device="cpu")
    idx.nprobe = 100
    D, I = idx.search(tiny[3][None], 20)  # k > ntotal
    assert I[0, 0] == 3
    assert (I[0, 10:] == -1).all()
    assert set(I[0, :10]) == set(range(10))


def test_tiny_corpus_low_nprobe_still_fills_k():
    rng = np.random.default_rng(7)
    tiny = rng.normal(size=(5, 16)).astype(np.float32)
    tiny /= np.linalg.norm(tiny, axis=1, keepdims=True)
    for quantized in (False, True):
        idx = tivf.IVFIndex.from_vectors(tiny, quantized=quantized,
                                         device="cpu")
        for nprobe in (1, 32):
            idx.nprobe = nprobe
            D, I = idx.search(tiny[1][None], 3)
            assert (I[0] >= 0).all() and I[0, 0] == 1
            D, I = idx.search(tiny[1][None], 5)
            assert set(I[0]) == set(range(5))


def test_probe_floor_dense_corpus_keeps_nprobe_contract():
    big = _clustered_corpus(20000, 64, 32, seed=3)
    idx = tivf.IVFIndex.from_vectors(big, device="cpu")
    floor = idx._probe_floor(50)
    assert floor < 20 and floor < idx._segs() * 0.05
    rng = np.random.default_rng(11)
    tiny = rng.normal(size=(5, 16)).astype(np.float32)
    t = tivf.IVFIndex.from_vectors(tiny, device="cpu")
    assert t._probe_floor(3) == 3 and t._probe_floor(20) == 5


def test_cache_roundtrip_and_invalidation(tmp_path, corpus):
    cache = str(tmp_path / "images.index.ivf")
    idx1 = tivf.IVFIndex.from_vectors(corpus, cache_path=cache, device="cpu")
    assert tivf._load_cache(cache, corpus) is not None
    idx2 = tivf.IVFIndex.from_vectors(corpus, cache_path=cache, device="cpu")
    q = corpus[:3]
    np.testing.assert_array_equal(idx1.search(q, 5, nprobe=17)[1],
                                  idx2.search(q, 5, nprobe=17)[1])
    other = corpus.copy()
    other[0] *= -1.0
    assert tivf._load_cache(cache, other) is None
    with open(cache, "wb") as f:
        f.write(b"garbage")
    assert tivf._load_cache(cache, corpus) is None
    idx3 = tivf.IVFIndex.from_vectors(corpus, cache_path=cache, device="cpu")
    assert idx3.ntotal == corpus.shape[0]


def test_query_chunking_matches_single(corpus):
    idx = tivf.IVFIndex.from_vectors(corpus, device="cpu")
    idx.nprobe = 50
    q = _unit(np.random.RandomState(9), 37, DIM)
    D, I = idx.search(q, 8)
    for j in range(q.shape[0]):
        np.testing.assert_array_equal(I[j], idx.search(q[j][None], 8)[1][0])


def test_pq_qcap_budgets_the_probe_chunk():
    """The pq query cap is a power of two whose probe chunks (rows times
    the LUT width) plus rescore fit the gather budget, unless one query
    alone exceeds it."""
    for P in (1, 3, 48, 512, 513, 2048, 16384):
        for mk in (64 * 8, 512 * 8, 768 * 8):
            for k in (1, 50, 300, 4096):
                qcap = tivf._qcap(P, 512, True, k, True, mk)
                assert qcap & (qcap - 1) == 0 and qcap <= tivf.engine._MAX_Q
                m_cand = min(tivf.pq_lib.PQ_RESCORE_MARGIN
                             * tivf.engine._bucket_k(k), P * 64)
                rows = tivf._pq_chunk_segs(P, 64) * 64
                per_q = mk * (rows + 4 * m_cand)
                assert qcap * per_q <= tivf._GATHER_BUDGET or qcap == 1
                assert (2 * qcap * per_q > tivf._GATHER_BUDGET
                        or qcap == tivf.engine._MAX_Q)


def test_int8_storage_full_probe_matches_oracle():
    """tests/test_ivf.py's planted-gap corpus: the dequantized rescore
    reproduces the exact ranking at nprobe 100."""
    rng = np.random.RandomState(11)
    q = _unit(rng, 1, 64)[0]
    noise = rng.randn(3000, 64).astype(np.float32)
    noise -= np.outer(noise @ q, q)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    noise = 0.9 * noise + np.outer(0.2 * rng.rand(3000).astype(np.float32),
                                   q)
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    planted = np.zeros((10, 64), np.float32)
    for i in range(10):
        s = 0.9 - i * 0.02
        r = rng.randn(64).astype(np.float32)
        r -= (r @ q) * q
        r /= np.linalg.norm(r)
        planted[i] = s * q + np.sqrt(1.0 - s * s) * r
    corpus = np.concatenate([noise, planted]).astype(np.float32)
    idx = tivf.IVFIndex.from_vectors(corpus, dtype="int8", device="cpu")
    assert idx.int8_storage and idx.quantized and idx._corpus3 is None
    D, I = idx.search(q[None], 10, nprobe=100)
    np.testing.assert_array_equal(I[0], np.arange(3000, 3010))
    np.testing.assert_allclose(D[0], (corpus @ q)[3000:], atol=5e-3)


def test_apply_search_mode_tracks_the_ivf_threshold(corpus):
    idx = tivf.IVFIndex.from_vectors(corpus, quantized=True, device="cpu")
    tcommon.apply_search_mode(idx, "ivf")
    assert idx.quantized == (idx.ntotal >= tcommon.QUANT_AUTO_THRESHOLD)


# -- the CLI load path and codes-only IVF boot -----------------------------------

def _args(index, dtype_name, search_mode="ivf"):
    return argparse.Namespace(index=index, corpus_dtype=dtype_name,
                              search_mode=search_mode, device="cpu")


@pytest.fixture
def sidecar(tmp_path, corpus):
    path = str(tmp_path / "images.index")
    w = teng.IndexWriter(path, corpus.shape[0], DIM)
    w.write(corpus)
    w.close()
    return path


def test_cli_builds_an_ivf_index(sidecar, corpus):
    idx = tcommon.build_index_from_vectors(corpus, _args(sidecar, "f32"))
    assert isinstance(idx, tivf.IVFIndex) and not idx.quantized
    assert os.path.exists(sidecar + ".ivf")
    D, I = idx.search(corpus[5][None], 3, nprobe=100)
    assert I[0, 0] == 5


@pytest.mark.parametrize("dtype_name", ["int8", "pq"])
def test_codes_only_ivf_boot_matches(sidecar, capsys, dtype_name):
    args = _args(sidecar, dtype_name)
    idx1 = tcommon.load_index(args)          # trains, saves cache + codes
    assert isinstance(idx1, tivf.IVFIndex)
    assert idx1._residual == (dtype_name == "pq")  # the default
    q = _unit(np.random.RandomState(3), 4, DIM)
    d1, i1 = idx1.search(q, 15, nprobe=100)
    os.remove(sidecar)
    idx2 = tcommon.load_index(args)
    assert "codes-only boot" in capsys.readouterr().err
    assert isinstance(idx2, tivf.IVFIndex)
    d2, i2 = idx2.search(q, 15, nprobe=100)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_codes_only_ivf_missing_cache_is_explained(sidecar):
    args = _args(sidecar, "int8")
    tcommon.load_index(args)
    os.remove(sidecar)
    os.remove(sidecar + ".ivf")
    with pytest.raises(SystemExit, match=r"\.ivf layout cache"):
        tcommon.load_index(args)


def test_codes_only_residual_needs_ivf_mode(sidecar):
    tcommon.load_index(_args(sidecar, "pq"))
    payload = tcodes.load_codes(sidecar, "pq", rotated=True)
    assert payload["residual"] is True
    assert payload["layout_digest"] is not None
    os.remove(sidecar)
    with pytest.raises(SystemExit, match="RESIDUAL"):
        tcommon.load_index(_args(sidecar, "pq", search_mode="auto"))


def test_residual_layout_digest_rejects_foreign_cache(sidecar):
    """A .ivf with another layout of the same corpus must not decode the
    residual codes: the load falls back to the f32 rebuild."""
    args = _args(sidecar, "pq")
    idx1 = tcommon.load_index(args)
    payload = tcodes.load_codes(sidecar, "pq", rotated=True)
    assert tivf._load_cache_for_codes(sidecar + ".ivf", payload) is not None
    with np.load(sidecar + ".ivf") as z:
        cache = {k: z[k] for k in z.files}
    lay = cache["layout"].copy()
    lay[:64], lay[64:128] = lay[64:128].copy(), lay[:64].copy()
    cache["layout"] = lay
    np.savez(sidecar + ".ivf.tmp", **cache)
    os.replace(sidecar + ".ivf.tmp.npz", sidecar + ".ivf")
    assert tivf._load_cache_for_codes(sidecar + ".ivf", payload) is None
    idx2 = tcommon.load_index(args)
    q = _unit(np.random.RandomState(9), 4, DIM)
    np.testing.assert_array_equal(idx1.search(q, 15, nprobe=100)[1],
                                  idx2.search(q, 15, nprobe=100)[1])


@pytest.mark.parametrize("writer", ["clipx", "port"])
def test_ivf_codes_and_cache_load_across_packages(sidecar, corpus, queries,
                                                  capsys, writer):
    """The residual codes file and the .ivf cache one package's CLI load
    path wrote boot the other package with no f32 read (the sidecar is
    removed), with the same results."""
    from clipx.cli import common as jcommon

    jargs = argparse.Namespace(index=sidecar, corpus_dtype="pq",
                               search_mode="ivf", sharded="off")
    first, second = ((jcommon, jargs), (tcommon, _args(sidecar, "pq")))
    if writer == "port":
        first, second = second, first
    built = first[0].load_index(first[1])
    os.remove(sidecar)
    booted = second[0].load_index(second[1])
    assert "codes-only boot" in capsys.readouterr().err
    assert built._residual and booted._residual
    ref, ours = (built, booted) if writer == "clipx" else (booted, built)
    for nprobe in (1, 32, 100):
        Dr, Ir = ref.search(queries[:5], 10, nprobe=nprobe)
        D, I = ours.search(queries[:5], 10, nprobe=nprobe)
        _assert_same_results(D, I, Dr, Ir)
