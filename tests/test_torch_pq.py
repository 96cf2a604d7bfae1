"""The port's coded tiers (bf16, int8, int4, pq) and its PQ scan against
clipx's, on the CPU.

- B11's plain version against clipx's Pallas ``pq_scan_scores`` in
  interpret mode, int8 and bf16 LUTs: bitwise (integer sums).
- Host-side encoders (rotation, centre, int8/int4 quantizers, PQ codebook
  training and encoding, trained OPQ): byte-identical outputs.
- ``VectorIndex`` search per tier against clipx's ``VectorIndex`` of the
  same dtype, a few thousand rows, Q in {1, 5}: identical ids, scores
  within 1e-5 + 1e-5*|s| (f32 summation order; the largest difference
  observed in ``test_tier_search_matches_clipx`` is 3.0e-7, int8 and int4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipx.ops.pq_scan import pq_scan_scores as jax_pq_scan
from clipx.search import engine as jeng
from clipx.search import pq as jpq
from clipx_torch.ops import _launch
from clipx_torch.ops import pq_scan as tscan
from clipx_torch.search import engine as teng
from clipx_torch.search import pq as tpq

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

ATOL = RTOL = 1e-5
JAX_DTYPES = {"bf16": jnp.bfloat16, "int8": jnp.int8, "int4": jnp.int4,
              "pq": "pq"}


def _corpus(n, d=64, seed=0):
    rng = np.random.RandomState(seed)
    # anisotropic, CLIP-like: a few directions carry most energy
    spec = np.arange(1, d + 1, dtype=np.float32) ** -0.75
    v = rng.randn(n, d).astype(np.float32) * spec
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _queries(v, rows, seed=1):
    rng = np.random.RandomState(seed)
    q = v[rows] + 0.05 * rng.randn(len(rows), v.shape[1]).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _same_results(ref, ours, queries, k):
    Dr, Ir = ref.search(queries, k)
    Do, Io = ours.search(queries, k)
    assert Do.dtype == np.float32 and Io.dtype == np.int64
    assert Io.shape == Ir.shape == (len(queries), k)
    np.testing.assert_array_equal(Io, Ir)
    np.testing.assert_allclose(Do, Dr, atol=ATOL, rtol=RTOL)
    return Do, Io


# -- (a) B11's plain version against the Pallas kernel -----------------------

@pytest.mark.parametrize("lut_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("n,dim,q", [(256, 64, 4), (2048, 32, 16),
                                     (256, 96, 1), (512, 48, 8),
                                     (256, 40, 9), (256, 96, 16)])
def test_plain_scan_matches_pallas_bitwise(n, dim, q, lut_dtype):
    rng = np.random.default_rng(n + dim + q)
    half = dim // 2 // 2
    packed = rng.integers(-128, 128, size=(n, half)).astype(np.int8)
    luti = rng.integers(-127, 128, size=(q, half * 2 * 16)).astype(np.int8)
    jdt, tdt = ((jnp.int8, torch.int8) if lut_dtype == "int8"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_pq_scan(jnp.asarray(packed),
                                  jnp.asarray(luti.T, jdt), interpret=True))
    lut_t = torch.from_numpy(np.ascontiguousarray(luti.T)).to(tdt)
    before = dict(_launch.LAUNCHES)
    got = tscan.pq_scan_scores(torch.from_numpy(packed), lut_t)
    assert _launch.LAUNCHES == before  # CPU tensors launch no kernel
    assert got.dtype == torch.float32 and got.shape == (q, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tscan.pq_scan_scores_plain(torch.from_numpy(packed), lut_t).numpy(),
        want)


def test_plain_scan_chunks_rows(monkeypatch):
    """The plain version's row chunking changes nothing."""
    rng = np.random.default_rng(3)
    packed = torch.from_numpy(rng.integers(-128, 128, (1000, 16),
                                           dtype=np.int8))
    lut = torch.from_numpy(rng.integers(-127, 128, (512, 5), dtype=np.int8))
    whole = tscan.pq_scan_scores_plain(packed, lut)
    monkeypatch.setattr(tscan, "_PLAIN_CHUNK", 96)
    assert torch.equal(tscan.pq_scan_scores_plain(packed, lut), whole)


def test_scan_refuses_bad_shapes_and_non_cpu_tensors(monkeypatch):
    def plain_called(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    with pytest.raises(ValueError, match="lut rows"):
        tscan.pq_scan_scores(torch.zeros((4, 8), dtype=torch.int8),
                             torch.zeros((100, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="int8 or integer-valued"):
        tscan.pq_scan_scores(torch.zeros((4, 8), dtype=torch.int8),
                             torch.zeros((256, 2)))
    with pytest.raises(ValueError, match="1 to 16 queries"):
        tscan.pq_scan_scores(torch.zeros((4, 8), dtype=torch.int8),
                             torch.zeros((256, 17), dtype=torch.int8))
    monkeypatch.setattr(tscan, "pq_scan_scores_plain", plain_called)
    before = dict(_launch.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel for device"):
        tscan.pq_scan_scores(torch.empty((4, 8), dtype=torch.int8,
                                         device="meta"),
                             torch.empty((256, 2), dtype=torch.int8,
                                         device="meta"))
    assert _launch.LAUNCHES == before


def test_scan_library_load_raises_without_nvcc(monkeypatch):
    """The kernel's library is built at first use and a failed build
    raises; nothing falls back. It is a source of the build."""
    from clipx_torch.ops import _build

    def no_build(name):
        raise RuntimeError("nvcc not found")

    assert "pq_scan" in _build.SOURCES
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_launch, "_fns", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _launch.c_fn("pq_scan", "clipx_pq_scan", [])


# -- (b) host-side encoders, byte for byte --------------------------------------

@pytest.mark.parametrize("dim", [64, 128])
def test_rotation_and_center_match_clipx(dim):
    v = _corpus(700, dim)
    rot_t, rot_j = teng._rotation_matrix(dim), jeng._rotation_matrix(dim)
    assert rot_t.tobytes() == rot_j.tobytes()
    for rot in (None, rot_j):
        assert (teng.corpus_center(v, rot, chunk=256).tobytes()
                == jeng.corpus_center(v, rot, chunk=256).tobytes())


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("rotate,center", [(False, False), (True, False),
                                           (True, True)])
def test_scalar_quantizers_match_clipx(int4, rotate, center):
    v = _corpus(1500, 64, seed=4)
    rot = jeng._rotation_matrix(64) if rotate else None
    cen = jeng.corpus_center(v, rot) if center else None
    ct, st = teng.quantize_rows_rotated(v, rot, int4, chunk=512, center=cen)
    cj, sj = jeng.quantize_rows_rotated(v, rot, int4, chunk=512, center=cen)
    assert ct.tobytes() == cj.tobytes() and st.tobytes() == sj.tobytes()
    if int4:
        np.testing.assert_array_equal(teng.unpack_int4_host(ct),
                                      jeng.unpack_int4_host(cj))


@pytest.mark.parametrize("dsub", ["2", "4"])
def test_pq_codebook_and_opq_match_clipx(dsub, monkeypatch):
    monkeypatch.setenv("CLIPX_PQ_DSUB", dsub)
    v = _corpus(800, 32, seed=5)
    rot = jeng._rotation_matrix(32)
    cb_t = tpq.PQCodebook.train(v, rot=rot)
    cb_j = jpq.PQCodebook.train(v, rot=rot)
    assert cb_t.centroids.tobytes() == cb_j.centroids.tobytes()
    assert (cb_t.encode(v, rot=rot, chunk=300).tobytes()
            == cb_j.encode(v, rot=rot, chunk=300).tobytes())
    codes = cb_j.encode(v)
    np.testing.assert_array_equal(cb_t.decode(codes), cb_j.decode(codes))
    # 800 rows >= 4 * 32: the trained OPQ rotation runs
    r_t, opq_t = tpq.train_opq(v, rot, iters=3)
    r_j, opq_j = jpq.train_opq(v, rot, iters=3)
    assert r_t.tobytes() == r_j.tobytes()
    assert opq_t.centroids.tobytes() == opq_j.centroids.tobytes()


def test_pack_round_trips_match_clipx():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, size=(13, 22)).astype(np.uint8)
    p = tpq.pack_codes4(codes)
    assert p.tobytes() == jpq.pack_codes4(codes).tobytes()
    np.testing.assert_array_equal(tpq.unpack_codes4_host(p), codes)
    np.testing.assert_array_equal(
        tscan.unpack_codes4(torch.from_numpy(p)).numpy(), codes)
    signed = rng.integers(-8, 8, size=(9, 20)).astype(np.int8)
    packed = teng.pack_int4(signed)
    assert packed.tobytes() == jeng.pack_int4(signed).tobytes()
    np.testing.assert_array_equal(
        teng._unpack_int4(torch.from_numpy(packed)).numpy(), signed)


def test_quantized_luts_match_clipx():
    """The int8 LUT that picks the candidates is equal to clipx's on these
    inputs; the f32 LUT agrees within 2 ulps (the order XLA's CPU dot
    sums the dsub products in depends on the shape; differences of 1 ulp
    were observed at Q = 5)."""
    v = _corpus(600, 64, seed=6)
    q = _queries(v, [1, 2, 3, 4, 5])
    cent = jpq.PQCodebook.train(v).centroids
    lut_j, luti_j, scale_j = jpq.quantized_luts(jnp.asarray(q),
                                                jnp.asarray(cent))
    lut_t, luti_t, scale_t = tpq.quantized_luts(torch.from_numpy(q),
                                                torch.from_numpy(cent))
    np.testing.assert_array_equal(luti_t.numpy(), np.asarray(luti_j))
    np.testing.assert_allclose(lut_t.numpy(), np.asarray(lut_j), rtol=0,
                               atol=2 * np.spacing(np.float32(1.0)))
    np.testing.assert_allclose(scale_t.numpy(), np.asarray(scale_j),
                               rtol=2e-7)


# -- (c) VectorIndex per tier against clipx ---------------------------------------

N = 5000


@pytest.fixture(scope="module")
def corpus():
    v = _corpus(N, 64, seed=7)
    return v, _queries(v, [3, 77, 4000, 11, 2500])


@pytest.fixture(scope="module")
def index_pairs(corpus):
    v, _ = corpus
    return {dt: (jeng.VectorIndex.from_vectors(v, dtype=JAX_DTYPES[dt]),
                 teng.VectorIndex.from_vectors(v, device="cpu", dtype=dt))
            for dt in JAX_DTYPES}


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4", "pq"])
@pytest.mark.parametrize("nq,k", [(1, 10), (5, 50), (5, 200)])
def test_tier_search_matches_clipx(corpus, index_pairs, dtype, nq, k):
    _, queries = corpus
    ref, ours = index_pairs[dtype]
    assert ours.coded_storage == (dtype != "bf16")
    assert ours.quantized == ref.quantized
    D, I = _same_results(ref, ours, queries[:nq], k)
    if dtype in ("int8", "pq"):
        # a perturbed row finds itself first
        assert I[0, 0] == 3
    assert (np.diff(D, axis=1) <= 0).all()


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4", "pq"])
def test_tier_rows_match_clipx(index_pairs, dtype):
    """vectors() and reconstruct(): the same user-space rows (decoded,
    centre added back, unrotated) as clipx's."""
    ref, ours = index_pairs[dtype]
    np.testing.assert_array_equal(ours.vectors(), ref.vectors())
    for row in (0, 1234, N - 1):
        np.testing.assert_array_equal(ours.reconstruct(row),
                                      ref.reconstruct(row))
    if dtype in ("int8", "int4"):
        assert ours._center.tobytes() == ref._center.tobytes()
        np.testing.assert_array_equal(
            ours._codes[:N].numpy(), np.asarray(ref._codes[:N]))


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4", "pq"])
def test_exact_ties_come_out_lowest_index_first(dtype):
    """40 distinct rows, each stored 100 times: equal codes give exactly
    equal scores, and every tier orders the ties as clipx's lax.top_k does
    (lowest index first), across the segment and candidate selections."""
    base = _corpus(40, 32, seed=12)
    v = np.tile(base, (100, 1))
    rng = np.random.RandomState(13)
    v = v[rng.permutation(len(v))]
    q = _queries(base, [0, 1, 2])
    ref = jeng.VectorIndex.from_vectors(v, dtype=JAX_DTYPES[dtype])
    ours = teng.VectorIndex.from_vectors(v, device="cpu", dtype=dtype)
    D, I = _same_results(ref, ours, q, 150)
    tie = D[:, :-1] == D[:, 1:]
    assert tie.sum() > 100
    assert (I[:, :-1][tie] < I[:, 1:][tie]).all()


def test_bf16_quant_mode_matches_clipx(corpus):
    """bf16 storage under --search-mode quant: int8 scan of the upcast
    rows, rescored from the bf16 rows in f32."""
    v, queries = corpus
    ref = jeng.VectorIndex.from_vectors(v, dtype=jnp.bfloat16,
                                        quantized=True)
    ours = teng.VectorIndex.from_vectors(v, True, "cpu", dtype="bf16")
    _same_results(ref, ours, queries, 50)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "int4", "pq"])
def test_add_then_grow_across_a_bucket_edge(dtype):
    """4,000 rows, then appends that cross the 4,096-row bucket twice:
    capacities, ids and results match clipx's."""
    v = _corpus(9000, 32, seed=8)
    jdt = {"f32": jnp.float32, **JAX_DTYPES}[dtype]
    ref = jeng.VectorIndex(32, dtype=jdt)
    ours = teng.VectorIndex(32, device="cpu", dtype=dtype)
    for lo, hi in ((0, 4000), (4000, 4050), (4050, 4200), (4200, 9000)):
        ref.add(v[lo:hi])
        ours.add(v[lo:hi])
        cap = (ours._codes if ours.coded_storage else ours._corpus).shape[0]
        if dtype != "pq":  # clipx's pq array is lane-paired on the TPU
            ref_arr = ref._codes if ref.coded_storage else ref._corpus
            assert cap == ref_arr.shape[0]
        assert ours.ntotal == ref.ntotal == hi
    q = _queries(v, [5, 4100, 8999])
    D, I = _same_results(ref, ours, q, 20)
    if dtype in ("f32", "bf16", "int8"):
        np.testing.assert_array_equal(I[:, 0], [5, 4100, 8999])


def test_pq_chunked_scan_matches_clipx(monkeypatch):
    """Past the one-shot limit the pq scan runs in chunks, keeps each
    chunk's top candidates and merges them. Both packages chunked at 2,048
    rows over an 8,192-row capacity give the same results, equal to the
    one-shot scan's."""
    v = _corpus(7000, 32, seed=9)
    q = _queries(v, [1, 2, 6500, 3, 4])
    ref = jeng.VectorIndex.from_vectors(v, dtype="pq")
    ours = teng.VectorIndex.from_vectors(v, device="cpu", dtype="pq")
    one_d, one_i = _same_results(ref, ours, q, 25)
    monkeypatch.setattr(jpq, "_PQ_CHUNK", 2048)
    monkeypatch.setattr(tpq, "_PQ_PALLAS_ONESHOT", 1024)
    monkeypatch.setattr(tpq, "_PQ_PALLAS_CHUNK", 2048)
    monkeypatch.setattr(tpq, "_PQ_SCORE_BLOCK", 8 * 2048)  # Q bucket 8
    jpq._search_kernel_pq.clear_cache()
    try:
        D, I = _same_results(ref, ours, q, 25)
    finally:
        jpq._search_kernel_pq.clear_cache()
    np.testing.assert_array_equal(I, one_i)
    np.testing.assert_allclose(D, one_d, atol=ATOL, rtol=RTOL)


# the scan chunk at the placement's capacities: 2^24 rows as the table of
# Q buckets halves it, any capacity up to 2^21 rows whole at every Q bucket,
# and a capacity of an odd number of 2^19 chunks past the Q's block
_CHUNK_TABLE = (
    [(1 << 24, q, c) for q, c in ((1, 1 << 24), (2, 1 << 24), (4, 1 << 23),
                                  (8, 1 << 22), (16, 1 << 21))]
    + [(n, q, n) for n in (4096, 1 << 20, (1 << 20) + (1 << 19), 1 << 21)
       for q in (1, 2, 4, 8, 16)]
    + [(5 << 19, 16, 1 << 19), (12 << 19, 8, 6 << 19), (12 << 19, 16, 1 << 21),
       (1 << 22, 16, 1 << 21)])


@pytest.mark.parametrize("n,nq,chunk", _CHUNK_TABLE)
def test_scan_chunk_by_q_bucket_and_capacity(n, nq, chunk):
    """A chunk is the whole capacity while (Q, n) f32 scores fit 128 MiB,
    else the largest 2^19 multiple dividing it that fits."""
    got = tpq._scan_chunk(n, nq)
    assert got == chunk and n % got == 0
    assert nq * got <= tpq._PQ_SCORE_BLOCK == 1 << 25


def test_scan_chunk_refuses_an_unaligned_capacity_past_the_block():
    with pytest.raises(ValueError, match="not a chunk multiple"):
        tpq._scan_chunk((1 << 22) + 4096, 16)


def _random_pq(n, dim, seed):
    rng = np.random.default_rng(seed)
    m = dim // 2
    packed = torch.from_numpy(
        rng.integers(-128, 128, (n, m // 2), dtype=np.int8))
    cent = torch.from_numpy(
        (0.1 * rng.standard_normal((m, tpq.PQ_K, 2))).astype(np.float32))
    return packed, cent


@pytest.mark.parametrize("base", [0, 3 << 15], ids=["single", "shard"])
@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("nq,chunks", [(1, 1), (3, 2), (16, 8)])
def test_pq_topk_by_q_bucket_chunks_equals_the_fixed_chunks(
        monkeypatch, nq, chunks, k, base):
    """``_pq_topk`` over 32 units of 1,024 rows, the block two capacities
    (2^25 against 2^24 rows, scaled down): 1 scan at Q = 1, 2 at Q = 3 and 8
    at Q = 16 give (D, I) bitwise those of the fixed 32 chunks of clipx's
    rule (a block of one unit a query), with rows past ``valid`` masked and
    ids offset by ``base`` as a shard's are."""
    n = 32 * 1024
    packed, cent = _random_pq(n, 64, seed=nq * 100 + k)
    q = torch.from_numpy(_corpus(nq, 64, seed=k + nq))
    valid = base + n - 1500
    scans = []

    def counted(p, lut_t):
        scans.append(p.shape[0])
        return tscan.pq_scan_scores(p, lut_t)

    monkeypatch.setattr(tpq, "pq_scan_scores", counted)
    monkeypatch.setattr(tpq, "_PQ_PALLAS_CHUNK", 1024)

    def run(block):
        monkeypatch.setattr(tpq, "_PQ_SCORE_BLOCK", block)
        scans.clear()
        d, i = tpq._pq_topk(packed, cent, valid, q, k, base=base)
        return d.numpy(), i.numpy(), list(scans)

    d_new, i_new, new_scans = run(2 * n)
    d_old, i_old, old_scans = run(nq * 1024)
    assert new_scans == [n // chunks] * chunks
    assert old_scans == [1024] * 32
    np.testing.assert_array_equal(i_new, i_old)
    np.testing.assert_array_equal(d_new, d_old)
    assert d_new.shape == (nq, k)
    assert ((i_new >= base) & (i_new < valid)).all()


def test_int4_chunked_scan_matches_one_shot(corpus, index_pairs,
                                            monkeypatch):
    """The int4 scan's row chunking changes nothing: 1,024-row chunks over
    the 8,192-row capacity give clipx's one-shot results."""
    _, queries = corpus
    ref, ours = index_pairs["int4"]
    monkeypatch.setattr(teng, "_INT4_CHUNK", 1024)
    _same_results(ref, ours, queries, 50)


@pytest.mark.parametrize("knob,dtype", [("CLIPX_CORPUS_ROTATE", "int8"),
                                        ("CLIPX_CODED_CENTER", "int4"),
                                        ("CLIPX_PQ_OPQ", "pq")])
def test_encoding_knobs_off_match_clipx(knob, dtype, monkeypatch):
    monkeypatch.setenv(knob, "off" if knob != "CLIPX_PQ_OPQ" else "fixed")
    v = _corpus(3000, 32, seed=10)
    q = _queries(v, [0, 1500])
    ref = jeng.VectorIndex.from_vectors(v, dtype=JAX_DTYPES[dtype])
    ours = teng.VectorIndex.from_vectors(v, device="cpu", dtype=dtype)
    _same_results(ref, ours, q, 30)


def test_pq_dsub4_matches_clipx(monkeypatch):
    monkeypatch.setenv("CLIPX_PQ_DSUB", "4")
    v = _corpus(3000, 64, seed=11)
    q = _queries(v, [7, 8])
    ref = jeng.VectorIndex.from_vectors(v, dtype="pq")
    ours = teng.VectorIndex.from_vectors(v, device="cpu", dtype="pq")
    assert ours._code_dim == 8 and ours._pq.dsub == 4
    _same_results(ref, ours, q, 16)


def test_coded_tier_rejects_what_clipx_rejects():
    with pytest.raises(ValueError, match="pq storage needs dim"):
        teng.VectorIndex(10, device="cpu", dtype="pq")
    with pytest.raises(ValueError, match="even dim"):
        teng.VectorIndex(9, device="cpu", dtype="int4")
    with pytest.raises(ValueError, match="unknown corpus dtype"):
        teng.VectorIndex(8, device="cpu", dtype="fp8")
    empty = teng.VectorIndex(16, device="cpu", dtype="int8")
    D, I = empty.search(np.zeros((2, 16), np.float32), 3)
    assert (I == -1).all() and np.isneginf(D).all()
    assert empty.vectors().shape == (0, 16)
