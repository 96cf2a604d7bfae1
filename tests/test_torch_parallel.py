"""The port's corpus-sharded search and data-parallel encode
(``clipx_torch/parallel``, ``ShardedIVFIndex``, the Encoder's ``mesh=``)
against clipx's, on the CPU.

clipx runs on ``make_mesh({"shard": 4}, jax.devices()[:4])`` (the suite's
virtual CPU devices), the port on ``make_mesh({"shard": 4}, [cpu] * 4)``:
one CPU listed four times, the port's counterpart of those virtual
devices. The same seeded numpy corpus and queries go to both.

- ``ShardedVectorIndex`` in each tier: the same ids, scores within 1e-5 +
  1e-5 * |s| (``tests/test_torch_pq.py``'s tolerance). The exact f32 and
  bf16 scans are bitwise; the rescored tiers sum their f32 scores in
  another order than XLA's, so two rows whose scores lie within ``TIE``
  of each other may come in either order (``tests/test_torch_ivf.py``'s
  rule); everything else must be identical.
- ``ShardedIVFIndex`` in every mode through one shared ``.ivf``, at nprobe
  32 and 100, held the same way.
- The dp encode at 2 and 4 positions: bitwise equal to the port's
  single-device encode, within ``tests/test_torch_runtime.py``'s 1e-5 of
  clipx's dp encode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipx.parallel import mesh as jmesh
from clipx.parallel import mips as jmips
from clipx.search import codes_io as jcodes
from clipx.search import engine as jeng
from clipx.search import ivf as jivf
from clipx_torch.parallel import mesh as tmesh
from clipx_torch.parallel import mips as tmips
from clipx_torch.search import codes_io as tcodes
from clipx_torch.search import engine as teng
from clipx_torch.search import ivf as tivf

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = RTOL = 1e-5
TIE = 2e-6
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
              "int4": jnp.int4, "pq": "pq"}
# tier -> (storage dtype, quantized scan)
TIERS = {"f32": ("f32", False), "bf16": ("bf16", False),
         "quant": ("f32", True), "int8": ("int8", False),
         "int4": ("int4", False), "pq": ("pq", False)}


def _meshes(n=4):
    return (jmesh.make_mesh({"shard": n}, jax.devices()[:n]),
            tmesh.make_mesh({"shard": n}, [CPU] * n))


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


def _assert_same(D, I, Dr, Ir, exact=False):
    """(D, I) equal to (Dr, Ir): scores within tolerance; ids identical
    (with ``exact``, everywhere; else except within a run of reference
    scores closer than TIE, where the set must agree, or for a run that
    reaches rank k, the scores)."""
    assert D.dtype == np.float32 and I.dtype == np.int64
    assert I.shape == Ir.shape
    np.testing.assert_array_equal(np.isfinite(D), np.isfinite(Dr))
    fin = np.isfinite(Dr)
    np.testing.assert_allclose(D[fin], Dr[fin], atol=ATOL, rtol=RTOL)
    if exact:
        np.testing.assert_array_equal(I, Ir)
        return
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


def _pair(v, tier, n=4):
    dtype, quantized = TIERS[tier]
    jm, tm = _meshes(n)
    return (jmips.ShardedVectorIndex(v, jm, dtype=JAX_DTYPES[dtype],
                                     quantized=quantized),
            tmips.ShardedVectorIndex(v, tm, dtype=dtype,
                                     quantized=quantized))


def _cap(idx):
    return idx._rows * idx.n_shards


def _ref_cap(ref):
    """clipx's capacity in logical rows (its pq array is lane-paired)."""
    arr = ref._codes if ref.coded_storage else ref._corpus
    pf = arr.shape[1] // ref._code_dim if ref.pq_storage else 1
    return arr.shape[0] * pf


# -- ShardedVectorIndex against clipx's ---------------------------------------

N = 1500


@pytest.fixture(scope="module")
def flat():
    v = _corpus(N, 32)
    return v, _queries(v, [3, 77, 1499, 11, 750]), {
        tier: _pair(v, tier) for tier in TIERS}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("nq,k", [(5, 50), (3, 600)])
def test_sharded_tier_matches_clipx(flat, tier, nq, k):
    """Each tier on 4 shards of 384 rows; k = 600 exceeds a shard's rows,
    so the merge takes every shard's whole list."""
    v, queries, pairs = flat
    ref, ours = pairs[tier]
    assert ours.quantized == ref.quantized and _cap(ours) == _ref_cap(ref)
    Dr, Ir = ref.search(queries[:nq], k)
    D, I = ours.search(queries[:nq], k)
    _assert_same(D, I, Dr, Ir, exact=tier in ("f32", "bf16"))
    assert (I >= 0).all() and (np.diff(D, axis=1) <= 0).all()
    if tier != "int4":
        assert I[0, 0] == 3  # a perturbed row finds itself first


@pytest.mark.parametrize("tier", ["f32", "quant", "int8"])
def test_sharded_equals_single_device(flat, tier):
    """f32 sharded is the single-device ranking bit for bit; the other
    tiers hold the single-device ids up to TIE (clipx's rescored pools
    differ only where k exceeds the segments of a shard)."""
    v, queries, pairs = flat
    dtype, quantized = TIERS[tier]
    single = teng.VectorIndex.from_vectors(v, quantized, "cpu", dtype=dtype)
    D1, I1 = single.search(queries, 20)
    D, I = pairs[tier][1].search(queries, 20)
    _assert_same(D, I, D1, I1, exact=tier == "f32")


@pytest.mark.parametrize("n,k,nq", [(777, 10, 5), (5, 10, 1), (1000, 600, 2),
                                    (777, 10, 64), (777, 10 ** 9, 1)])
def test_sharded_odd_sizes_padding_and_k(n, k, nq):
    """Odd corpus sizes (the last shard mostly padding), k beyond ntotal
    (-1 ids, -inf scores), k beyond the rows of a shard, Q beyond the
    16-query cap (split) and an absurd k (clamped to 16,384): clipx's
    results and shapes."""
    v = _corpus(n, 32, seed=n)
    q = _queries(v, np.arange(nq) % n, seed=2)
    ref, ours = _pair(v, "f32")
    Dr, Ir = ref.search(q, k)
    D, I = ours.search(q, k)
    _assert_same(D, I, Dr, Ir, exact=True)
    assert I.shape == (nq, min(k, 16384))
    assert (I < n).all() and (I[:, :min(n, k)] >= 0).all()
    assert (I[:, n:] == -1).all() and np.isneginf(D[:, n:]).all()


def test_sharded_empty_index():
    ours = tmips.ShardedVectorIndex(np.zeros((0, 32), np.float32),
                                    _meshes()[1])
    D, I = ours.search(np.ones((2, 32), np.float32), 5)
    assert (I == -1).all() and np.isneginf(D).all()
    with pytest.raises(ValueError, match="query dim 16 != index dim 32"):
        ours.search(np.ones((1, 16), np.float32), 5)


@pytest.mark.parametrize("tier", ["f32", "quant", "int8", "int4", "pq"])
def test_sharded_add_and_grow_match_clipx(tier):
    """From empty, then appends that cross the 4,096-row bucket: capacities
    (rows a shard), ids and results equal clipx's, and (but for pq, whose
    codebooks train on the first add) a fresh build's of the same rows."""
    v = _corpus(4200, 32, seed=8)
    dtype, quantized = TIERS[tier]
    jm, tm = _meshes()
    ref = jmips.ShardedVectorIndex(np.zeros((0, 32), np.float32), jm,
                                   dtype=JAX_DTYPES[dtype],
                                   quantized=quantized)
    ours = tmips.ShardedVectorIndex(np.zeros((0, 32), np.float32), tm,
                                    dtype=dtype, quantized=quantized)
    q = _queries(v, [5, 4100, 4199])
    for lo, hi in ((0, 2), (2, 4050), (4050, 4200)):
        ref.add(v[lo:hi])
        ours.add(v[lo:hi])
        assert ours.ntotal == ref.ntotal == hi
        if ref._codes is not None or not ref.coded_storage:
            assert _cap(ours) == _ref_cap(ref)
        if hi == 2:
            assert ours.search(v[:2], 1)[1][:, 0].tolist() == [0, 1]
    Dr, Ir = ref.search(q, 20)
    D, I = ours.search(q, 20)
    _assert_same(D, I, Dr, Ir, exact=tier == "f32")
    if tier in ("f32", "int8"):
        np.testing.assert_array_equal(I[:, 0], [5, 4100, 4199])
    if tier in ("f32", "quant"):
        # the coded tiers' codes depend on the first add (centre, codebooks)
        fresh = tmips.ShardedVectorIndex(v, tm, dtype=dtype,
                                         quantized=quantized)
        Df, If = fresh.search(q, 20)
        _assert_same(D, I, Df, If, exact=True)


@pytest.mark.parametrize("tier", ["int8", "int4", "pq"])
def test_from_codes_of_a_clipx_payload(tmp_path, flat, tier):
    """A ``.codes`` file that clipx wrote, placed by both packages'
    ``ShardedVectorIndex.from_codes``: the same results as clipx's, and as
    the port's index built from the f32 rows."""
    v, queries, pairs = flat
    path = str(tmp_path / "images.index")
    jeng.write_index(jeng.VectorIndex.from_vectors(v), path)
    jcodes.write_codes_file(path, v, tier,
                            rot=jeng.corpus_rotation(v.shape[1]))
    jm, tm = _meshes()
    ref = jmips.ShardedVectorIndex.from_codes(
        jcodes.load_codes(path, tier, rotated=True), jm)
    ours = tmips.ShardedVectorIndex.from_codes(
        tcodes.load_codes(path, tier, rotated=True), tm)
    assert ours.ntotal == N and _cap(ours) == _ref_cap(ref)
    Dr, Ir = ref.search(queries, 50)
    D, I = ours.search(queries, 50)
    _assert_same(D, I, Dr, Ir)
    Db, Ib = pairs[tier][1].search(queries, 50)
    _assert_same(D, I, Db, Ib, exact=True)


@pytest.mark.parametrize("tier", ["f32", "int8", "pq"])
def test_ties_across_shards_come_out_lowest_id_first(tier):
    """40 distinct rows, each stored 40 times and shuffled over 4 shards:
    equal rows score exactly equal, and the merge keeps clipx's order; in
    the exact tier, lowest id first across shards, as clipx's all_gather +
    lax.top_k orders them."""
    base = _corpus(40, 32, seed=12)
    v = np.tile(base, (40, 1))
    v = v[np.random.RandomState(13).permutation(len(v))]
    q = _queries(base, [0, 1, 2])
    ref, ours = _pair(v, tier)
    Dr, Ir = ref.search(q, 150)
    D, I = ours.search(q, 150)
    np.testing.assert_array_equal(I, Ir)
    tie = D[:, :-1] == D[:, 1:]
    assert tie.sum() > 100
    assert len(set((I[0, :40] // ours._rows).tolist())) == 4
    if tier == "f32":
        assert (I[:, :-1][tie] < I[:, 1:][tie]).all()


# -- ShardedIVFIndex against clipx's, one shared .ivf -----------------------

def _clustered_corpus(n, dim, n_clusters, seed=0, spread=0.05):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_clusters, dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.randint(n_clusters, size=n)
    x = centers[which] + spread * rng.randn(n, dim).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


# clipx's probe modes: f32 (bf16 storage takes it too), quant, int8 and
# int4 storage, pq storage and residual pq
IVF_TIERS = {"f32": ("f32", False, "off"), "f32_quant": ("f32", True, "off"),
             "int8": ("int8", False, "off"),
             "int4": ("int4", False, "off"), "pq": ("pq", False, "off"),
             "pq_residual": ("pq", False, "on")}


@pytest.fixture(scope="module")
def ivf_corpus(tmp_path_factory):
    v = _clustered_corpus(1500, 32, 12)
    rng = np.random.RandomState(7)
    q = v[rng.choice(len(v), 9, replace=False)]
    q = q + 0.01 * rng.randn(*q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cache = str(tmp_path_factory.mktemp("ivf") / "images.index.ivf")
    jivf.IVFIndex.from_vectors(v, cache_path=cache)  # clipx's k-means
    return v, q.astype(np.float32), cache


@pytest.mark.parametrize("tier", list(IVF_TIERS))
def test_sharded_ivf_matches_clipx(ivf_corpus, tier, monkeypatch):
    """Both packages deal clipx's layout over 4 shards (the segment count
    does not divide evenly, so a shard holds dead alignment segments) and
    answer alike at nprobe 32 (k 10) and 100 (k 50)."""
    v, q, cache = ivf_corpus
    dtype, quantized, residual = IVF_TIERS[tier]
    monkeypatch.setenv("CLIPX_PQ_RESIDUAL", residual)
    jm, tm = _meshes()
    ref = jivf.ShardedIVFIndex.from_vectors(
        v, quantized=quantized, dtype=JAX_DTYPES[dtype], cache_path=cache,
        mesh=jm)
    ours = tivf.ShardedIVFIndex.from_vectors(
        v, quantized=quantized, dtype=dtype, cache_path=cache, mesh=tm)
    np.testing.assert_array_equal(ours._row_ext, ref._row_ext)
    assert ours._segs() == ref._segs() and ours._segs() % 4 == 0
    assert ours._residual == (residual == "on")
    for nprobe, k in ((32, 10), (100, 50)):
        Dr, Ir = ref.search(q, k, nprobe=nprobe)
        D, I = ours.search(q, k, nprobe=nprobe)
        _assert_same(D, I, Dr, Ir)
    if tier == "f32":
        # the full probe is the single-device ranking, bit for bit
        single = tivf.IVFIndex.from_vectors(v, dtype=dtype,
                                            cache_path=cache, device="cpu")
        D1, I1 = single.search(q, 50, nprobe=100)
        D, I = ours.search(q, 50, nprobe=100)
        _assert_same(D, I, D1, I1, exact=True)


def test_sharded_ivf_rows_add_and_codes_boot(tmp_path, ivf_corpus):
    """vectors() and reconstruct() in external id order through the deal;
    add() goes to the exact tail; a codes file + .ivf boots the sharded
    index through the CLI plumbing (--sharded on, one CPU shard)."""
    import argparse

    from clipx_torch.cli import common

    v, q, cache = ivf_corpus
    ours = tivf.ShardedIVFIndex.from_vectors(v, cache_path=cache,
                                             mesh=_meshes(3)[1])
    np.testing.assert_array_equal(ours.vectors(), v)
    np.testing.assert_array_equal(ours.reconstruct(123), v[123])
    extra = _corpus(7, 32, seed=3)
    ours.add(extra)
    assert ours.ntotal == len(v) + 7
    D, I = ours.search(extra[4][None], 3, nprobe=100)
    assert I[0, 0] == len(v) + 4
    np.testing.assert_array_equal(ours.reconstruct(len(v) + 4), extra[4])

    path = str(tmp_path / "images.index")
    w = teng.IndexWriter(path, len(v), v.shape[1])
    w.write(v)
    w.close()
    args = argparse.Namespace(index=path, corpus_dtype="int8",
                              search_mode="ivf", sharded="on",
                              device="cpu")
    first = common.load_index(args)
    again = common.load_index(args)  # from images.index.codes + .ivf
    assert isinstance(first, tivf.ShardedIVFIndex)
    assert isinstance(again, tivf.ShardedIVFIndex)
    np.testing.assert_array_equal(again.search(q, 10)[1],
                                  first.search(q, 10)[1])


# -- the data-parallel encode -------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    """Seeded tiny-test params in clipx's layout (numpy), which both
    packages' Encoders take."""
    from clipx_torch import config as tcfg
    from clipx_torch.models import convert

    return convert.init_params(tcfg.get_config("tiny-test"), 0)


def _encoders(params, dp, **kw):
    from clipx import config as jcfg
    from clipx.runtime.encoder import Encoder as JEncoder
    from clipx_torch import config as tcfg
    from clipx_torch.runtime.encoder import Encoder as TEncoder

    jm = jmesh.make_mesh({"dp": dp}, jax.devices()[:dp])
    tm = tmesh.make_mesh({"dp": dp}, [CPU] * dp)
    return (JEncoder(jcfg.get_config("tiny-test"), params, mesh=jm, **kw),
            TEncoder(tcfg.get_config("tiny-test"), params, device="cpu",
                     mesh=tm, **kw),
            TEncoder(tcfg.get_config("tiny-test"), params, device="cpu",
                     **kw))


# The dp encode against the single-device encode on the CPU. Each share is
# the same arithmetic on fewer rows, but a CPU BLAS may pick its GEMM kernel
# by the row count: MKL on an AVX-512 host takes another kernel for at most
# 3 rows, whose sums run in another order, so the last product of the tower
# (the (B, 64) @ (64, 32) projection) differs in its last bits when a share
# holds 2 rows and the whole bucket 8. Measured: at most 1.19e-7 on these
# unit-norm embeddings (1 ulp at 1.0). 1e-6 is 8 ulps at 1.0: room for every
# product of the tower to round the other way, a tenth of the 1e-5 that
# holds the port to clipx. On the card the dp encode is bitwise (phase
# sharded of chip_smoke.py and tests/test_torch_cuda.py).
CPU_DP_ATOL = 1e-6


@pytest.mark.parametrize("dp,compute", [(2, None), (4, None), (4, "int8")])
def test_dp_encode_bitwise_matches_single_device(tiny_params, dp, compute):
    """20 images (bucket 32 at dp 4 and 2) and the 37-px canvases of
    --preprocess device (bucket 8: 2 rows a share at dp 4): the dp encode
    equals the single-device encode within CPU_DP_ATOL (bitwise on the
    card), and clipx's dp encode within 1e-5."""
    ref, dp_enc, single = _encoders(tiny_params, dp, compute_quant=compute)
    rng = np.random.RandomState(dp)
    batch = rng.randint(0, 256, (20, 32, 32, 3), dtype=np.uint8)
    out = dp_enc.encode_images(batch)
    np.testing.assert_allclose(out, single.encode_images(batch),
                               atol=CPU_DP_ATOL, rtol=0)
    np.testing.assert_allclose(out, ref.encode_images(batch), atol=1e-5,
                               rtol=0)
    canvases = rng.randint(0, 256, (6, 37, 37, 3), dtype=np.uint8)
    np.testing.assert_allclose(dp_enc.encode_images(canvases),
                               single.encode_images(canvases),
                               atol=CPU_DP_ATOL, rtol=0)


def test_dp_encode_shares_are_even(tiny_params, monkeypatch):
    """Buckets are multiples of 2 * dp, and each position encodes one even
    share on its device, in row order (clipx's shard_map over P("dp"))."""
    from clipx_torch.models import clip as tclip

    _, enc, _ = _encoders(tiny_params, 4)
    assert all(b % 8 == 0 for b in enc.buckets)
    assert len(enc._params_on) == 1  # one replica a distinct device
    seen = []
    real = tclip.encode_image
    monkeypatch.setattr(tclip, "encode_image", lambda p, c, x, **k: (
        seen.append(x.shape[0]), real(p, c, x, **k))[1])
    handle = enc.encode_images_async(np.zeros((3, 32, 32, 3), np.uint8))
    assert seen == [2, 2, 2, 2] and handle[0].shape[0] == 8
    assert enc.finalize(handle).shape == (3, 32)


def test_make_mesh_validates_like_clipx():
    """The size check keeps clipx's message; a tp axis builds a mesh and the
    Encoder's tp= a TP encoder over it."""
    from clipx_torch import config as tcfg
    from clipx_torch.models import convert as tconvert
    from clipx_torch.runtime.encoder import Encoder as TEncoder

    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh({"dp": 3}, jax.devices()[:8])
    with pytest.raises(ValueError) as ours:
        tmesh.make_mesh({"dp": 3}, [CPU] * 8)
    assert str(ours.value) == str(ref.value)
    tp_mesh = tmesh.make_mesh({"dp": 4, "tp": 2}, [CPU] * 8)
    assert tp_mesh.shape == {"dp": 4, "tp": 2} and tp_mesh.size == 8
    cfg = tcfg.get_config("tiny-test")
    enc = TEncoder(cfg, tconvert.init_params(cfg, 0), mesh=tp_mesh,
                   tp="tp")
    assert enc.attn_impl == "plain" and enc.params.tp == "tp"
    with pytest.raises(ValueError, match="'shard' axis"):
        tmips.ShardedVectorIndex(np.zeros((4, 8), np.float32),
                                 tmesh.make_mesh({"dp": 2}, [CPU] * 2))
