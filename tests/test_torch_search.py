"""The port's search engine and stores against clipx's, on the CPU.

- ``VectorIndex`` exact and quant (int8 segment scan + exact f32 rescore)
  on a 20,500-row corpus, so the segment top-k and the int8 scan both
  run: identical ``I``, ``D`` within 1e-5 (f32 summation order).
- ``images.index``: the same bytes from either package's writer.
- ``vectors.lmdb``: written by either package's store, read by the other.
"""

import numpy as np
import pytest
import torch

from clipx.search import engine as jeng
from clipx.store import kv as jkv
from clipx_torch.search import engine as teng
from clipx_torch.store import kv as tkv

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

N, DIM = 20_500, 64


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(0)
    base = _unit(rng, N, DIM)
    # a few near-duplicate clusters, as real photo collections have
    base[100:110] = base[5] + 0.01 * rng.randn(10, DIM).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    queries = np.concatenate([base[[5, 17, 20_000]] + 0.05 * rng.randn(
        3, DIM).astype(np.float32), _unit(rng, 2, DIM)])
    return base, queries


@pytest.fixture(scope="module")
def indexes(corpus):
    base, _ = corpus
    return (jeng.VectorIndex.from_vectors(base),
            teng.VectorIndex.from_vectors(base, device="cpu"))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [1, 50, 300])
def test_search_matches_clipx(corpus, indexes, quantized, k):
    _, queries = corpus
    ref_idx, our_idx = indexes
    ref_idx.quantized = our_idx.quantized = quantized
    Dr, Ir = ref_idx.search(queries, k)
    Do, Io = our_idx.search(queries, k)
    assert Do.dtype == np.float32 and Io.dtype == np.int64
    assert Io.shape == Ir.shape == (len(queries), k)
    np.testing.assert_array_equal(Io, Ir)
    np.testing.assert_allclose(Do, Dr, atol=1e-5, rtol=0)


def test_small_index_pads_like_clipx():
    """k past ntotal: -inf scores and id -1, in both; queries past the Q
    cap split into several calls; ids continue across adds."""
    rng = np.random.RandomState(1)
    a, b = _unit(rng, 7, 16), _unit(rng, 5, 16)
    queries = _unit(rng, 20, 16)
    ref = jeng.VectorIndex(16)
    ours = teng.VectorIndex(16, device="cpu")
    for idx in (ref, ours):
        idx.add(a)
        idx.add(b)
    for quantized in (False, True):
        ref.quantized = ours.quantized = quantized
        Dr, Ir = ref.search(queries, 20)
        Do, Io = ours.search(queries, 20)
        np.testing.assert_array_equal(Io, Ir)
        assert (Io[:, 12:] == -1).all()
        np.testing.assert_allclose(Do, Dr, atol=1e-5, rtol=0)
    for i, row in enumerate(np.concatenate([a, b])):
        np.testing.assert_array_equal(ours.reconstruct(i), row)
    with pytest.raises(IndexError):
        ours.reconstruct(12)


def test_int8_quantization_matches_clipx(corpus):
    base, _ = corpus
    ref_codes, ref_scales = jeng.quantize_rows(base)
    codes, scales = teng._quantize_device(torch.from_numpy(base))
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    np.testing.assert_allclose(scales.numpy(), ref_scales, rtol=1e-7)


def test_index_file_bytes_match_clipx(tmp_path):
    rng = np.random.RandomState(2)
    rows = _unit(rng, 300, 32)
    paths = {}
    for name, mod in (("ref", jeng), ("ours", teng)):
        paths[name] = str(tmp_path / f"{name}.index")
        w = mod.IndexWriter(paths[name], 300, 32)
        w.write(rows[:128])
        w.write(rows[128:])
        w.close()
    with open(paths["ref"], "rb") as f:
        ref_bytes = f.read()
    with open(paths["ours"], "rb") as f:
        assert f.read() == ref_bytes
    # and each package reads the other's file
    idx = teng.read_index(paths["ref"], device="cpu")
    assert (idx.ntotal, idx.dim) == (300, 32)
    np.testing.assert_array_equal(idx.reconstruct(299), rows[299])
    np.testing.assert_array_equal(jeng.read_index_vectors(paths["ours"]),
                                  rows)


@pytest.mark.parametrize("writer,reader", [(tkv, jkv), (jkv, tkv)])
def test_vectors_lmdb_readable_by_the_other_package(tmp_path, writer,
                                                    reader):
    rng = np.random.RandomState(3)
    vecs = {f"/photos/img{i:03d}.jpg".encode(): _unit(rng, 1, 32)[0]
            for i in range(50)}
    path = str(tmp_path / "vectors.lmdb")
    env = writer.open_env(path, map_size=1 << 30, max_dbs=4)
    fn_db, skip_db = env.open_db(b"fn_db"), env.open_db(b"skip_db")
    with env.begin(db=fn_db, write=True) as txn:
        for key, v in vecs.items():
            txn.put(key, v.tobytes())
    with env.begin(db=skip_db, write=True) as txn:
        txn.put(b"/photos/broken.jpg", b"1")
    env.close()

    env = reader.open_env(path)
    fn_db, skip_db = env.open_db(b"fn_db"), env.open_db(b"skip_db")
    with env.begin(db=fn_db) as txn:
        assert txn.stat()["entries"] == len(vecs)
        keys = [key for key, _ in txn.cursor()]
        assert keys == sorted(vecs)
        for key, v in vecs.items():
            np.testing.assert_array_equal(
                np.frombuffer(txn.get(key), np.float32), v)
    with env.begin(db=skip_db) as txn:
        assert txn.get(b"/photos/broken.jpg") == b"1"
    env.close()
