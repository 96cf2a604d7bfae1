"""The port's capacity and maintenance tools (clipx_torch/tools/) on the CPU,
against the root tools/ scripts that run clipx's modules.

- find_dupes: tests/test_find_dupes.py's cases, and the same groups in the
  same order as clipx's on the same vectors;
- make_synth_index and load_timing: tests/test_capacity_tools.py's case,
  the same sidecar bytes and id map as clipx's tool, CLIPX_CODES restored;
- kv_tool: stat, verify, compact, check-index and drop-f32 (with its three
  refusals: no codes, stale codes, no footer; and residual pq without its
  .ivf) printing clipx's stdout on the same store and files;
- build_codes_direct: tests/test_direct_build.py's case, the generator
  bit-identical to clipx's, and each package booting the other's
  codes-only deployment with equal (D, I).
"""

import argparse
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from clipx.cli import common as jcommon
from clipx_torch.cli import build_index as tbuild
from clipx_torch.cli import common as tcommon
from clipx_torch.search import codes_io as tcodes
from clipx_torch.search.engine import IndexWriter
from clipx_torch.tools import (build_codes_direct, find_dupes, kv_tool,
                               load_timing, make_synth_index)
from tests.test_torch_ivf import _assert_same_results
from tools import build_codes_direct as jbcd
from tools import find_dupes as jfind_dupes
from tools import kv_tool as jkv_tool
from tools import load_timing as jload_timing
from tools import make_synth_index as jmake_synth_index

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# -- find_dupes ---------------------------------------------------------------

def _dupe_corpus():
    rng = np.random.default_rng(0)
    base_a = _unit(rng.normal(size=32).astype(np.float32))
    base_b = _unit(rng.normal(size=32).astype(np.float32))
    clus_a = _unit(base_a + 1e-3 * rng.normal(size=(5, 32)
                                              ).astype(np.float32))
    clus_b = _unit(base_b + 1e-3 * rng.normal(size=(3, 32)
                                              ).astype(np.float32))
    singles = _unit(rng.normal(size=(20, 32)).astype(np.float32))
    return np.concatenate([clus_a, clus_b, singles])


def test_dupe_groups_finds_clusters_and_respects_threshold():
    corpus = _dupe_corpus()
    groups = find_dupes.dupe_groups(corpus, threshold=0.99, device="cpu")
    sizes = sorted(len(m) for m, _ in groups)
    assert sizes == [3, 5]
    members = {frozenset(m) for m, _ in groups}
    assert frozenset(range(5)) in members
    assert frozenset(range(5, 8)) in members
    for _, mean in groups:
        assert mean >= 0.99
    assert find_dupes.dupe_groups(corpus, threshold=1.0, device="cpu") == []
    assert find_dupes.dupe_groups(corpus[:0], threshold=0.9,
                                  device="cpu") == []


@pytest.mark.parametrize("k", [2, 4, 16])
def test_dupe_groups_equal_clipx(k):
    """The same groups, members in the same order, on planted cliques of
    several sizes among singletons (scores within f32 rounding)."""
    rng = np.random.default_rng(5)
    parts = []
    for size in (12, 6, 3, 2):
        base = _unit(rng.normal(size=32).astype(np.float32))
        parts.append(_unit(base + 1e-3 * rng.normal(size=(size, 32))
                           .astype(np.float32)))
    parts.append(_unit(rng.normal(size=(40, 32)).astype(np.float32)))
    corpus = np.concatenate(parts)[rng.permutation(63)]
    ours = find_dupes.dupe_groups(corpus, threshold=0.99, k=k, batch=16,
                                  device="cpu")
    ref = jfind_dupes.dupe_groups(corpus, threshold=0.99, k=k, batch=16)
    assert [m for m, _ in ours] == [m for m, _ in ref]
    np.testing.assert_allclose([s for _, s in ours], [s for _, s in ref],
                               atol=1e-6)


def test_dupe_groups_transitive_beyond_k():
    rng = np.random.default_rng(1)
    base = _unit(rng.normal(size=32).astype(np.float32))
    clique = _unit(base + 1e-3 * rng.normal(size=(12, 32)
                                            ).astype(np.float32))
    corpus = np.concatenate(
        [clique, _unit(rng.normal(size=(10, 32)).astype(np.float32))])
    groups = find_dupes.dupe_groups(corpus, threshold=0.99, k=4,
                                    device="cpu")
    assert len(groups) == 1 and len(groups[0][0]) == 12


def test_find_dupes_cli_over_built_index(tmp_path, monkeypatch, capsys):
    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.RandomState(2)
    img = rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
    Image.fromarray(img).save(photos / "a.png")
    Image.fromarray(img).save(photos / "b.png")  # exact duplicate
    Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                    ).save(photos / "c.png")
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    assert tbuild.main(["--model", "tiny-test", *CPU,
                        str(photos) + os.sep]) == 0
    capsys.readouterr()
    rc = find_dupes.main(["--threshold", "0.999", *CPU])
    out = capsys.readouterr().out
    assert rc == 0
    assert "group of 2" in out
    assert "a.png" in out and "b.png" in out and "c.png" not in out
    assert jfind_dupes.main(["--threshold", "0.999"]) == 0
    assert capsys.readouterr().out == out
    assert find_dupes.main(["--threshold", "1.5", *CPU]) == 1


# -- make_synth_index and load_timing ----------------------------------------

def test_make_synth_index_and_load_timing(tmp_path, capsys):
    out = str(tmp_path / "cap")
    assert make_synth_index.main([out, "--rows", "3000", "--dim", "64",
                                  "--store", "ids"]) == 0
    index = os.path.join(out, "images.index")
    from clipx_torch.search.engine import read_index_vectors
    from clipx_torch.store.kv import open_env

    v = read_index_vectors(index)
    assert v.shape == (3000, 64)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-4)
    env = open_env(os.path.join(out, "vectors.lmdb"))
    idx_db = env.open_db(b"idx_db")
    with env.begin(db=idx_db) as txn:
        assert txn.get(b"0") is not None
        assert txn.get(b"2999") is not None
    env.close()
    prev = os.environ.get("CLIPX_CODES")
    jpath = str(tmp_path / "lt.json")
    assert load_timing.main(["--index", index, "--corpus-dtype", "int8",
                             "--cold", "--json", jpath, *CPU]) == 0
    assert os.environ.get("CLIPX_CODES") == prev   # restored on exit
    cold = json.load(open(jpath))
    assert cold["mode"] == "cold" and cold["ntotal"] == 3000
    assert cold["platform"] == "cpu"
    assert os.path.exists(index + ".codes")
    assert load_timing.main(["--index", index, "--corpus-dtype", "int8",
                             "--query", "--json", jpath, *CPU]) == 0
    warm = json.load(open(jpath))
    assert warm["mode"] == "warm"
    assert warm["query_p50_ms"] > 0
    capsys.readouterr()
    # clipx's tool reports the same keys over the same files
    assert jload_timing.main(["--index", index, "--corpus-dtype", "int8",
                              "--json", jpath]) == 0
    assert set(json.load(open(jpath))) == set(cold)
    assert "(loaded 3000 int8 rows" in capsys.readouterr().err


def test_load_timing_pq_query(tmp_path, monkeypatch):
    """load_timing loads and searches the pq deployment; with --sharded on
    (as clipx's) it loads the row-sharded index, one CPU shard here."""
    from clipx_torch.parallel.mips import ShardedVectorIndex

    index = str(tmp_path / "images.index")
    _write_sidecar(index, _unit(np.random.default_rng(4).standard_normal(
        (2000, 32)).astype(np.float32)))
    jpath = str(tmp_path / "lt.json")
    assert load_timing.main(["--index", index, "--corpus-dtype", "pq",
                             "--query", "--json", jpath, *CPU]) == 0
    out = json.load(open(jpath))
    assert out["corpus_dtype"] == "pq" and out["query_p50_ms"] > 0
    assert os.path.exists(index + ".codes")
    loaded = []
    real = tcommon.load_index
    monkeypatch.setattr(tcommon, "load_index",
                        lambda args: loaded.append(real(args)) or loaded[-1])
    assert load_timing.main(["--index", index, "--corpus-dtype", "pq",
                             "--sharded", "on", "--query", "--json", jpath,
                             *CPU]) == 0
    sharded = json.load(open(jpath))
    assert isinstance(loaded[0], ShardedVectorIndex)
    assert loaded[0].n_shards == 1 and loaded[0].ntotal == 2000
    assert sharded["ntotal"] == out["ntotal"] and sharded["query_p50_ms"] > 0


@pytest.mark.parametrize("store,kind", [("full", "clustered"),
                                        ("none", "aniso")])
def test_make_synth_index_bytes_equal_clipx(tmp_path, capsys, store, kind):
    """The same seed writes the same sidecar bytes and the same store
    entries as clipx's tool."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    flags = ["--rows", "1500", "--dim", "32", "--store", store, "--kind",
             kind, "--seed", "3"]
    assert make_synth_index.main([a, *flags]) == 0
    ours = capsys.readouterr().out
    assert jmake_synth_index.main([b, *flags]) == 0
    ref = capsys.readouterr().out
    assert ours.split("content_hash=")[1] == ref.split("content_hash=")[1]
    with open(os.path.join(a, "images.index"), "rb") as f:
        sidecar = f.read()
    with open(os.path.join(b, "images.index"), "rb") as f:
        assert f.read() == sidecar
    if store == "none":
        assert not os.path.exists(os.path.join(a, "vectors.lmdb"))
        return
    from clipx_torch.store.kv import open_env

    def entries(path):
        env = open_env(os.path.join(path, "vectors.lmdb"))
        out = {}
        for name in (b"idx_db", b"fn_db"):
            with env.begin(db=env.open_db(name)) as txn:
                out[name] = list(txn.cursor())
        env.close()
        return out

    assert entries(a) == entries(b)


# -- kv_tool ------------------------------------------------------------------

def _write_sidecar(path, rows):
    writer = IndexWriter(path, *rows.shape)
    writer.write(rows)
    writer.close()


def _both(capsys, argv):
    """(port rc, port stdout, clipx rc, clipx stdout) of one command."""
    rc = kv_tool.main(argv)
    out = capsys.readouterr().out
    jrc = jkv_tool.main(argv)
    return rc, out, jrc, capsys.readouterr().out


@pytest.fixture()
def built_store(tmp_path, monkeypatch, capsys):
    """A tiny-test build by the port's indexer (with garbage for compaction:
    a second build over one more photo), in the working directory."""
    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.RandomState(0)
    for n in ("a.jpg", "b.jpg", "c.jpg"):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(photos / n)
    work = tmp_path / "w"
    work.mkdir()
    monkeypatch.chdir(work)
    assert tbuild.main(["--model", "tiny-test", *CPU,
                        str(photos) + os.sep]) == 0
    Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                    ).save(photos / "d.jpg")
    assert tbuild.main(["--model", "tiny-test", *CPU,
                        str(photos) + os.sep]) == 0
    capsys.readouterr()
    return work


def test_kv_tool_stat_verify_check_index_print_clipx(built_store, capsys):
    for argv in (["stat", "vectors.lmdb"], ["verify", "vectors.lmdb"],
                 ["check-index", "vectors.lmdb"],
                 ["stat", "missing.lmdb"]):
        rc, out, jrc, jout = _both(capsys, argv)
        assert (rc, out) == (jrc, jout), argv
    assert "verify: OK" in _both(capsys, ["verify", "vectors.lmdb"])[1]
    assert "check-index: OK (4 rows" in _both(
        capsys, ["check-index", "vectors.lmdb"])[1]


def test_kv_tool_compact_prints_clipx(built_store, capsys):
    shutil.copytree("vectors.lmdb", "copy.lmdb")
    rc = kv_tool.main(["compact", "vectors.lmdb"])
    out = capsys.readouterr().out
    assert jkv_tool.main(["compact", "copy.lmdb"]) == rc == 0
    assert capsys.readouterr().out == out
    assert out.startswith("compacted: ")
    rc, out, jrc, jout = _both(capsys, ["stat", "vectors.lmdb"])
    assert rc == 0 and "generation" in out


def test_kv_tool_check_index_stale(built_store, capsys):
    from clipx_torch.store import kv as kv_mod

    env = kv_mod.open_env("vectors.lmdb")
    fn_db = env.open_db(b"fn_db")
    with env.begin(db=fn_db, write=True) as txn:
        txn.put(b"zzz_new.jpg", np.zeros(32, np.float32).tobytes())
    env.close()
    rc, out, jrc, jout = _both(capsys, ["check-index", "vectors.lmdb"])
    assert rc == jrc == 2 and out == jout and "STALE" in out


def _strip_footer(cpath):
    """Rewrite a codes file as one written before the self-integrity
    footer (tests/test_codes_only.py's recipe)."""
    parsed = tcodes._read_meta(cpath)
    meta = dict(parsed[0])
    meta.pop("self")
    blob = json.dumps(meta, sort_keys=True).encode()
    raw = open(cpath, "rb").read()
    old_len = struct.unpack(
        "<I", raw[len(tcodes._MAGIC):len(tcodes._MAGIC) + 4])[0]
    body = raw[tcodes._HDR_FIXED + old_len: -tcodes._SELF_LEN]
    with open(cpath, "wb") as f:
        f.write(tcodes._MAGIC + struct.pack("<I", len(blob))
                + raw[len(tcodes._MAGIC) + 4: tcodes._HDR_FIXED]
                + blob + body)


def _load(index, tier, mode="auto"):
    return tcommon.load_index(argparse.Namespace(
        index=index, corpus_dtype=tier, search_mode=mode, sharded="off",
        device="cpu"))


def test_drop_f32_prints_clipx_and_refuses_as_clipx(tmp_path, monkeypatch,
                                                     capsys):
    """drop-f32 on a pq deployment, with each refusal first: no codes
    file, stale codes, a codes file without the footer, residual pq
    without its .ivf; every stdout and exit code clipx's."""
    rows = _unit(np.random.default_rng(7).standard_normal(
        (3000, 32)).astype(np.float32))
    monkeypatch.chdir(tmp_path)
    index = "images.index"
    _write_sidecar(index, rows)
    argv = ["drop-f32", "--index", index]

    def refused(what):
        rc, out, jrc, jout = _both(capsys, argv)
        assert rc == jrc == 2 and out == jout, (what, out, jout)
        assert out.startswith("REFUSING") and os.path.exists(index)

    refused("no codes file")
    _load(index, "pq")                           # flat pq codes
    stale = rows.copy()
    stale[0] *= -1.0
    _write_sidecar(index, stale)
    refused("stale codes")
    _write_sidecar(index, rows)
    _strip_footer(tcodes.codes_path(index))
    refused("no footer")
    os.remove(tcodes.codes_path(index))
    _load(index, "pq", mode="ivf")               # residual pq + .ivf
    shutil.move(index + ".ivf", "saved.ivf")
    refused("residual pq without its .ivf")
    shutil.move("saved.ivf", index + ".ivf")
    # both tools drop the sidecar of identical deployments, in two dirs
    for d in ("port", "clipx"):
        os.makedirs(d)
        for name in (index, index + ".codes", index + ".ivf"):
            shutil.copy(name, os.path.join(d, name))
    outs = []
    for d, tool in (("port", kv_tool), ("clipx", jkv_tool)):
        monkeypatch.chdir(tmp_path / d)
        assert tool.main(argv) == 0
        outs.append(capsys.readouterr().out)
        assert not os.path.exists(index)
        assert tool.main(argv) == 0              # already absent
        assert "already absent" in capsys.readouterr().out
    assert outs[0] == outs[1] and "codes-only" in outs[0]
    # the port boots what is left, codes-only
    assert _load(index, "pq", mode="ivf").ntotal == 3000


# -- build_codes_direct -------------------------------------------------------

ROWS = 120_000
DIM = 64
CROSS_ROWS, CROSS_DIM = 40_000, 32


def _direct(tool, outdir, rows, dim, extra=()):
    assert tool.main([outdir, "--rows", str(rows), "--dim", str(dim),
                      "--dsub", "2", "--store", "none",
                      "--json", os.path.join(outdir, "build.json"),
                      *extra]) == 0
    return outdir


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return _direct(build_codes_direct,
                   str(tmp_path_factory.mktemp("direct")), ROWS, DIM, CPU)


def _port_args(outdir):
    return argparse.Namespace(index=os.path.join(outdir, "images.index"),
                              corpus_dtype="pq", search_mode="ivf",
                              sharded="off", device="cpu")


def test_generator_is_deterministic_and_clipx_s(built):
    c1 = build_codes_direct.SynthCorpus(ROWS, DIM, "clustered", 0)
    c2 = build_codes_direct.SynthCorpus(ROWS, DIM, "clustered", 0)
    ref = jbcd.SynthCorpus(ROWS, DIM, "clustered", 0)
    np.testing.assert_array_equal(c1.chunk(0), c2.chunk(0))
    np.testing.assert_array_equal(c1.chunk(0), ref.chunk(0))
    idx = np.array([5, 131073 % ROWS, 7, 5])
    np.testing.assert_array_equal(c1.rows_at(idx), c2.rows_at(idx))
    np.testing.assert_array_equal(c1.rows_at(idx), ref.rows_at(idx))
    np.testing.assert_array_equal(c1.rows_at(np.arange(10)),
                                  c1.chunk(0)[:10])
    a = build_codes_direct.SynthCorpus(1000, 16, "aniso", 2)
    np.testing.assert_array_equal(
        a.chunk(0), jbcd.SynthCorpus(1000, 16, "aniso", 2).chunk(0))


def test_artifacts_stats_and_codes_only_boot(built):
    from clipx_torch.search.ivf import IVFIndex

    index = os.path.join(built, "images.index")
    assert not os.path.exists(index)          # never materialized
    assert os.path.exists(index + ".codes")
    assert os.path.exists(index + ".ivf")
    payload = tcodes.load_codes(index, "pq", rotated=True, orphan=True)
    assert payload is not None
    assert payload["residual"] is True
    assert payload["layout_digest"] is not None
    idx = tcommon.load_index(_port_args(built))
    assert isinstance(idx, IVFIndex)
    assert idx._residual and idx.ntotal == ROWS
    stats = json.load(open(os.path.join(built, "build.json")))
    for key in ("rows", "dim", "n_clusters", "assign_agreement", "pass_a_s",
                "pass_b_s", "pq_train_s", "pass_c_s", "codes_gib",
                "total_s", "peak_rss_gib"):
        assert key in stats, key
    assert stats["rows"] == ROWS and stats["dsub"] == 2
    assert os.environ.get("CLIPX_PQ_DSUB") is None   # restored


# queries of the self-match and recall check. tests/test_direct_build.py
# draws 64, and the self-match rate it bounds (0.8) sits within one
# standard error of a 64-query estimate (~0.047 at the true ~0.83): the
# same corpus built under different k-means seeds measured 0.72 to 0.97 on
# those 64 and 0.82 to 0.85 on 256 (1024 queries: 0.828 for this build,
# 0.837 for clipx's layout). So the band is held on 256 queries.
SELF_QUERIES = 256


def test_self_match_and_recall(built):
    """tests/test_direct_build.py's bands: self-match at rank 0, within the
    top 10, and recall@50 against exact search over the regenerated rows."""
    from clipx_torch.search.engine import VectorIndex

    idx = tcommon.load_index(_port_args(built))
    corpus = build_codes_direct.SynthCorpus(ROWS, DIM, "clustered", 0)
    rng = np.random.default_rng(3)
    qids = rng.choice(ROWS, SELF_QUERIES, replace=False)
    q = corpus.rows_at(qids)
    _, Ip = idx.search(q, 50, nprobe=100)
    self1 = float(np.mean(Ip[:, 0] == qids))
    assert self1 >= 0.8, self1
    self10 = float(np.mean((Ip[:, :10] == qids[:, None]).any(axis=1)))
    assert self10 >= 0.95, self10
    full = np.concatenate([corpus.chunk(c)
                           for c in range(corpus.n_chunks())])
    exact = VectorIndex.from_vectors(full, device="cpu")
    _, Ie = exact.search(q, 50)
    recall = np.mean([len(set(Ie[i]) & set(Ip[i])) / 50
                      for i in range(len(q))])
    assert recall >= 0.7, recall


def test_each_package_boots_the_other_s_direct_build(built,
                                                     tmp_path_factory):
    """The two tools' deployments differ (their k-means start from
    different seeds), so parity is cross-loading: each package boots each
    deployment codes-only and gives the same (D, I)."""
    jdir = _direct(jbcd, str(tmp_path_factory.mktemp("jdirect")),
                   CROSS_ROWS, CROSS_DIM)
    for outdir, rows, dim in ((built, ROWS, DIM),
                              (jdir, CROSS_ROWS, CROSS_DIM)):
        corpus = build_codes_direct.SynthCorpus(rows, dim, "clustered", 0)
        q = corpus.rows_at(np.random.default_rng(9).choice(rows, 16,
                                                           replace=False))
        ours = tcommon.load_index(_port_args(outdir))
        ref = jcommon.load_index(argparse.Namespace(
            index=os.path.join(outdir, "images.index"), corpus_dtype="pq",
            search_mode="ivf", sharded="off"))
        assert ours.ntotal == ref.ntotal == rows
        for nprobe in (8, 100):
            D, I = ours.search(q, 20, nprobe=nprobe)
            Dr, Ir = ref.search(q, 20, nprobe=nprobe)
            _assert_same_results(D, I, np.asarray(Dr), np.asarray(Ir))


def test_tools_take_the_card_unless_the_cpu_is_asked_for(tmp_path,
                                                         monkeypatch):
    """Without --device the tools that run on a device take cuda, and with
    no GPU visible they raise (no silent move to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = str(tmp_path / "images.index")
    _write_sidecar(index, _dupe_corpus())
    with pytest.raises(SystemExit, match="no CUDA device"):
        load_timing.main(["--index", index])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        find_dupes.dupe_groups(_dupe_corpus(), threshold=0.99)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_codes_direct.main([str(tmp_path / "d"), "--rows", "1000",
                                 "--dim", "16"])
