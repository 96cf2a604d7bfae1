"""The port's ``<index>.codes`` file and coded-index loading against clipx's,
on the CPU.

- A port-written codes file equals a clipx-written one byte for byte, per
  tier, and each package loads the other's file to the same ``(D, I)``.
- The flat cases of ``tests/test_codes_io.py`` and
  ``tests/test_codes_only.py``, run against the port: staleness, mismatched
  settings, corrupt and truncated files, verify modes, the CLI load path
  writing then using the file, codes-only boot, the self-integrity footer,
  residual-pq refusal in flat mode and the TOCTOU discard.
- ``--search-mode ivf`` with pq storage: the IVF build writes its codes
  (residual or not) and ``.ivf``, which the next start loads in either
  package.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from clipx.cli import common as jcommon
from clipx.search import codes_io as jcodes
from clipx.search import engine as jeng
from clipx_torch.cli import common as tcommon
from clipx_torch.search import codes_io as tcodes
from clipx_torch.search import engine as teng

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

DIM = 64
N = 3000
TIERS = ["int8", "int4", "pq"]


def _corpus(n=N, d=DIM, seed=0):
    rng = np.random.RandomState(seed)
    spec = np.arange(1, d + 1, dtype=np.float32) ** -0.75
    v = rng.randn(n, d).astype(np.float32) * spec
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _write_sidecar(path, vectors):
    w = teng.IndexWriter(path, vectors.shape[0], vectors.shape[1])
    w.write(vectors)
    w.close()
    return w.content_hash


def _args(index, dtype_name, search_mode="auto"):
    return argparse.Namespace(index=index, corpus_dtype=dtype_name,
                              search_mode=search_mode, sharded="off",
                              device="cpu")


@pytest.fixture
def sidecar(tmp_path):
    path = str(tmp_path / "images.index")
    v = _corpus()
    return path, v, _write_sidecar(path, v)


def _write(mod, eng, path, v, tier, ch):
    mod.write_codes_file(path, np.asarray(v), tier,
                         rot=eng.corpus_rotation(v.shape[1]),
                         content_hash=ch)
    with open(mod.codes_path(path), "rb") as f:
        return f.read()


@pytest.mark.parametrize("tier", TIERS)
def test_codes_file_bytes_match_clipx(sidecar, tier):
    path, v, ch = sidecar
    ref = _write(jcodes, jeng, path, v, tier, ch)
    ours = _write(tcodes, teng, path, v, tier, ch)
    assert ours == ref
    # the streamed writer and the in-RAM payload writer agree too
    payload = tcodes.encode_corpus(v, tier, rot=teng.corpus_rotation(DIM))
    os.remove(tcodes.codes_path(path))
    tcodes.write_payload_file(path, payload, tier=tier, content_hash=ch)
    with open(tcodes.codes_path(path), "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("writer", ["clipx", "port"])
def test_codes_cross_load(sidecar, tier, writer):
    """Either package's file loads into both, and both search it to the
    same (D, I); the loaded index equals a fresh build from f32."""
    path, v, ch = sidecar
    if writer == "clipx":
        _write(jcodes, jeng, path, v, tier, ch)
    else:
        _write(tcodes, teng, path, v, tier, ch)
    pj = jcodes.load_codes(path, tier, rotated=True)
    pt = tcodes.load_codes(path, tier, rotated=True)
    assert pj is not None and pt is not None
    ref = jeng.VectorIndex.from_codes(pj)
    ours = teng.VectorIndex.from_codes(pt, device="cpu")
    fresh = teng.VectorIndex.from_vectors(v, device="cpu", dtype=tier)
    q = _corpus(5, DIM, seed=2)
    Dr, Ir = ref.search(q, 20)
    Do, Io = ours.search(q, 20)
    Df, If = fresh.search(q, 20)
    np.testing.assert_array_equal(Io, Ir)
    np.testing.assert_allclose(Do, Dr, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(If, Io)
    np.testing.assert_array_equal(Df, Do)
    np.testing.assert_array_equal(ours.vectors(), fresh.vectors())


def test_stale_after_sidecar_change(sidecar):
    path, v, ch = sidecar
    _write(tcodes, teng, path, v, "int8", ch)
    assert tcodes.load_codes(path, "int8", rotated=True) is not None
    _write_sidecar(path, np.concatenate([v, _corpus(10, DIM, seed=3)]))
    assert tcodes.load_codes(path, "int8", rotated=True) is None


def test_mismatches_invalidate(sidecar):
    path, v, ch = sidecar
    _write(tcodes, teng, path, v, "int4", ch)
    assert tcodes.load_codes(path, "int8", rotated=True) is None
    assert tcodes.load_codes(path, "int4", rotated=False) is None
    assert tcodes.load_codes(path, "int4", rotated=True) is not None


def test_corrupt_and_truncated_files(sidecar):
    path, v, ch = sidecar
    cpath = tcodes.codes_path(path)
    _write(tcodes, teng, path, v, "pq", ch)
    with open(cpath, "rb") as f:
        raw = f.read()
    with open(cpath, "wb") as f:
        f.write(raw[: len(raw) // 2])
    assert tcodes.load_codes(path, "pq", rotated=True) is None
    with open(cpath, "wb") as f:
        f.write(b"garbage" * 10)
    assert tcodes.load_codes(path, "pq", rotated=True) is None


def test_verify_modes(sidecar, monkeypatch):
    """An interior sidecar edit that keeps head, tail and row count evades
    the sampled fingerprint; CLIPX_CODES_VERIFY=full catches it, and off
    skips the check."""
    path, v, ch = sidecar
    big = _corpus(70_000 * 2 + 10, 8, seed=4)
    tcodes.write_codes_file(path, big, "int8",
                            content_hash=_write_sidecar(path, big))
    edited = big.copy()
    edited[70_000] += 0.5
    _write_sidecar(path, edited)
    assert tcodes.load_codes(path, "int8", rotated=False) is not None
    monkeypatch.setenv("CLIPX_CODES_VERIFY", "full")
    assert tcodes.load_codes(path, "int8", rotated=False) is None
    monkeypatch.setenv("CLIPX_CODES_VERIFY", "off")
    _write_sidecar(path, _corpus(5, 8, seed=5))
    assert tcodes.load_codes(path, "int8", rotated=False) is not None


@pytest.mark.parametrize("tier", TIERS)
def test_load_index_writes_then_uses_codes(sidecar, tier, capsys):
    """First start: no codes file, so the CLI load path encodes from f32,
    writes the file (the same bytes clipx's start writes) and serves. Second
    start: loads the file and says so on stderr."""
    path, v, ch = sidecar
    idx1 = tcommon.load_index(_args(path, tier))
    cpath = tcodes.codes_path(path)
    with open(cpath, "rb") as f:
        ours = f.read()
    os.remove(cpath)
    jcommon.load_index(argparse.Namespace(index=path, corpus_dtype=tier,
                                          search_mode="auto",
                                          sharded="off"))
    with open(cpath, "rb") as f:
        assert f.read() == ours
    capsys.readouterr()
    idx2 = tcommon.load_index(_args(path, tier))
    assert (f"(loaded {N} {tier} rows from {cpath})"
            in capsys.readouterr().err)
    q = _corpus(3, DIM, seed=6)
    d1, i1 = idx1.search(q, 10)
    d2, i2 = idx2.search(q, 10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_codes_off_and_uncoded_tiers_keep_the_f32_path(sidecar, monkeypatch):
    path, v, ch = sidecar
    idx = tcommon.load_index(_args(path, "bf16"))
    assert idx.dtype == "bf16" and not idx.coded_storage
    assert idx._corpus.dtype == torch.bfloat16
    monkeypatch.setenv("CLIPX_CODES", "off")
    idx = tcommon.load_index(_args(path, "int8"))
    assert idx.int8_storage
    assert not os.path.exists(tcodes.codes_path(path))


def test_refresh_rewrites(sidecar, monkeypatch):
    path, v, ch = sidecar
    tcommon.load_index(_args(path, "int8"))
    cpath = tcodes.codes_path(path)
    before = os.path.getmtime(cpath)
    os.utime(cpath, (before - 100, before - 100))
    monkeypatch.setenv("CLIPX_CODES", "refresh")
    tcommon.load_index(_args(path, "int8"))
    assert os.path.getmtime(cpath) > before - 100


@pytest.mark.parametrize("residual", ["off", "on"])
def test_search_mode_ivf_loads_an_ivf_index(sidecar, monkeypatch, capsys,
                                            residual):
    """--search-mode ivf with pq storage: the first start builds the IVF
    index from the sidecar and writes its codes (residual by default) and
    the .ivf cache; the next start loads both, in the port and in clipx,
    to the same results."""
    from clipx_torch.search.ivf import IVFIndex

    monkeypatch.setenv("CLIPX_PQ_RESIDUAL", residual)
    path, v, ch = sidecar
    args = _args(path, "pq", search_mode="ivf")
    built = tcommon.load_index(args)
    assert isinstance(built, IVFIndex) and built.pq_storage
    assert built._residual == (residual == "on")
    assert os.path.exists(path + ".ivf")
    payload = tcodes.load_codes(path, "pq", rotated=True)
    assert payload["residual"] == (residual == "on")
    capsys.readouterr()
    loaded = tcommon.load_index(args)
    assert f"(loaded {N} pq rows from" in capsys.readouterr().err
    ref = jcommon.load_index(argparse.Namespace(
        index=path, corpus_dtype="pq", search_mode="ivf", sharded="off"))
    assert f"(loaded {N} pq rows from" in capsys.readouterr().err
    q = _corpus(5, DIM, seed=4)
    for nprobe in (1, 32, 100):
        D1, I1 = built.search(q, 20, nprobe=nprobe)
        D2, I2 = loaded.search(q, 20, nprobe=nprobe)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_array_equal(D1, D2)
        Dr, Ir = ref.search(q, 20, nprobe=nprobe)
        np.testing.assert_array_equal(I2, Ir)
        np.testing.assert_allclose(D2, Dr, atol=1e-5, rtol=0)


# -- codes-only boot ------------------------------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_codes_only_flat_boot_matches(sidecar, tier, capsys):
    path, v, ch = sidecar
    idx1 = tcommon.load_index(_args(path, tier))
    q = _corpus(4, DIM, seed=2)
    d1, i1 = idx1.search(q, 15)
    os.remove(path)
    idx2 = tcommon.load_index(_args(path, tier))
    assert "codes-only boot" in capsys.readouterr().err
    d2, i2 = idx2.search(q, 15)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_codes_only_clipx_file_boots_in_the_port(sidecar, capsys):
    """A clipx deployment with its sidecar dropped boots in the port."""
    path, v, ch = sidecar
    jcommon.load_index(argparse.Namespace(index=path, corpus_dtype="pq",
                                          search_mode="auto", sharded="off"))
    os.remove(path)
    idx = tcommon.load_index(_args(path, "pq"))
    assert "codes-only boot: loaded 3000 pq rows" in capsys.readouterr().err
    D, I = idx.search(v[:3], 1)
    np.testing.assert_array_equal(I[:, 0], [0, 1, 2])


def test_codes_only_missing_both_files_errors(tmp_path):
    path = str(tmp_path / "images.index")
    with pytest.raises(FileNotFoundError):
        tcommon.load_index(_args(path, "int8"))


def test_self_integrity_footer_detects_damage(sidecar, monkeypatch):
    """With the sidecar absent, the footer is the check: the sampled fp
    catches damage in the head rows, the full hash interior damage."""
    path, v, ch = sidecar
    big = _corpus(140_000, 8, seed=7)
    tcodes.write_codes_file(path, big, "int8",
                            rot=teng.corpus_rotation(8),
                            content_hash=_write_sidecar(path, big))
    os.remove(path)
    cpath = tcodes.codes_path(path)
    parsed = tcodes._read_meta(cpath)
    data_off = parsed[3]
    with open(cpath, "r+b") as f:           # interior row: sample misses
        f.seek(data_off + 70_000 * 8)
        b = f.read(1)
        f.seek(data_off + 70_000 * 8)
        f.write(bytes([b[0] ^ 0x55]))
    assert tcodes.load_codes(path, "int8", rotated=True,
                             orphan=True) is not None
    monkeypatch.setenv("CLIPX_CODES_VERIFY", "full")
    assert tcodes.load_codes(path, "int8", rotated=True, orphan=True) is None
    with pytest.raises(SystemExit, match="integrity-footer"):
        tcommon.load_index(_args(path, "int8"))
    monkeypatch.setenv("CLIPX_CODES_VERIFY", "sample")
    with open(cpath, "r+b") as f:           # head row: sample catches it
        f.seek(data_off + 3)
        b = f.read(1)
        f.seek(data_off + 3)
        f.write(bytes([b[0] ^ 0x55]))
    assert tcodes.load_codes(path, "int8", rotated=True, orphan=True) is None


def test_residual_codes_are_refused_flat(sidecar, capsys):
    """Residual-pq codes (written for IVF) are read, then refused in flat
    mode: with the sidecar present the start re-encodes flat; codes-only it
    is a hard error with clipx's message."""
    path, v, ch = sidecar
    payload = jcodes.encode_corpus(v, "pq",
                                   rot=jeng.corpus_rotation(DIM))
    payload["residual"] = True
    jcodes.write_payload_file(path, payload, tier="pq", content_hash=ch)
    loaded = tcodes.load_codes(path, "pq", rotated=True)
    assert loaded["residual"] is True
    assert tcommon.build_index_from_codes(loaded, _args(path, "pq")) is None
    idx = tcommon.load_index(_args(path, "pq"))   # re-encodes flat
    assert idx.pq_storage and idx.ntotal == N
    assert not tcodes.load_codes(path, "pq", rotated=True)["residual"]
    jcodes.write_payload_file(path, payload, tier="pq", content_hash=ch)
    os.remove(path)
    with pytest.raises(SystemExit, match="RESIDUAL pq codes"):
        tcommon.load_index(_args(path, "pq"))


def test_toctou_replaced_sidecar_discards_codes(sidecar):
    path, v, ch = sidecar
    fp = tcodes.sidecar_sample_fp(path)
    _write_sidecar(path, _corpus(N, DIM, seed=9))
    with pytest.raises(tcodes.StaleSidecarError):
        tcodes.write_codes_file(path, v, "int8",
                                rot=teng.corpus_rotation(DIM),
                                content_hash=ch, fp_sample=fp)
    assert not os.path.exists(tcodes.codes_path(path))
