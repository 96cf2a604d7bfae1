"""The port's KV store (``clipx_torch/store/kv.py``) on its own: clipx's
store cases (tests/test_kv_store.py, test_kv_lsm.py, test_kv_model.py) that
exercise ``Cursor.first``, ``Transaction.delete``, ``Environment.sync`` and
``Environment.overlay_bytes``, run on the port's module; then both packages
on one store: what one writes, deletes and compacts the other reads the
same, and the same operations give byte-identical files in either.
"""

import os

import numpy as np
import pytest

from clipx.store import kv as jkv
from clipx_torch.store import kv


@pytest.fixture()
def env(tmp_path):
    e = kv.open_env(str(tmp_path / "vectors.lmdb"), map_size=1 << 30,
                    max_dbs=4)
    yield e
    e.close()


# -- tests/test_kv_store.py ----------------------------------------------------

def test_cursor_first_then_iterate(env):
    db = env.open_db(b"fn_db")
    with env.begin(db=db, write=True) as txn:
        txn.put(b"b", b"2")
        txn.put(b"a", b"1")
    with env.begin(db=db) as txn:
        cur = txn.cursor()
        assert cur.first()
        assert list(cur) == [(b"a", b"1"), (b"b", b"2")]
    with env.begin(db=db) as txn:
        assert list(txn.cursor()) == [(b"a", b"1"), (b"b", b"2")]
    with env.begin(db=env.open_db(b"empty")) as txn:
        cur = txn.cursor()
        assert cur.first() is False
        assert list(cur) == []


def test_read_your_writes(env):
    db = env.open_db(b"fn_db")
    with env.begin(db=db, write=True) as txn:
        assert txn.get(b"k") is None
        txn.put(b"k", b"v")
        assert txn.get(b"k") == b"v"
        txn.delete(b"k")
        assert txn.get(b"k") is None


def test_overwrite_and_delete(env):
    db = env.open_db(b"fn_db")
    with env.begin(db=db, write=True) as txn:
        txn.put(b"k", b"v1")
    with env.begin(db=db, write=True) as txn:
        txn.put(b"k", b"v2")
        assert txn.delete(b"nope") is False
    with env.begin(db=db) as txn:
        assert txn.get(b"k") == b"v2"
    with env.begin(db=db, write=True) as txn:
        assert txn.delete(b"k") is True
    with env.begin(db=db) as txn:
        assert txn.get(b"k") is None
        assert txn.stat()["entries"] == 0


def test_delete_on_a_read_transaction_raises_clipx_error(env):
    db = env.open_db(b"fn_db")
    with env.begin(db=db) as txn:
        with pytest.raises(kv.Error) as ours:
            txn.delete(b"k")
    ref_env = jkv.open_env(env.path + ".clipx")
    try:
        with ref_env.begin(db=ref_env.open_db(b"fn_db")) as txn:
            with pytest.raises(jkv.Error) as ref:
                txn.delete(b"k")
    finally:
        ref_env.close()
    assert str(ours.value) == str(ref.value)


def test_sync_flushes_and_the_commit_survives_reopen(tmp_path):
    path = str(tmp_path / "vectors.lmdb")
    env = kv.open_env(path)
    db = env.open_db(b"fn_db")
    with env.begin(db=db, write=True) as txn:
        txn.put(b"durable", b"yes")
    assert env.sync() is None
    env.close()
    env = kv.open_env(path)
    with env.begin(db=env.open_db(b"fn_db")) as txn:
        assert txn.get(b"durable") == b"yes"
    env.close()


# -- tests/test_kv_lsm.py ------------------------------------------------------

def test_bulk_ingest_compacts_on_close(tmp_path):
    path = str(tmp_path / "vectors.lmdb")
    env = kv.open_env(path)
    db = env.open_db(b"fn_db")
    val = b"v" * 2048
    for start in range(0, 2000, 100):
        with env.begin(db=db, write=True) as txn:
            for i in range(start, start + 100):
                txn.put(f"k{i:06d}".encode(), val)
    env.close()  # >= 1024 WAL records -> folds into a segment
    files = os.listdir(path)
    assert any(f.startswith("seg-") for f in files)
    wal = [f for f in files if f.startswith("wal-")]
    assert len(wal) == 1
    assert os.path.getsize(os.path.join(path, wal[0])) == 8  # header only

    env = kv.open_env(path)
    assert env.overlay_bytes() == 0  # nothing resident: data is mmap-ed
    with env.begin(db=env.open_db(b"fn_db")) as txn:
        assert txn.stat()["entries"] == 2000
        assert txn.get(b"k001999") == val
    env.close()


def test_overlay_merge_over_segment(tmp_path):
    env = kv.open_env(str(tmp_path / "env"))
    db = env.open_db(b"db")
    with env.begin(db=db, write=True) as txn:
        for i in range(0, 20, 2):  # even keys into the segment
            txn.put(f"k{i:02d}".encode(), b"seg")
    env.compact()
    assert env.generation() == 1
    with env.begin(db=db, write=True) as txn:
        txn.put(b"k03", b"new")      # overlay-only key
        txn.put(b"k04", b"updated")  # overrides a segment key
        txn.delete(b"k06")           # tombstones a segment key
    with env.begin(db=db) as txn:
        assert txn.get(b"k03") == b"new"
        assert txn.get(b"k04") == b"updated"
        assert txn.get(b"k06") is None
        assert txn.get(b"k08") == b"seg"
        items = list(txn.cursor())
        assert txn.stat()["entries"] == len(items) == 10
    keys = [k for k, _ in items]
    assert keys == sorted(keys) and b"k06" not in keys
    with env.begin(db=db, write=True) as txn:
        txn.delete(b"k08")
        txn.put(b"k08", b"back")
    with env.begin(db=db) as txn:
        assert txn.get(b"k08") == b"back"
        assert txn.stat()["entries"] == 10
    env.compact()
    assert env.generation() == 2
    with env.begin(db=db) as txn:
        assert txn.get(b"k06") is None
        assert txn.get(b"k08") == b"back"
        assert [k for k, _ in txn.cursor()] == sorted(keys)
    env.close()


def test_memtable_spill_bounds_overlay(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIPX_KV_MEMTABLE_MB", "1")
    env = kv.open_env(str(tmp_path / "env"))
    db = env.open_db(b"db")
    val = b"v" * 4096
    for s in range(0, 600, 50):
        with env.begin(db=db, write=True) as txn:
            for i in range(s, s + 50):
                txn.put(f"k{i:04d}".encode(), val)
    # ~2.5 MB streamed through a 1 MB memtable: must have spilled
    assert env.generation() >= 1
    assert env.overlay_bytes() < 2 * 1024 * 1024
    with env.begin(db=db) as txn:
        assert txn.stat()["entries"] == 600
        assert sum(1 for _ in txn.cursor()) == 600
    env.close()


def test_spill_compaction_failure_recovers_coherently(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("CLIPX_KV_MEMTABLE_MB", "1")
    monkeypatch.setenv("CXKV_TEST_FAIL_COMPACT", "1")
    path = str(tmp_path / "env")
    env = kv.open_env(path)
    db = env.open_db(b"db")
    val = b"v" * 4096
    for s in range(0, 600, 50):
        with env.begin(db=db, write=True) as txn:  # must NOT raise
            for i in range(s, s + 50):
                txn.put(f"k{i:04d}".encode(), val)
    assert env.generation() == 0
    assert env.overlay_bytes() >= 2 * 1024 * 1024  # grew past the cap
    monkeypatch.delenv("CXKV_TEST_FAIL_COMPACT")
    with env.begin(db=db, write=True) as txn:
        txn.put(b"k0600", val)
    assert env.generation() >= 1
    assert env.overlay_bytes() < 2 * 1024 * 1024
    with env.begin(db=db) as txn:
        assert txn.stat()["entries"] == 601
    env.close()


def test_overlay_accounting_stable_under_churn(tmp_path):
    env = kv.open_env(str(tmp_path / "env"))
    db = env.open_db(b"db")
    with env.begin(db=db, write=True) as txn:
        for i in range(50):
            txn.put(f"k{i:03d}".encode(), b"x" * 100)
    env.compact()  # all 50 in the segment, overlay empty
    assert env.overlay_bytes() == 0

    def churn():
        for _ in range(20):  # tombstone a segment key, resurrect it
            with env.begin(db=db, write=True) as txn:
                txn.delete(b"k007")
            with env.begin(db=db, write=True) as txn:
                txn.put(b"k007", b"x" * 100)

    churn()
    first = env.overlay_bytes()
    churn()
    assert env.overlay_bytes() == first  # no growth across cycles
    with env.begin(db=db) as txn:
        assert txn.stat()["entries"] == 50
        assert txn.get(b"k007") == b"x" * 100
    env.close()


def test_finished_handles_raise_not_segfault(tmp_path):
    env = kv.open_env(str(tmp_path / "env"))
    db = env.open_db(b"db")
    txn = env.begin(db=db, write=True)
    txn.put(b"k", b"v")
    cur = txn.cursor()
    txn.commit()
    for op in (lambda: txn.get(b"k"), lambda: txn.put(b"k", b"v"),
               lambda: txn.delete(b"k"), lambda: txn.cursor(),
               lambda: cur.first()):
        with pytest.raises(kv.Error):
            op()
    env.close()


# -- tests/test_kv_model.py ----------------------------------------------------

@pytest.mark.parametrize("seed", [42, 7, 1234])
def test_randomized_ops_match_dict_model(tmp_path, seed):
    """Puts, deletes, aborted transactions and full checks (gets, cursor
    order through first() and iteration, stat) against a dict of dicts,
    with periodic reopen and compaction."""
    rng = np.random.RandomState(seed)
    path = str(tmp_path / "env")
    env = kv.open_env(path)
    names = [b"fn_db", b"skip_db", b"idx_db"]
    dbs = {name: env.open_db(name) for name in names}
    model = {name: {} for name in names}

    def rand_key():
        return f"k{rng.randint(200):03d}".encode()

    for step in range(240):
        name = names[rng.randint(3)]
        db = dbs[name]
        op = rng.randint(5)
        if op <= 1:
            with env.begin(db=db, write=True) as txn:
                for _ in range(rng.randint(1, 20)):
                    k, v = rand_key(), rng.bytes(rng.randint(1, 200))
                    txn.put(k, v)
                    model[name][k] = v
        elif op == 2:
            with env.begin(db=db, write=True) as txn:
                for _ in range(rng.randint(1, 10)):
                    k = rand_key()
                    assert txn.delete(k) is (k in model[name])
                    model[name].pop(k, None)
        elif op == 3:
            try:
                with env.begin(db=db, write=True) as txn:
                    txn.put(b"doomed", b"x")
                    raise RuntimeError
            except RuntimeError:
                pass
        else:
            with env.begin(db=db) as txn:
                assert txn.stat()["entries"] == len(model[name])
                cur = txn.cursor()
                assert cur.first() is bool(model[name])
                assert list(cur) == sorted(model[name].items())
                for k in (rand_key() for _ in range(5)):
                    assert txn.get(k) == model[name].get(k)
        if step % 20 == 19:
            env.close()
            env = kv.open_env(path)
            dbs = {name: env.open_db(name) for name in names}
        if step % 15 == 14:
            env.compact()
    for name in names:
        with env.begin(db=dbs[name]) as txn:
            assert list(txn.cursor()) == sorted(model[name].items())
    env.close()


# -- both packages on one store ------------------------------------------------

def _operations(mod, path):
    """Puts in two sub-databases, a compaction, deletes over the segment
    and the overlay, a sync, and a second round of puts; returns the
    store's final view through ``mod``."""
    env = mod.open_env(path)
    fn_db, idx_db = env.open_db(b"fn_db"), env.open_db(b"idx_db")
    with env.begin(write=True) as txn:
        for i in range(40):
            txn.put(f"/photos/{i:03d}.jpg".encode(),
                    np.full(8, i, np.float32).tobytes(), db=fn_db)
            txn.put(str(i).encode(), f"/photos/{i:03d}.jpg".encode(),
                    db=idx_db)
    env.compact()
    with env.begin(db=fn_db, write=True) as txn:
        for i in range(0, 40, 3):
            assert txn.delete(f"/photos/{i:03d}.jpg".encode())
        txn.put(b"/photos/new.jpg", b"\x00" * 32)
        assert txn.delete(b"/photos/new.jpg")
        assert not txn.delete(b"/photos/none.jpg")
    env.sync()
    with env.begin(db=idx_db, write=True) as txn:
        txn.delete(b"7")
        txn.put(b"40", b"/photos/040.jpg")
    view = _view(env)
    env.close()
    return view


def _view(env):
    out = {}
    for name in (b"fn_db", b"idx_db"):
        with env.begin(db=env.open_db(name)) as txn:
            cur = txn.cursor()
            out[name] = (txn.stat()["entries"], cur.first(), list(cur))
    return out


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))
            if not name.endswith(".lock")}


@pytest.mark.parametrize("writer", ["clipx", "port"])
def test_a_store_crosses_between_the_packages(tmp_path, writer):
    """The same operations through each package give byte-identical files
    and the same view; the store one package wrote, deleted from and
    compacted reads the same through the other, which then compacts it
    and hands it back."""
    mods = {"clipx": jkv, "port": kv}
    reader = "port" if writer == "clipx" else "clipx"
    paths = {name: str(tmp_path / name) for name in mods}
    views = {name: _operations(mods[name], paths[name]) for name in mods}
    assert views["clipx"] == views["port"]
    assert _files(paths["clipx"]) == _files(paths["port"])

    env = mods[reader].open_env(paths[writer])
    assert _view(env) == views[writer]
    env.compact()
    env.close()
    env = mods[writer].open_env(paths[writer])
    assert _view(env) == views[writer]
    env.close()
