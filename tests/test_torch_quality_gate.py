"""The quality gate on the port: ``clipx_torch.tools.eval_quality`` and the
cases of ``tests/test_quality_gate.py``, run on ``clipx_torch`` (CPU) with
the same floors.

- int8 recall@50 over a 10,000 x 512 corpus, every tier's line held to
  clipx's floors;
- the preprocess drift gate over an index that the port's ``build_index``
  wrote (cv2 >= 0.9999, PIL >= 0.90, int8 compute vs bf16 >= 0.99);
- the near-duplicate rescore;
- the ``--fast-decode`` drift bound;
- per-tier recall on tiny-test encoder embeddings of synthetic photos
  (clipx's weights, so the flat tiers see clipx's vectors);
- on a small corpus, the tool's flat-tier lines are clipx's own, digit for
  digit; the IVF lines differ (the k-means layout is the port's own) and
  are held to the floors only;
- with 8 devices visible (mocked), the ``sharded vs exact`` line is
  clipx's, digit for digit, and the IVF lines name ``ShardedIVFIndex``;
- ``CLIPX_INT8_SCAN=element`` is refused by name; ``CLIPX_PQ_LUT=bf16`` is
  ignored and changes no result, the port's or clipx's.
"""

import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clipx import config as jcfg
from clipx.models import clip as jclip
from clipx.search import engine as jeng
from clipx_torch import config as tcfg
from clipx_torch.search import engine as teng
from clipx_torch.search import pq as tpq
from clipx_torch.tools import eval_quality as teq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import eval_quality as jeq  # noqa: E402
from gen_corpus import burst_variant, synth_image  # noqa: E402

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)


def _parse(pattern, out):
    m = re.search(pattern, out)
    assert m, f"pattern {pattern!r} not found in:\n{out}"
    return m


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _write(path, corpus):
    w = teng.IndexWriter(path, corpus.shape[0], corpus.shape[1])
    w.write(corpus)
    w.close()


def test_int8_recall_at_50_is_perfect(tmp_path, capsys):
    """tests/test_quality_gate.py's first case, every line and floor."""
    corpus = _unit(np.random.RandomState(0), 10_000, 512)
    path = str(tmp_path / "images.index")
    _write(path, corpus)
    rc = teq.main(["--index", path, "--k", "50", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = _parse(r"self-retrieval: (\d+)/(\d+) rank-0 hits", out)
    assert m.group(1) == m.group(2)
    m = _parse(r"int8\+rescore vs exact: recall@50 ([0-9.]+), "
               r"top-1 agreement ([0-9.]+)", out)
    assert float(m.group(1)) == 1.0 and float(m.group(2)) == 1.0
    assert "sharded vs exact" not in out  # one device
    m = _parse(r"ivf vs exact \((\w+)\): recall@50 ([0-9.]+) at "
               r"nprobe=100, ([0-9.]+) at nprobe=32", out)
    assert m.group(1) == "IVFIndex" and float(m.group(2)) == 1.0
    m = _parse(r"ivf-int8 vs exact: recall@50 ([0-9.]+) at nprobe=100",
               out)
    assert float(m.group(1)) >= 0.95
    m = _parse(r"ivf-int8-storage vs exact f32: recall@50 ([0-9.]+) "
               r"at nprobe=100", out)
    assert float(m.group(1)) >= 0.95
    m = _parse(r"bf16-corpus int8\+rescore vs exact f32: recall@50 "
               r"([0-9.]+), top-1 agreement ([0-9.]+)", out)
    assert float(m.group(1)) >= 0.99 and float(m.group(2)) == 1.0
    m = _parse(r"int8-storage vs exact f32: recall@50 ([0-9.]+), "
               r"top-1 agreement ([0-9.]+)", out)
    assert float(m.group(1)) >= 0.97 and float(m.group(2)) == 1.0
    m = _parse(r"int4-storage vs exact f32: recall@50 ([0-9.]+), "
               r"top-1 agreement ([0-9.]+)", out)
    assert float(m.group(1)) >= 0.85 and float(m.group(2)) == 1.0
    m = _parse(r"ivf-int4-storage vs exact f32: recall@50 ([0-9.]+) "
               r"at nprobe=100", out)
    assert float(m.group(1)) >= 0.80
    m = _parse(r"pq-storage \(dsub=2, opq=trained\) vs exact f32: "
               r"recall@50 ([0-9.]+), top-1 agreement ([0-9.]+)", out)
    assert float(m.group(1)) >= 0.45 and float(m.group(2)) == 1.0
    m = _parse(r"ivf-pq-storage \(residual=on\) vs exact f32: "
               r"recall@50 ([0-9.]+) at nprobe=100", out)
    assert float(m.group(1)) >= 0.45


def test_preprocess_drift_gate(tmp_path, monkeypatch, capsys):
    """The drift leg over an index that the port's build_index wrote:
    cv2 re-encodes reproduce the stored rows, PIL stays within budget,
    int8 compute stays near bf16."""
    from clipx_torch.cli import build_index as tbuild

    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.RandomState(1)
    for i in range(12):
        base = rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)
        img = Image.fromarray(base).resize((64, 48), Image.BILINEAR)
        img.save(photos / f"p{i:02d}.png")
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    assert tbuild.main(["--model", "tiny-test", "--device", "cpu",
                        str(photos) + os.sep]) == 0
    json_path = str(tmp_path / "q.json")
    rc = teq.main(["--index", "images.index", "--db", "vectors.lmdb",
                   "--photos", str(photos), "--model", "tiny-test",
                   "--samples", "12", "--device", "cpu", "--json",
                   json_path])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = _parse(r"pil min ([0-9.-]+) mean [0-9.-]+; "
               r"cv2 min ([0-9.-]+)", out)
    assert float(m.group(2)) >= 0.9999, out
    assert float(m.group(1)) >= 0.90, out
    m = _parse(r"int8-compute drift vs bf16 \(cosine, n=(\d+)\): "
               r"min ([0-9.-]+)", out)
    assert int(m.group(1)) == 12 and float(m.group(2)) >= 0.99, out
    assert f"(wrote {json_path})" in out


def test_int8_rescore_on_near_duplicate_cluster():
    """tests/test_quality_gate.py's near-duplicate case on the port: 500
    near-identical rows in one contiguous block; the self-match survives,
    every hit is from the cluster, scores within quantization noise."""
    rng = np.random.RandomState(5)
    base = rng.randn(512).astype(np.float32)
    base /= np.linalg.norm(base)
    dups = base[None] + rng.randn(500, 512).astype(np.float32) * 1e-3
    rest = rng.randn(7500, 512).astype(np.float32)
    corpus = np.concatenate([dups, rest])
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)

    exact = teng.VectorIndex.from_vectors(corpus, device="cpu")
    quant = teng.VectorIndex.from_vectors(corpus, True, "cpu")
    q = corpus[123][None]
    De, Ie = exact.search(q, k=50)
    Dq, Iq = quant.search(q, k=50)
    assert Iq[0, 0] == 123
    assert (Iq[0] < 500).all() and (Ie[0] < 500).all()
    np.testing.assert_allclose(Dq[0], De[0], rtol=0, atol=5e-4)
    assert (np.diff(Dq[0]) <= 1e-7).all()
    spread = rest[:2000] / np.linalg.norm(rest[:2000], axis=1,
                                          keepdims=True)
    e2 = teng.VectorIndex.from_vectors(spread, device="cpu")
    q2 = teng.VectorIndex.from_vectors(spread, True, "cpu")
    _, Ig = e2.search(spread[:3], k=20)
    _, Ih = q2.search(spread[:3], k=20)
    np.testing.assert_array_equal(Ih, Ig)


def test_fast_decode_embedding_drift_bounded(tmp_path):
    """--fast-decode's DCT-domain downscale through the port's decoder and
    tiny-test Encoder: cosine >= 0.98 against the full decode."""
    from clipx_torch.data.pipeline import iter_decoded
    from clipx_torch.runtime.encoder import Encoder

    rng = np.random.RandomState(2)
    paths = []
    for i in range(6):
        base = rng.randint(0, 255, (10, 14, 3), dtype=np.uint8)
        p = str(tmp_path / f"p{i}.jpg")
        Image.fromarray(base).resize((1280, 960), Image.BICUBIC
                                     ).save(p, quality=88)
        paths.append(p)

    def decode(fast):
        items = {it.path: it.array for it in iter_decoded(
            paths, 32, fast=fast, workers=1)}
        return np.stack([items[p] for p in paths])

    enc = Encoder.create("tiny-test", device="cpu", batch_buckets=(8,))
    cos = np.sum(enc.encode_images(decode(False))
                 * enc.encode_images(decode(True)), axis=1)
    assert cos.min() >= 0.98, cos


def test_encoder_embedding_tier_recall():
    """Per-tier recall on tiny-test encoder outputs (clipx's weights) of
    synthetic photos with burst-shot near duplicates, clipx's floors."""
    from clipx_torch.ops.preprocess import cv2_resize_crop
    from clipx_torch.runtime.encoder import Encoder
    from clipx_torch.search.ivf import IVFIndex

    params = jax.tree_util.tree_map(np.asarray, jclip.init_params(
        jcfg.get_config("tiny-test"), jax.random.PRNGKey(0)))
    enc = Encoder(tcfg.get_config("tiny-test"), params, device="cpu")
    rng = np.random.default_rng(11)
    frames = []
    for i in range(160):
        img = synth_image(rng, 128, 96)
        frames.append(img)
        if i % 2 == 0:
            frames.append(burst_variant(rng, img))
            frames.append(burst_variant(rng, img))
    batch = np.stack([cv2_resize_crop(f, enc.image_size) for f in frames])
    emb = np.concatenate([enc.encode_images(batch[i: i + 32])
                          for i in range(0, len(batch), 32)])
    n = emb.shape[0]
    q_rows = np.random.RandomState(3).choice(n, 48, replace=False)
    queries = emb[q_rows]
    k = 20
    _, Ie = teng.VectorIndex.from_vectors(emb, device="cpu").search(
        queries, k)

    def recall(idx, **kw):
        _, ids = idx.search(queries, k, **kw)
        return float(np.mean([len(set(Ie[i]) & set(ids[i])) / k
                              for i in range(len(queries))]))

    def flat(dtype):
        return teng.VectorIndex.from_vectors(emb, device="cpu", dtype=dtype)

    assert recall(flat("int8")) >= 0.95
    assert recall(flat("int4")) >= 0.50
    assert recall(flat("pq")) >= 0.55
    assert recall(IVFIndex.from_vectors(emb, dtype="pq", device="cpu"),
                  nprobe=100) >= 0.62
    _, I1 = teng.VectorIndex.from_vectors(emb, True, "cpu").search(
        emb[:64], 1)
    assert (I1[:, 0] == np.arange(64)).mean() >= 0.95


# the tool's lines that depend only on flat search: the port prints
# clipx's numbers for these
FLAT_LINES = ("self-retrieval:", "int8+rescore vs exact:",
              "bf16-corpus int8+rescore", "int8-storage vs",
              "int4-storage vs", "pq-storage (dsub")
IVF_FLOOR = 0.45


def test_tool_prints_clipx_numbers_for_the_flat_tiers(tmp_path):
    """The same small index through both tools: the flat-tier lines are
    equal, IVF's are held to the floors, and --json has clipx's keys with
    clipx's values for the flat tiers."""
    corpus = _unit(np.random.RandomState(7), 3000, 64)
    path = str(tmp_path / "images.index")
    jeng.write_index(jeng.VectorIndex.from_vectors(corpus), path)
    outs, js = {}, {}
    for name, mod, extra in (("clipx", jeq, []),
                             ("port", teq, ["--device", "cpu"])):
        buf = io.StringIO()
        js[name] = str(tmp_path / f"{name}.json")
        with contextlib.redirect_stdout(buf):
            assert mod.main(["--index", path, "--k", "20", "--samples",
                             "32", "--json", js[name], *extra]) == 0
        outs[name] = buf.getvalue().splitlines()
    # clipx prints its sharded line, and names ShardedIVFIndex, when JAX
    # sees more than one device (the suite's virtual CPU devices); the
    # port is single-device
    ours = [ln for ln in outs["port"] if not ln.startswith("(wrote")]
    ref = [ln for ln in outs["clipx"] if not ln.startswith(
        ("(wrote", "sharded vs exact"))]
    assert len(ours) == len(ref) == 11
    for x, y in zip(ours, ref):
        if y.startswith(FLAT_LINES):
            assert x == y
        else:
            assert x.split(" vs ")[0] == y.split(" vs ")[0]
            for value in re.findall(r"recall@20 ([0-9.]+)", x):
                assert float(value) >= IVF_FLOOR, x
    assert "ivf vs exact (IVFIndex)" in "\n".join(ours)
    import json

    with open(js["port"]) as f:
        got = json.load(f)
    with open(js["clipx"]) as f:
        want = json.load(f)
    assert sorted(got) == sorted(want)
    for key in ("self_retrieval", "quant_int8_rescore", "bf16_storage",
                "int8_storage", "int4_storage", "pq_storage_opq_trained",
                "config"):
        assert got[key] == want[key], key


def test_tool_restores_the_callers_pq_settings(tmp_path, monkeypatch):
    """The tool sets CLIPX_PQ_OPQ and CLIPX_PQ_RESIDUAL for its pq legs
    and leaves the caller's values (or their absence) as they were."""
    corpus = _unit(np.random.RandomState(8), 600, 32)
    path = str(tmp_path / "images.index")
    _write(path, corpus)
    monkeypatch.setenv("CLIPX_PQ_OPQ", "trained")
    monkeypatch.delenv("CLIPX_PQ_RESIDUAL", raising=False)
    seen = []
    real = tpq.opq_mode
    monkeypatch.setattr(tpq, "opq_mode", lambda: (
        seen.append(os.environ.get("CLIPX_PQ_OPQ")), real())[1])
    with contextlib.redirect_stdout(io.StringIO()):
        assert teq.main(["--index", path, "--samples", "8", "--pq-modes",
                         "both", "--device", "cpu"]) == 0
    assert {"fixed", "trained"} <= set(seen)
    assert os.environ["CLIPX_PQ_OPQ"] == "trained"
    assert "CLIPX_PQ_RESIDUAL" not in os.environ


def test_tool_prints_clipx_sharded_line_on_the_same_mesh(tmp_path,
                                                        monkeypatch):
    """With more than one device visible (8 here, mocked: the CPU listed 8
    times, as the suite's 8 virtual devices are JAX's) the port's tool
    prints clipx's ``sharded vs exact`` line digit for digit, and its IVF
    line names ShardedIVFIndex, as clipx's does."""
    from clipx_torch.parallel import mesh as tmesh

    assert len(jax.devices()) == 8
    monkeypatch.setattr(tmesh, "visible_devices",
                        lambda kind: [torch.device("cpu")] * 8)
    corpus = _unit(np.random.RandomState(5), 1500, 32)
    path = str(tmp_path / "images.index")
    jeng.write_index(jeng.VectorIndex.from_vectors(corpus), path)
    outs = {}
    for name, mod, extra in (("clipx", jeq, []),
                             ("port", teq, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(["--index", path, "--k", "10", "--samples",
                             "16", *extra]) == 0
        outs[name] = buf.getvalue()
    lines = {name: [ln for ln in out.splitlines()
                    if ln.startswith("sharded vs exact")]
             for name, out in outs.items()}
    assert lines["port"] == lines["clipx"]
    assert lines["port"][0].endswith("(8 devices)")
    for out in outs.values():
        assert "ivf vs exact (ShardedIVFIndex)" in out


# -- clipx's two knobs that pick another scan -------------------------------

def _cluster_corpus():
    """20,500 x 64 unit rows with a 400-row near-duplicate block (noise
    3e-3): inside it clipx's per-element int8 candidates miss rows that the
    segment scan keeps, so clipx's two CLIPX_INT8_SCAN modes rank
    differently there."""
    rng = np.random.RandomState(0)
    base = _unit(rng, 20_500, 64)
    base[1000:1400] = base[5] + 3e-3 * rng.randn(400, 64).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    queries = np.concatenate([base[[5, 1200]] + 0.01 * rng.randn(
        2, 64).astype(np.float32), _unit(rng, 2, 64)])
    return base, queries


@pytest.mark.parametrize("value", ["element", "seg", "anything-else"])
def test_int8_scan_element_is_refused(monkeypatch, value):
    """CLIPX_INT8_SCAN=element, which gives other ids in clipx on the
    near-duplicate queries, raises an error that names the knob; any other
    value takes the segment scan, as in clipx: the ids of the knob unset
    and clipx's scores."""
    corpus, queries = _cluster_corpus()
    ours = teng.VectorIndex.from_vectors(corpus, True, "cpu")
    ref = jeng.VectorIndex.from_vectors(corpus, quantized=True)
    Ds, Is = ours.search(queries, 50)
    Dr, Ir = ref.search(queries, 50)
    monkeypatch.setenv("CLIPX_INT8_SCAN", value)
    if value == "element":
        assert (ref.search(queries, 50)[1][:2] != Ir[:2]).any()
        with pytest.raises(ValueError, match="CLIPX_INT8_SCAN=element"):
            ours.search(queries, 50)
        return
    Do, Io = ours.search(queries, 50)
    np.testing.assert_array_equal(Io, Is)
    np.testing.assert_array_equal(Do, Ds)
    np.testing.assert_allclose(Do, Dr, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ref.search(queries, 50)[1], Ir)


@pytest.mark.parametrize("search_mode", ["flat", "ivf"])
def test_pq_lut_bf16_changes_no_result(monkeypatch, search_mode):
    """CLIPX_PQ_LUT=bf16 is ignored: the LUT holds integers <= 127, exact
    in bf16, so clipx's bf16 LUT gives its int8 LUT's bits. With the knob
    set the port's results are its default's, and clipx's for flat."""
    from clipx_torch.search import ivf as tivf

    corpus, queries = _cluster_corpus()
    corpus = corpus[:6000]
    if search_mode == "flat":
        ours = teng.VectorIndex.from_vectors(corpus, device="cpu",
                                             dtype="pq")
        ref = jeng.VectorIndex.from_vectors(corpus, dtype="pq")
    else:
        ours = tivf.IVFIndex.from_vectors(corpus, device="cpu", dtype="pq")
    base = ours.search(queries, 20)
    monkeypatch.setenv("CLIPX_PQ_LUT", "bf16")
    got = ours.search(queries, 20)
    np.testing.assert_array_equal(got[1], base[1])
    np.testing.assert_array_equal(got[0], base[0])
    if search_mode == "flat":
        np.testing.assert_array_equal(got[1], ref.search(queries, 20)[1])
