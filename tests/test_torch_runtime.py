"""The port's Encoder against clipx's, on the CPU in f32.

The same seeded params (carried across by ``from_jax_params`` inside the
Encoder) and the same seeded uint8 images and texts: embeddings within
1e-5 (f32 summation order only). The configuration has D = 64 (image 64,
patch 16, width 128, 2 heads, S = 17), so bucket 1 reaches
``packed_sdpa`` and the even buckets ``fused_attn_block``, here through
their plain versions.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

import jax

from clipx import config as jcfg
from clipx.models import clip as jclip
from clipx.runtime.encoder import Encoder as JEncoder
from clipx_torch import config as tcfg
from clipx_torch.models import clip as tclip
from clipx_torch.ops import packed_sdpa as tps
from clipx_torch.runtime.encoder import Encoder as TEncoder

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

TOL = 1e-5
BUCKETS = (1, 4, 8)


def _d64(mod):
    return mod.CLIPConfig(
        name="d64-test",
        vision=mod.VisionConfig(image_size=64, patch_size=16, width=128,
                                layers=2, heads=2, embed_dim=64),
        text=mod.TextConfig(context_length=77, vocab_size=49408, width=64,
                            layers=2, heads=2, embed_dim=64))


@pytest.fixture(scope="module")
def encoders():
    params = jax.tree_util.tree_map(
        np.asarray, jclip.init_params(_d64(jcfg), jax.random.PRNGKey(0)))
    ref = JEncoder(_d64(jcfg), params, batch_buckets=BUCKETS)
    ours = TEncoder(_d64(tcfg), params, device="cpu", batch_buckets=BUCKETS)
    return ref, ours


@pytest.mark.parametrize("n,bucket", [(1, 1), (3, 4), (8, 8), (11, 8)])
def test_encode_images_matches_clipx(encoders, monkeypatch, n, bucket):
    """Batches pad up to the next bucket; oversized ones are chunked at
    the largest; padding rows never come back."""
    ref, ours = encoders
    seen = []
    real = tclip.encode_image
    monkeypatch.setattr(tclip, "encode_image", lambda p, c, x, **k: (
        seen.append(x.shape[0]), real(p, c, x, **k))[1])
    images = np.random.RandomState(n).randint(0, 256, (n, 64, 64, 3),
                                              dtype=np.uint8)
    launches = dict(tps.LAUNCHES)
    out = ours.encode_images(images)
    assert out.dtype == np.float32 and out.shape == (n, 64)
    np.testing.assert_allclose(out, ref.encode_images(images), atol=TOL,
                               rtol=0)
    assert seen == ([bucket] if n <= BUCKETS[-1] else [8, 4])
    assert tps.LAUNCHES == launches  # CPU tensors launch no kernel


def test_async_handles_in_flight(encoders):
    _, ours = encoders
    rng = np.random.RandomState(5)
    batches = [rng.randint(0, 256, (b, 64, 64, 3), dtype=np.uint8)
               for b in (2, 5)]
    handles = [ours.encode_images_async(b) for b in batches]
    for batch, handle in zip(batches, handles):
        np.testing.assert_array_equal(ours.finalize(handle),
                                      ours.encode_images(batch))
    with pytest.raises(ValueError):
        ours.encode_images_async(np.zeros((9, 64, 64, 3), np.uint8))


@pytest.mark.parametrize("n", [1, 3, 5])
def test_encode_texts_matches_clipx(encoders, n):
    ref, ours = encoders
    texts = ["a photo of a cat", "two dogs", "a red car at night",
             "", "東京の夜景"][:n]
    out = ours.encode_texts(texts)
    assert out.shape == (n, 64)
    np.testing.assert_allclose(out, ref.encode_texts(texts), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("n", [1, 3, 5, 70])
def test_cpu_text_encode_stays_eager_and_uncounted(encoders, n):
    """On the CPU no text graph is captured and neither text-tower count
    moves; the embeddings are the eager tower's on the padded ids, bitwise
    (70 texts: a chunk of 64 and one of 6 in bucket 16)."""
    _, ours = encoders
    texts = [f"photo {i} of " + "a cat " * (i % 9) for i in range(n)]
    launches = tps.launch_counts()
    out = ours.encode_texts(texts)
    assert tps.launch_counts() == launches
    assert ours._text_graphs.graphs == {}
    ids = ours.tokenizer(texts, context_length=77)
    want = []
    for i in range(0, n, 64):
        chunk = ids[i: i + 64]
        rows = min(b for b in (1, 4, 16, 64) if b >= chunk.shape[0])
        padded = np.zeros((rows, 77), ids.dtype)
        padded[:chunk.shape[0]] = chunk
        with torch.inference_mode():
            want.append(tclip.encode_text(
                ours.params, ours.cfg, torch.from_numpy(padded),
                normalize=True, attn_impl="xla")[:chunk.shape[0]].numpy())
    np.testing.assert_array_equal(out, np.concatenate(want))


def test_capturing_keeps_a_threads_launches_apart(monkeypatch):
    """Inside ``capturing()`` a launch on this thread goes into the
    yielded dict, not ``LAUNCHES``; another thread's still counts."""
    from clipx_torch.ops import _launch

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    fn = lambda *args: 0  # noqa: E731 — a C entry point that succeeds
    dev = torch.device("cpu")
    before = tps.launch_counts()
    with _launch.capturing() as captured:
        _launch.launch("fused_mlp", fn, dev)
        _launch.launch("fused_mlp", fn, dev)
        other = threading.Thread(
            target=_launch.launch, args=("packed_sdpa", fn, dev))
        other.start()
        other.join()
    assert captured == {"fused_mlp": 2}
    _launch.launch("fused_mlp", fn, dev)
    after = tps.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"fused_mlp": 1, "packed_sdpa": 1}


def test_routes_follow_the_environment(monkeypatch):
    """``layers.routes()`` changes with each routing variable, so a text
    graph captured under one route is not replayed under another."""
    from clipx_torch.models import layers as tlayers

    for name in ("CLIPX_PACKED_SDPA", "CLIPX_FUSED_MLP",
                 "CLIPX_FUSED_MLP_INT8"):
        monkeypatch.delenv(name, raising=False)
    base = tlayers.routes()
    seen = {base}
    for name, value in (("CLIPX_PACKED_SDPA", "sublayer"),
                        ("CLIPX_FUSED_MLP", "on"),
                        ("CLIPX_FUSED_MLP_INT8", "on")):
        monkeypatch.setenv(name, value)
        seen.add(tlayers.routes())
    assert len(seen) == 4
    monkeypatch.setenv("CLIPX_PACKED_SDPA", "nonsense")  # read as auto
    monkeypatch.setenv("CLIPX_FUSED_MLP", "off")
    monkeypatch.setenv("CLIPX_FUSED_MLP_INT8", "off")
    assert tlayers.routes() == base


def test_encode_pixels_matches_clipx(encoders):
    ref, ours = encoders
    pixels = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(ours.encode_pixels(pixels),
                               ref.encode_pixels(pixels), atol=TOL, rtol=0)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    """device=None means cuda; with no GPU visible that is an error, never
    a silent move to the CPU."""
    from clipx_torch.search.engine import VectorIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEncoder.create("tiny-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorIndex(8)
    enc = TEncoder.create("tiny-test", device="cpu")
    assert enc.device.type == "cpu" and enc.dtype == torch.float32


def test_create_from_a_clipx_checkpoint(tmp_path):
    """An .npz saved by clipx loads into the port's Encoder."""
    from clipx.models import convert as jconvert

    cfg = jcfg.get_config("tiny-test")
    params = jclip.init_params(cfg, jax.random.PRNGKey(1))
    path = str(tmp_path / "tiny.npz")
    jconvert.save_params(path, params)
    ours = TEncoder.create("tiny-test", checkpoint=path, device="cpu")
    ref = JEncoder(cfg, params)
    images = np.random.RandomState(7).randint(0, 256, (2, 32, 32, 3),
                                              dtype=np.uint8)
    np.testing.assert_allclose(ours.encode_images(images),
                               ref.encode_images(images), atol=TOL, rtol=0)


def _long(mod):
    """The d64 configuration at image 160 (S = 101): the long kernels."""
    return mod.CLIPConfig(
        name="long-test",
        vision=mod.VisionConfig(image_size=160, patch_size=16, width=128,
                                layers=2, heads=2, embed_dim=64),
        text=mod.TextConfig(context_length=77, vocab_size=49408, width=64,
                            layers=2, heads=2, embed_dim=64))


@pytest.fixture(scope="module")
def long_params():
    return jax.tree_util.tree_map(
        np.asarray, jclip.init_params(_long(jcfg), jax.random.PRNGKey(1)))


@pytest.mark.parametrize("attn_impl", ["auto", "xla", "pallas", "plain"])
def test_encoder_attn_impl_matches_clipx(long_params, attn_impl,
                                         monkeypatch):
    """Encoder(attn_impl=...) at S = 101 against clipx's Encoder with the
    same value: images through the route it picks, texts always through
    "xla" (the 77-token tower), as in clipx."""
    seen = []
    real = tclip.encode_text
    monkeypatch.setattr(tclip, "encode_text", lambda *a, **k: (
        seen.append(k["attn_impl"]), real(*a, **k))[1])
    ref = JEncoder(_long(jcfg), long_params, attn_impl=attn_impl,
                   batch_buckets=(2,))
    ours = TEncoder(_long(tcfg), long_params, device="cpu",
                    attn_impl=attn_impl, batch_buckets=(2,))
    assert ours.attn_impl == ref.attn_impl
    images = np.random.RandomState(3).randint(0, 256, (2, 160, 160, 3),
                                              dtype=np.uint8)
    np.testing.assert_allclose(ours.encode_images(images),
                               ref.encode_images(images), atol=TOL, rtol=0)
    texts = ["a photo of a cat", "two dogs"]
    np.testing.assert_allclose(ours.encode_texts(texts),
                               ref.encode_texts(texts), atol=TOL, rtol=0)
    assert seen == ["xla"]


@pytest.mark.parametrize("attn_impl,kernel", [("auto", "fused_sdpa_long"),
                                              ("pallas", "flash_attention")])
def test_encoder_routes_the_long_tower(long_params, monkeypatch, attn_impl,
                                       kernel):
    """The image tower's two layers reach one long kernel each; the text
    tower reaches neither."""
    from clipx_torch.ops import flash_attention as tfa

    calls = []
    for mod, name in ((tps, "fused_sdpa_long"), (tfa, "flash_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    enc = TEncoder(_long(tcfg), long_params, device="cpu",
                   attn_impl=attn_impl, batch_buckets=(1,))
    enc.encode_images(np.zeros((1, 160, 160, 3), np.uint8))
    assert calls == [kernel, kernel]
    calls.clear()
    enc.encode_texts(["a cat"])
    assert calls == []


def test_encoder_refuses_an_unknown_attn_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        TEncoder.create("tiny-test", device="cpu", attn_impl="flash")


def test_qkv_routes_read_the_encoders_packed_weights(long_params,
                                                     monkeypatch):
    """Under CLIPX_PACKED_SDPA=qkv the packed projection of each layer is
    the Encoder's stored [wq | wk | wv] (no second copy), and wq/wk/wv are
    views into it."""
    from clipx_torch.models import layers as tlayers

    monkeypatch.setenv("CLIPX_PACKED_SDPA", "qkv")
    enc = TEncoder(_long(tcfg), long_params, device="cpu",
                   batch_buckets=(2,))
    attn = enc.params["visual"]["blocks"]["attn"]
    w = attn["wq"].shape[-1]
    for i, name in enumerate(("wq", "wk", "wv")):
        assert attn[name].data_ptr() == attn["wqkv"][:, :, i * w].data_ptr()
    packed = []
    real = tlayers.dense
    monkeypatch.setattr(tlayers, "dense", lambda x, wt, b=None: (
        packed.append(wt.data_ptr()) if wt.shape[-1] == 3 * w else None,
        real(x, wt, b))[1])
    launches = dict(tps.LAUNCHES)
    enc.encode_images(np.zeros((2, 160, 160, 3), np.uint8))
    assert packed == [attn["wqkv"][i].data_ptr() for i in range(2)]
    assert tps.LAUNCHES == launches
