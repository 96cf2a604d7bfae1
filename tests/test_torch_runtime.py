"""The port's Encoder against clipx's, on the CPU in f32.

The same seeded params (carried across by ``from_jax_params`` inside the
Encoder) and the same seeded uint8 images and texts: embeddings within
1e-5 (f32 summation order only). The configuration has D = 64 (image 64,
patch 16, width 128, 2 heads, S = 17), so bucket 1 reaches
``packed_sdpa`` and the even buckets ``fused_attn_block``, here through
their plain versions.
"""

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
