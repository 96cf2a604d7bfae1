"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the Encoder and the search engine on CUDA against the
same code on the CPU.

Every test here is marked ``cuda`` and skips without a GPU. This file
imports neither JAX nor clipx, so it runs on a machine that has only
PyTorch and a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from clipx_torch import config as tcfg
from clipx_torch.models import convert as tconvert
from clipx_torch.ops import packed_sdpa as tps
from clipx_torch.runtime.encoder import Encoder
from clipx_torch.search import engine as teng

pytestmark = pytest.mark.cuda

# bf16 kernel vs plain version on the same bf16 inputs: f32 summation
# order only, which can flip the bf16 rounding of an intermediate
ATOL, RTOL = 1e-2, 2e-2


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _bf(gen, device, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device,
                                                          torch.bfloat16)


@pytest.mark.parametrize("b,s,w,heads", [(1, 50, 768, 12), (2, 50, 768, 12),
                                         (8, 50, 768, 12), (2, 17, 128, 2),
                                         (4, 64, 192, 3), (3, 1, 128, 2)])
def test_kernels_match_plain_versions(cuda_device, b, s, w, heads):
    gen = torch.Generator().manual_seed(b * s + w)
    x = _bf(gen, cuda_device, b, s, w)
    wqkv = _bf(gen, cuda_device, w, 3 * w, scale=0.03)
    wo = _bf(gen, cuda_device, w, w, scale=0.03)
    bqkv = (torch.randn(3 * w, generator=gen) * 0.01).to(cuda_device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(cuda_device)
    before = dict(tps.LAUNCHES)
    out = tps.fused_attn_block(x, wqkv, bqkv, wo, bo, heads=heads)
    ref = tps.fused_attn_block_plain(x, wqkv, bqkv, wo, bo, heads=heads)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL,
                               atol=ATOL)
    q, k, v = (_bf(gen, cuda_device, b, s, w) for _ in range(3))
    ref = tps.sdpa_plain(q, k, v, heads=heads).float()
    launched = {"fused_attn_block": 1}
    if heads % 2 == 0:
        torch.testing.assert_close(
            tps.packed_sdpa(q, k, v, heads=heads).float(), ref, rtol=RTOL,
            atol=ATOL)
        launched["packed_sdpa"] = 1
    if b % 2 == 0:
        torch.testing.assert_close(
            tps.packed_sdpa_rows(q, k, v, heads=heads).float(), ref,
            rtol=RTOL, atol=ATOL)
        launched["packed_sdpa_rows"] = 1
    for name, n in launched.items():
        assert tps.LAUNCHES[name] == before[name] + n


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    q = _bf(gen, cuda_device, 2, 50, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        tps.packed_sdpa(q.float(), q.float(), q.float(), heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        t = _bf(gen, cuda_device, 2, 128, 50).transpose(1, 2)
        tps.packed_sdpa(t, t, t, heads=2)
    with pytest.raises(ValueError, match="is on"):
        tps.packed_sdpa_rows(q, q.cpu(), q, heads=2)


def _d64():
    return tcfg.CLIPConfig(
        name="d64-test",
        vision=tcfg.VisionConfig(image_size=64, patch_size=16, width=128,
                                 layers=2, heads=2, embed_dim=64),
        text=tcfg.TextConfig(context_length=77, vocab_size=49408, width=64,
                             layers=2, heads=2, embed_dim=64))


def test_encoder_on_the_card_matches_the_cpu(cuda_device):
    """bf16 on the card vs f32 on the CPU from the same weights: cosine
    >= 0.999 at this small width; bucket 1 launches packed_sdpa and the
    even buckets fused_attn_block, once per layer."""
    params = tconvert.init_params(_d64(), seed=0)
    gpu = Encoder(_d64(), params, device=cuda_device, batch_buckets=(1, 4))
    cpu = Encoder(_d64(), params, device="cpu", batch_buckets=(1, 4))
    images = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    tps.reset_launches()
    one = gpu.encode_images(images[:1])
    assert tps.LAUNCHES["packed_sdpa"] == 2
    four = gpu.encode_images(images)
    assert tps.LAUNCHES["fused_attn_block"] == 2
    ref = cpu.encode_images(images)
    assert (np.sum(four * ref, axis=1) >= 0.999).all()
    assert float(one[0] @ ref[0]) >= 0.999
    texts = ["a photo of a cat", "two dogs"]
    t_gpu, t_cpu = gpu.encode_texts(texts), cpu.encode_texts(texts)
    assert (np.sum(t_gpu * t_cpu, axis=1) >= 0.999).all()


@pytest.mark.parametrize("quantized", [False, True])
def test_search_on_the_card_matches_the_cpu(cuda_device, quantized):
    """The same ids on the card as on the CPU; scores within 1e-5 (f32
    summation order). The int8 scan is exact integer arithmetic on both."""
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((20_500, 64), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[[3, 900, 20_000]] + 0.05 * rng.standard_normal(
        (3, 64), dtype=np.float32)
    gpu = teng.VectorIndex.from_vectors(corpus, quantized, cuda_device)
    cpu = teng.VectorIndex.from_vectors(corpus, quantized, "cpu")
    Dg, Ig = gpu.search(queries, 50)
    Dc, Ic = cpu.search(queries, 50)
    np.testing.assert_array_equal(Ig, Ic)
    np.testing.assert_allclose(Dg, Dc, atol=1e-5, rtol=0)
    codes, _ = teng._quantize_device(torch.from_numpy(corpus))
    q_codes = codes[:5]
    assert torch.equal(
        teng._int8_scores(codes.to(cuda_device), q_codes.to(cuda_device)
                          ).cpu(), teng._int8_scores(codes, q_codes))
