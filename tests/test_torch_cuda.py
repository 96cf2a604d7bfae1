"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the Encoder and the search engine on CUDA against the
same code on the CPU.

Every test here is marked ``cuda`` and skips without a GPU. This file
imports neither JAX nor clipx, so it runs on a machine that has only
PyTorch and a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import base64
import json
import sys
import threading
import time
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from clipx_torch import config as tcfg
from clipx_torch.models import convert as tconvert
from clipx_torch.models import quant as tquant
from clipx_torch.ops import flash_attention as tfa
from clipx_torch.ops import packed_sdpa as tps
from clipx_torch.ops import pq_scan as tpq_scan
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


# B1 (and B2, B3 on the same shapes): the ragged last batch row of an odd
# batch (TMA's zero fill past the end), S = 64 (no key masked), ViT-B/32's
# indexing batch, W = 1024 (16 heads), widths 128 and 192, S = 1
@pytest.mark.parametrize("b,s,w,heads", [(1, 50, 768, 12), (2, 50, 768, 12),
                                         (8, 50, 768, 12), (2, 17, 128, 2),
                                         (4, 64, 192, 3), (3, 1, 128, 2),
                                         (5, 50, 768, 12), (2, 64, 768, 12),
                                         (128, 50, 768, 12),
                                         (2, 50, 1024, 16)])
def test_kernels_match_plain_versions(cuda_device, b, s, w, heads):
    gen = torch.Generator().manual_seed(b * s + w)
    x = _bf(gen, cuda_device, b, s, w)
    wqkv = _bf(gen, cuda_device, w, 3 * w, scale=0.03)
    wo = _bf(gen, cuda_device, w, w, scale=0.03)
    bqkv = (torch.randn(3 * w, generator=gen) * 0.01).to(cuda_device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(cuda_device)
    before = dict(tps.LAUNCHES)
    out = tps.fused_attn_block(x, wqkv, bqkv, wo, bo, heads=heads)
    # one count per call, though the call launches two kernels
    assert {n: c - before[n] for n, c in tps.LAUNCHES.items()
            if c != before[n]} == {"fused_attn_block": 1}
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


# B8: (B, S, W, heads, causal): S past one 128-row query tile and one
# 64-key tile, D = 32, 64 and 128, ViT-B/16's and ViT-L/14@336's widths
@pytest.mark.parametrize("b,s,w,heads,causal", [
    (2, 130, 256, 4, False), (2, 130, 256, 4, True), (3, 197, 768, 12, False),
    (2, 577, 1024, 16, False), (2, 77, 768, 12, True), (2, 77, 128, 4, True),
    (1, 300, 256, 2, False), (2, 1, 128, 2, False)])
def test_fused_sdpa_long_matches_plain(cuda_device, b, s, w, heads, causal):
    gen = torch.Generator().manual_seed(b * s + w)
    q, k, v = (_bf(gen, cuda_device, b, s, w) for _ in range(3))
    before = tps.LAUNCHES["fused_sdpa_long"]
    out = tps.fused_sdpa_long(q, k, v, heads=heads, causal=causal)
    assert tps.LAUNCHES["fused_sdpa_long"] == before + 1
    ref = tps.fused_sdpa_long_plain(q, k, v, heads=heads, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL,
                               atol=ATOL)


# B9: W = 256 (tile 64), 768 (ViT-B/16's width; tile 192 at 64 x 197
# rows, 64 at 2 x 77), 1024 (ViT-L/14@336's; tile 64 at 2 x 577)
@pytest.mark.parametrize("b,s,w,heads,causal", [
    (2, 130, 256, 4, False), (2, 77, 768, 12, True), (2, 577, 1024, 16, False),
    (64, 197, 768, 12, False)])
def test_fused_sdpa_long_qkv_matches_plain(cuda_device, b, s, w, heads,
                                           causal):
    gen = torch.Generator().manual_seed(b * s + w + 1)
    qkv = _bf(gen, cuda_device, b, s, 3 * w)
    wo = _bf(gen, cuda_device, w, w, scale=0.03)
    bo = (torch.randn(w, generator=gen) * 0.01).to(cuda_device)
    before = tps.LAUNCHES["fused_sdpa_long_qkv"]
    out = tps.fused_sdpa_long_qkv(qkv, wo, bo, heads=heads, causal=causal)
    assert tps.LAUNCHES["fused_sdpa_long_qkv"] == before + 1
    ref = tps.fused_sdpa_long_qkv_plain(qkv, wo, bo, heads=heads,
                                        causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, w)
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape,causal", [
    ((2, 2, 130, 64), False), ((1, 2, 77, 32), True), ((2, 16, 577, 64), False),
    ((1, 2, 200, 128), True), ((3, 1, 50, 64), False)])
def test_flash_attention_matches_plain(cuda_device, shape, causal):
    gen = torch.Generator().manual_seed(sum(shape))
    q, k, v = (_bf(gen, cuda_device, *shape) for _ in range(3))
    before = tps.LAUNCHES["flash_attention"]
    out = tfa.flash_attention(q, k, v, causal=causal)
    assert tps.LAUNCHES["flash_attention"] == before + 1
    ref = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("b,s,w,heads", [(2, 50, 768, 12), (4, 64, 192, 3),
                                         (128, 50, 768, 12)])
def test_packed_sdpa_qkv_equals_packed_sdpa(cuda_device, b, s, w, heads):
    """B4 runs B2's kernel on the packed projection: the same bits."""
    gen = torch.Generator().manual_seed(b + s + w)
    qkv = _bf(gen, cuda_device, b, s, 3 * w)
    q, k, v = (qkv[..., i * w:(i + 1) * w].contiguous() for i in range(3))
    before = tps.LAUNCHES["packed_sdpa_qkv"]
    out = tps.packed_sdpa_qkv(qkv, heads=heads)
    assert tps.LAUNCHES["packed_sdpa_qkv"] == before + 1
    pairs = (tps.packed_sdpa if heads % 2 == 0 else tps.packed_sdpa_rows)
    assert torch.equal(out, pairs(q, k, v, heads=heads))
    torch.testing.assert_close(
        out.float(), tps.packed_sdpa_qkv_plain(qkv, heads=heads).float(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,s,w,heads", [(2, 50, 768, 12), (128, 50, 768, 12),
                                         (4, 17, 128, 2), (2, 1, 128, 2),
                                         (2, 64, 768, 12)])
def test_packed_sdpa_equals_packed_sdpa_rows(cuda_device, b, s, w, heads):
    """B2, B3 and B4 launch one kernel (csrc/sdpa_sm90.cuh) on its
    one-tile path: the same bits on the same input, B4 on the packed rows,
    and fused_sdpa_long too, which takes that path at S <= 64."""
    gen = torch.Generator().manual_seed(b + s + w + 3)
    qkv = _bf(gen, cuda_device, b, s, 3 * w)
    q, k, v = (qkv[..., i * w:(i + 1) * w].contiguous() for i in range(3))
    pairs = tps.packed_sdpa(q, k, v, heads=heads)
    assert torch.equal(pairs, tps.packed_sdpa_rows(q, k, v, heads=heads))
    assert torch.equal(pairs, tps.packed_sdpa_qkv(qkv, heads=heads))
    assert torch.equal(pairs, tps.fused_sdpa_long(q, k, v, heads=heads))


# The SDPA kernel's sweep: S of one key tile and its edges, of several, and
# of the long towers; D of each instance; causal where marked
SWEEP = [(s, False) for s in (1, 50, 63, 64, 65, 77, 127, 128, 129, 197, 257,
                              577)] + [(s, True) for s in (1, 65, 77, 129, 257)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s,causal", SWEEP)
def test_sdpa_kernel_sweep_matches_plain(cuda_device, s, causal, d):
    """csrc/sdpa_sm90.cuh in each layout its wrappers give it: B8's
    (B, S, H*D), the packed (B, S, 3W) projection of B4 and B9 (B4's
    launcher takes any S and D) and B10's (B, H, S, D); odd and even B.
    1e-2 + 2e-2 |y| against plain bf16, 3e-2 + 3e-2 |y| against f32."""
    h, w = 4, 4 * d
    b = 3 if (s + d) % 2 else 2
    gen = torch.Generator().manual_seed(s * d + causal)
    qkv = _bf(gen, cuda_device, b, s, 3 * w)
    q, k, v = (qkv[..., i * w:(i + 1) * w].contiguous() for i in range(3))
    ref = tps.sdpa_plain(q, k, v, heads=h, causal=causal).float()
    truth = tps.sdpa_plain(q.float(), k.float(), v.float(), heads=h,
                           causal=causal)

    def bhsd(t):
        return t.view(b, s, h, d).transpose(1, 2)

    outs = {"bshd": tps.fused_sdpa_long(q, k, v, heads=h, causal=causal),
            "packed": tps._launch_sdpa_qkv(qkv, h, causal),
            "bhsd": tfa.flash_attention(*(bhsd(t).contiguous()
                                          for t in (q, k, v)),
                                        causal=causal).transpose(1, 2)
            .reshape(b, s, w)}
    torch.cuda.synchronize()
    for layout, out in outs.items():
        assert out.shape == (b, s, w), layout
        torch.testing.assert_close(out.float(), ref, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{layout}: {m}")
        torch.testing.assert_close(out.float(), truth, rtol=3e-2, atol=3e-2,
                                   msg=lambda m: f"{layout} vs f32: {m}")


def test_sdpa_refuses_layouts_tma_cannot_take(cuda_device):
    """A base that is not 16-byte aligned or a stride that is not a 16-byte
    multiple raises ValueError: the kernel's tensor maps cannot read it,
    and no other kernel takes its place."""
    gen = torch.Generator().manual_seed(5)
    flat = _bf(gen, cuda_device, 2 * 100 * 256 + 8)
    q = flat[1:1 + 2 * 100 * 256].view(2, 100, 256)      # 2 bytes off
    before = dict(tps.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tps.fused_sdpa_long(q, q, q, heads=4)
    q = flat[1:1 + 2 * 50 * 256].view(2, 50, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tps.packed_sdpa(q, q, q, heads=4)
    ok = _bf(gen, cuda_device, 2, 100, 256)
    out = torch.empty_like(ok)
    with pytest.raises(ValueError, match="strides"):
        tps.launch_sdpa("fused_sdpa_long", ok.data_ptr(), ok.data_ptr(),
                        ok.data_ptr(), out, batch=2, heads=4, seq=50,
                        head_dim=64, in_strides=(100 * 256, 64, 260),
                        out_strides=(100 * 256, 64, 256), causal=False)
    assert tps.LAUNCHES == before


def test_long_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(1)
    q = _bf(gen, cuda_device, 2, 100, 192)
    with pytest.raises(ValueError, match="head dims"):      # D = 48
        tps.fused_sdpa_long(q, q, q, heads=4)
    with pytest.raises(ValueError, match="bfloat16"):
        tps.fused_sdpa_long(q.float(), q.float(), q.float(), heads=3)
    with pytest.raises(ValueError, match="contiguous"):
        t = _bf(gen, cuda_device, 2, 2, 64, 100).transpose(2, 3)
        tfa.flash_attention(t, t, t)
    qkv = _bf(gen, cuda_device, 2, 100, 3 * 96)             # W = 96
    with pytest.raises(ValueError, match="W % 64"):
        tps.fused_sdpa_long_qkv(qkv, _bf(gen, cuda_device, 96, 96),
                                torch.zeros(96, device=cuda_device), heads=3)
    with pytest.raises(ValueError, match="even B"):
        tps.packed_sdpa_qkv(_bf(gen, cuda_device, 3, 50, 3 * 128), heads=2)


def test_vit_b16_encoder_on_the_card_matches_the_cpu(cuda_device):
    """ViT-B/16 at full width (S = 197): every bucket's 12 attention
    layers go through fused_sdpa_long; bf16 on the card vs f32 on the CPU
    from the same seeded weights, cosine >= 0.99."""
    params = tconvert.init_params(tcfg.get_config("ViT-B/16"), seed=0)
    cfg = tcfg.get_config("ViT-B/16")
    gpu = Encoder(cfg, params, device=cuda_device, batch_buckets=(1, 4))
    cpu = Encoder(cfg, params, device="cpu", batch_buckets=(1, 4))
    images = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3),
                                               dtype=np.uint8)
    tps.reset_launches()
    one = gpu.encode_images(images[:1])
    three = gpu.encode_images(images)
    assert tps.LAUNCHES["fused_sdpa_long"] == 24
    ref = cpu.encode_images(images[:2])
    assert (np.sum(three[:2] * ref, axis=1) >= 0.99).all()
    assert float(one[0] @ three[0]) >= 0.99


def _d64_long():
    """The d64 test config at image 160 / patch 16: S = 101."""
    return tcfg.CLIPConfig(
        name="d64-long-test",
        vision=tcfg.VisionConfig(image_size=160, patch_size=16, width=128,
                                 layers=2, heads=2, embed_dim=64),
        text=tcfg.TextConfig(context_length=77, vocab_size=49408, width=64,
                             layers=2, heads=2, embed_dim=64))


@pytest.mark.parametrize("route", ["auto", "qkv", "pallas"])
def test_long_routes_on_the_card_match_the_cpu(cuda_device, monkeypatch,
                                               route):
    """S = 101 under each route: the default (fused_sdpa_long),
    CLIPX_PACKED_SDPA=qkv (fused_sdpa_long_qkv) and attn_impl="pallas"
    (flash_attention); cosine >= 0.999 against the CPU."""
    if route == "qkv":
        monkeypatch.setenv("CLIPX_PACKED_SDPA", "qkv")
    impl = "pallas" if route == "pallas" else "auto"
    params = tconvert.init_params(_d64_long(), seed=0)
    gpu = Encoder(_d64_long(), params, device=cuda_device, attn_impl=impl,
                  batch_buckets=(4,))
    cpu = Encoder(_d64_long(), params, device="cpu", attn_impl=impl,
                  batch_buckets=(4,))
    images = np.random.default_rng(1).integers(0, 256, (4, 160, 160, 3),
                                               dtype=np.uint8)
    tps.reset_launches()
    out = gpu.encode_images(images)
    name = {"auto": "fused_sdpa_long", "qkv": "fused_sdpa_long_qkv",
            "pallas": "flash_attention"}[route]
    assert tps.LAUNCHES[name] == 2
    assert sum(tps.LAUNCHES.values()) == 2
    assert (np.sum(out * cpu.encode_images(images), axis=1) >= 0.999).all()


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


# B11: row counts around the 64-row warp tile and a ragged corpus, halves
# that are and are not multiples of the kernel's 8-byte loads (up to D =
# 1024 at dsub 2), 1 to 16 queries (one and two n8 blocks), int8 and
# integer bf16 LUTs
@pytest.mark.parametrize("half", [8, 24, 64, 128, 256])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1_000_037])
def test_pq_scan_kernel_matches_plain_bitwise(cuda_device, n, half):
    """Integer sums: the kernel and its plain version agree bitwise, for Q
    in {1, 3, 8, 9, 16} and both LUT types (and the CPU's plain version too,
    at the small row counts)."""
    rng = np.random.default_rng(n + half)
    packed = torch.from_numpy(rng.integers(-128, 128, (n, half),
                                           dtype=np.int8)).to(cuda_device)
    for q in (1, 3, 8, 9, 16):
        lut8 = torch.from_numpy(rng.integers(-127, 128, (half * 32, q),
                                             dtype=np.int8)).to(cuda_device)
        for lut in (lut8, lut8.to(torch.bfloat16)):
            before = tps.LAUNCHES["pq_scan_scores"]
            out = tpq_scan.pq_scan_scores(packed, lut)
            assert tps.LAUNCHES["pq_scan_scores"] == before + 1
            ref = tpq_scan.pq_scan_scores_plain(packed, lut)
            torch.cuda.synchronize()
            assert out.shape == (q, n) and out.dtype == torch.float32
            assert torch.equal(out, ref), (q, lut.dtype)
            if n < 1000:
                assert torch.equal(out.cpu(), tpq_scan.pq_scan_scores(
                    packed.cpu(), lut.cpu()))


@pytest.mark.parametrize("half", [24, 256])
@pytest.mark.parametrize("n", [65, 1_000_037])
def test_pq_scan_kernel_extreme_sums(cuda_device, n, half):
    """All-0 and all-15 nibbles against +-127 LUTs: every score is the
    extreme sum +-127 * M, exactly, as in the plain version."""
    for byte in (0, -1):
        packed = torch.full((n, half), byte, dtype=torch.int8,
                            device=cuda_device)
        for v in (127, -127):
            lut = torch.full((half * 32, 16), v, dtype=torch.int8,
                             device=cuda_device)
            out = tpq_scan.pq_scan_scores(packed, lut)
            ref = tpq_scan.pq_scan_scores_plain(packed, lut)
            torch.cuda.synchronize()
            assert torch.equal(out, ref)
            assert bool((out == v * 2 * half).all())


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4", "pq"])
def test_coded_tiers_on_the_card_match_the_cpu(cuda_device, dtype):
    """The same host codes placed on the card and on the CPU: identical
    ids, scores within 1e-5 (f32 summation order)."""
    rng = np.random.default_rng(2)
    corpus = rng.standard_normal((6000, 64), dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[[3, 900, 5000]] + 0.05 * rng.standard_normal(
        (3, 64), dtype=np.float32)
    gpu = teng.VectorIndex.from_vectors(corpus, device=cuda_device,
                                        dtype=dtype)
    cpu = teng.VectorIndex.from_vectors(corpus, device="cpu", dtype=dtype)
    tps.reset_launches()
    for k in (1, 50):
        Dg, Ig = gpu.search(queries, k)
        Dc, Ic = cpu.search(queries, k)
        np.testing.assert_array_equal(Ig, Ic)
        np.testing.assert_allclose(Dg, Dc, atol=1e-5, rtol=1e-5)
    assert (tps.LAUNCHES["pq_scan_scores"] > 0) == (dtype == "pq")
    np.testing.assert_array_equal(gpu.vectors(), cpu.vectors())


@pytest.mark.parametrize("dtype", ["f32", "pq"])
def test_search_keeps_full_f32_when_the_caller_enables_tf32(cuda_device,
                                                           dtype):
    """A caller's TF32 setting does not reach the search's f32 products
    (scan, LUTs, rescore), and the setting is restored afterwards."""
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((6000, 64), dtype=np.float32)
    queries = corpus[[1, 2]] + 0.05 * rng.standard_normal((2, 64),
                                                          dtype=np.float32)
    gpu = teng.VectorIndex.from_vectors(corpus, device=cuda_device,
                                        dtype=dtype)
    cpu = teng.VectorIndex.from_vectors(corpus, device="cpu", dtype=dtype)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Dg, Ig = gpu.search(queries, 50)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    Dc, Ic = cpu.search(queries, 50)
    np.testing.assert_array_equal(Ig, Ic)
    np.testing.assert_allclose(Dg, Dc, atol=1e-5, rtol=1e-5)


def _mlp_weights(gen, device, w, h):
    w1 = _bf(gen, device, w, h, scale=0.03)
    w2 = _bf(gen, device, h, w, scale=0.03)
    b1 = (torch.randn(h, generator=gen) * 0.01).to(device)
    b2 = (torch.randn(w, generator=gen) * 0.01).to(device)
    return w1, b1, w2, b2


# B7: ViT-B/32's image MLP at an odd row count, a row count past several
# 128-row tiles, its batch-128 rows and a single row, and its text tower's
# 512-wide MLP
@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("rows,w,h", [(99, 768, 3072), (640, 768, 3072),
                                      (154, 512, 2048), (6400, 768, 3072),
                                      (1, 768, 3072)])
def test_fused_mlp_matches_plain(cuda_device, rows, w, h, quick):
    gen = torch.Generator().manual_seed(rows + w + quick)
    x = _bf(gen, cuda_device, rows, w)
    args = _mlp_weights(gen, cuda_device, w, h)
    before = tps.LAUNCHES["fused_mlp"]
    out = tps.fused_mlp(x, *args, quick=quick)
    assert tps.LAUNCHES["fused_mlp"] == before + 1
    ref = tps.fused_mlp_plain(x, *args, quick=quick)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL,
                               atol=ATOL)


# B6 at the same image-MLP shapes and a narrow one, with and without the
# K-major weight copies that quantize_mlp_stack makes
@pytest.mark.parametrize("kmajor", [True, False])
@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("rows,w,h", [(99, 768, 3072), (640, 768, 3072),
                                      (64, 128, 512)])
def test_fused_mlp_w8a8_matches_plain(cuda_device, rows, w, h, quick,
                                      kmajor):
    """The first stage's int8 codes and row scales bitwise; the output
    within 1e-2 of max|ref| (clipx's fused-versus-unfused bound: an
    activation a few ulps off can round a requantized code the other
    way); the wrapper gives the same output with the copies as without,
    and transposes the weights itself only without them."""
    gen = torch.Generator().manual_seed(rows + w + quick + 1)
    x = _bf(gen, cuda_device, rows, w)
    w1, b1, w2, b2 = _mlp_weights(gen, cuda_device, w, h)
    (w1_q, s1), (w2_q, s2) = tquant.quantize_weight(w1), tquant.quantize_weight(w2)
    cpu_q, cpu_s = tquant.quantize_weight(w1.cpu())  # the same bits
    assert torch.equal(w1_q.cpu(), cpu_q) and torch.equal(s1.cpu(), cpu_s)
    args = (w1_q, s1, b1, w2_q, s2, b2)
    copies = {"w1_qt": w1_q.T.contiguous(), "w2_qt": w2_q.T.contiguous()}
    before = tps.LAUNCHES["fused_mlp_w8a8"]
    out, xq, xs = tps.launch_mlp_w8a8(x, copies["w1_qt"], s1, b1,
                                      copies["w2_qt"], s2, b2, quick=quick)
    assert tps.LAUNCHES["fused_mlp_w8a8"] == before + 1
    ref = tps.fused_mlp_w8a8_plain(x, *args, quick=quick)
    ref_q, ref_s = tquant.quantize_rows(x.float())
    torch.cuda.synchronize()
    assert torch.equal(xq, ref_q) and torch.equal(xs, ref_s.reshape(-1))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    err = float((out.float() - ref.float()).abs().max())
    assert err <= 1e-2 * float(ref.float().abs().max())
    transposes = tps.W8A8_WEIGHT_COPIES["calls"]
    again = tps.fused_mlp_w8a8(x, *args, quick=quick,
                               **(copies if kmajor else {}))
    assert torch.equal(again, out)
    assert tps.W8A8_WEIGHT_COPIES["calls"] == transposes + (not kmajor)


@pytest.mark.parametrize("b,s,w,heads", [(2, 50, 768, 12), (128, 50, 768, 12),
                                         (4, 17, 128, 2), (2, 64, 192, 3),
                                         (2, 64, 768, 12), (4, 50, 1024, 16)])
def test_fused_attn_sublayer_matches_plain(cuda_device, b, s, w, heads):
    gen = torch.Generator().manual_seed(b * s + w + 2)
    x = _bf(gen, cuda_device, b, s, w)
    ln_s = (1.0 + 0.1 * torch.randn(w, generator=gen)).to(cuda_device)
    ln_b = (0.05 * torch.randn(w, generator=gen)).to(cuda_device)
    wqkv = _bf(gen, cuda_device, w, 3 * w, scale=0.03)
    wo = _bf(gen, cuda_device, w, w, scale=0.03)
    bqkv = (torch.randn(3 * w, generator=gen) * 0.01).to(cuda_device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(cuda_device)
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    before = dict(tps.LAUNCHES)
    out = tps.fused_attn_sublayer(*args, heads=heads)
    assert {n: c - before[n] for n, c in tps.LAUNCHES.items()
            if c != before[n]} == {"fused_attn_sublayer": 1}
    ref = tps.fused_attn_sublayer_plain(*args, heads=heads)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("bn", [64, 128, 192])
def test_sm90_gemm_tile_widths_match_plain(cuda_device, bn):
    """Every gemm_sm90 instance that B7 and B9 can launch (each tile width
    with the bias and both activation epilogues), whatever width the
    wrappers' rule picks at the tested shapes: B7 at 99 rows x 768 -> 3072
    with both activations, B9 at W = 768 (tile 64, 128 and 192 divide it)."""
    gen = torch.Generator().manual_seed(bn)
    x = _bf(gen, cuda_device, 99, 768)
    args = _mlp_weights(gen, cuda_device, 768, 3072)
    for quick in (True, False):
        out = tps._launch_mlp(x, *args, quick, (bn, bn))
        ref = tps.fused_mlp_plain(x, *args, quick=quick)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL,
                                   atol=ATOL)
    qkv = _bf(gen, cuda_device, 2, 130, 3 * 768)
    wo = _bf(gen, cuda_device, 768, 768, scale=0.03)
    bo = (torch.randn(768, generator=gen) * 0.01).to(cuda_device)
    out = tps._launch_long_qkv(qkv, wo, bo, 12, False, bn)
    ref = tps.fused_sdpa_long_qkv_plain(qkv, wo, bo, heads=12)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL, atol=ATOL)


def _kernel_names(fn, per_launch: int = 0, tries: int = 3) -> list:
    """The CUDA kernels one call of fn launches, by torch.profiler. A
    session that records no device kernel at all is repeated, up to tries
    sessions, as chip_smoke.py repeats its own: on the H100 such a session
    has come back empty for kernels that the same code profiled before.
    With ``per_launch``, the kernels each counted launch (``LAUNCHES``)
    runs, a session that records fewer kernel launches than the call's
    counts ask for is repeated too: on the H100 one session lost one of
    B6's two row quantizers. Each session first launches torch's spin
    kernel, which the names leave out, as chip_smoke.py's sessions do: each
    kernel a session lost was of the kind fn launches first. The last
    session's names are returned, so a call that really launches too few
    still fails its test."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        before = sum(tps.launch_counts().values())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        launched = sum(tps.launch_counts().values()) - before
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.key]
        names = [e.key for e in events]
        if names and sum(e.count for e in events) >= per_launch * launched:
            return names
    return names


@pytest.mark.parametrize("kernel", ["fused_mlp", "fused_sdpa_long_qkv"])
def test_b7_and_b9_gemms_run_on_the_sm90_gemm(cuda_device, kernel):
    """B7 launches two gemm_sm90 kernels and B9 its SDPA (sdpa_sm90) and
    one gemm_sm90 kernel; neither launches the retired mma.sync GEMM
    (gemm_bias_kernel) or anything else."""
    gen = torch.Generator().manual_seed(4)
    if kernel == "fused_mlp":
        x = _bf(gen, cuda_device, 640, 768)
        args = _mlp_weights(gen, cuda_device, 768, 3072)
        want = {"gemm_sm90": 2}
        names = _kernel_names(lambda: tps.fused_mlp(x, *args),
                              sum(want.values()))
    else:
        qkv = _bf(gen, cuda_device, 2, 130, 3 * 256)
        wo = _bf(gen, cuda_device, 256, 256, scale=0.03)
        bo = torch.zeros(256, device=cuda_device)
        want = {"gemm_sm90": 1, "sdpa_sm90": 1}
        names = _kernel_names(
            lambda: tps.fused_sdpa_long_qkv(qkv, wo, bo, heads=4),
            sum(want.values()))
    if not names:
        pytest.fail("torch.profiler saw no CUDA kernel")
    assert not any("gemm_bias" in n for n in names), names
    got = {key: sum(key in n for n in names) for key in want}
    assert got == want and len(names) == sum(want.values()), names


def test_mlp_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(3)
    x = _bf(gen, cuda_device, 64, 128)
    w1, b1, w2, b2 = _mlp_weights(gen, cuda_device, 128, 512)
    with pytest.raises(ValueError, match="bfloat16"):
        tps.fused_mlp(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="int8"):
        tps.fused_mlp_w8a8(x, w1, b1, b1, w2, b2, b2)
    (w1_q, s1), (w2_q, s2) = tquant.quantize_weight(w1), tquant.quantize_weight(w2)
    with pytest.raises(ValueError, match="is on"):
        tps.fused_mlp_w8a8(x, w1_q.cpu(), s1, b1, w2_q, s2, b2)
    with pytest.raises(ValueError, match="W % 64"):
        tps.fused_mlp(_bf(gen, cuda_device, 4, 96), *_mlp_weights(
            gen, cuda_device, 96, 384))
    ln = torch.ones(128, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        tps.fused_attn_sublayer(x.float().reshape(2, 32, 128), ln, ln,
                                w1[:, :384], b1[:384], w1[:, :128], b2,
                                heads=2)


@pytest.mark.parametrize("kernel", ["fused_mlp_w8a8", "pq_scan_scores"])
def test_b6_and_b11_launch_only_their_redesigned_kernels(cuda_device, kernel):
    """B6 launches its two row quantizers and two TMA + wgmma int8 GEMMs
    (gemm_s8_sm90_kernel), B11 its one-hot scan (pq_scan_onehot_kernel), and
    nothing else: no retired kernel (the mma.sync gemm_s8_kernel, the
    lane-packed pq_scan_kernel<QW>) and no library GEMM (_int_mm, cuBLAS,
    CUTLASS)."""
    gen = torch.Generator().manual_seed(9)
    if kernel == "fused_mlp_w8a8":
        x = _bf(gen, cuda_device, 640, 768)
        w1, b1, w2, b2 = _mlp_weights(gen, cuda_device, 768, 3072)
        (w1_q, s1), (w2_q, s2) = (tquant.quantize_weight(w1),
                                  tquant.quantize_weight(w2))
        kw = {"w1_qt": w1_q.T.contiguous(), "w2_qt": w2_q.T.contiguous()}
        want = {"quant_rows_kernel": 2, "gemm_s8_sm90_kernel": 2}
        names = _kernel_names(lambda: tps.fused_mlp_w8a8(
            x, w1_q, s1, b1, w2_q, s2, b2, **kw), sum(want.values()))
    else:
        packed = torch.randint(-128, 128, (4096 + 37, 128), generator=gen,
                               dtype=torch.int8).to(cuda_device)
        lut = torch.randint(-127, 128, (128 * 32, 16), generator=gen,
                            dtype=torch.int8).to(cuda_device)
        want = {"pq_scan_onehot_kernel": 1}
        names = _kernel_names(lambda: tpq_scan.pq_scan_scores(packed, lut),
                              sum(want.values()))
    if not names:
        pytest.fail("torch.profiler saw no CUDA kernel")
    banned = ("gemm_s8_kernel", "pq_scan_kernel<", "_int_mm", "cublas",
              "cutlass", "gemmk", "sm90_xmma")
    assert not any(b in n.lower() for n in names for b in banned), names
    got = {key: sum(key in n for n in names) for key in want}
    assert got == want and len(names) == sum(want.values()), names


@pytest.mark.parametrize("kernel", ["packed_sdpa", "packed_sdpa_rows",
                                    "packed_sdpa_qkv", "fused_sdpa_long",
                                    "flash_attention"])
def test_sdpa_wrappers_launch_only_the_sm90_kernel(cuda_device, kernel):
    """Each SDPA wrapper launches one sdpa_sm90_kernel and nothing else; no
    retired kernel (short_sdpa, long_sdpa_kernel) is left to launch."""
    gen = torch.Generator().manual_seed(6)
    s = 130 if kernel in ("fused_sdpa_long", "flash_attention") else 50
    qkv = _bf(gen, cuda_device, 2, s, 3 * 768)
    q, k, v = (qkv[..., i * 768:(i + 1) * 768].contiguous() for i in range(3))
    if kernel == "packed_sdpa_qkv":
        names = _kernel_names(lambda: tps.packed_sdpa_qkv(qkv, heads=12), 1)
    elif kernel == "flash_attention":
        t = q.view(2, s, 12, 64).transpose(1, 2).contiguous()
        names = _kernel_names(lambda: tfa.flash_attention(t, t, t), 1)
    else:
        fn = getattr(tps, kernel)
        names = _kernel_names(lambda: fn(q, k, v, heads=12), 1)
    if not names:
        pytest.fail("torch.profiler saw no CUDA kernel")
    assert len(names) == 1 and "sdpa_sm90_kernel<64>" in names[0], names


@pytest.mark.parametrize("route", ["int8", "int8_fused", "fused", "sublayer"])
def test_opt_in_routes_on_the_card_match_the_cpu(cuda_device, monkeypatch,
                                                 route):
    """The d64 config (W = 128, 2 layers, S = 17) under each opt-in route,
    bucket 4: --compute int8 unfused (dense_w8a8 on _int_mm) and with
    CLIPX_FUSED_MLP_INT8=on (fused_mlp_w8a8), CLIPX_FUSED_MLP=on (fused_mlp
    in both towers) and CLIPX_PACKED_SDPA=sublayer (fused_attn_sublayer);
    the launches counted, and the embeddings against the CPU's f32 encode
    of the same route, cosine >= 0.999 (0.99 for the int8 routes, whose
    activation codes the bf16 rounding moves)."""
    env = {"int8_fused": {"CLIPX_FUSED_MLP_INT8": "on"},
           "fused": {"CLIPX_FUSED_MLP": "on"},
           "sublayer": {"CLIPX_PACKED_SDPA": "sublayer"}}.get(route, {})
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    quant = "int8" if route.startswith("int8") else None
    params = tconvert.init_params(_d64(), seed=0)
    gpu = Encoder(_d64(), params, device=cuda_device, batch_buckets=(4,),
                  compute_quant=quant)
    cpu = Encoder(_d64(), params, device="cpu", batch_buckets=(4,),
                  compute_quant=quant)
    images = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    texts = ["a photo of a cat", "two dogs"]
    tps.reset_launches()
    out = gpu.encode_images(images)
    t_gpu = gpu.encode_texts(texts)
    want = {"int8": {"fused_attn_block": 2},
            "int8_fused": {"fused_attn_block": 2, "fused_mlp_w8a8": 2},
            "fused": {"fused_attn_block": 2, "fused_mlp": 4},
            "sublayer": {"fused_attn_sublayer": 2}}[route]
    assert {k: n for k, n in tps.LAUNCHES.items() if n} == want
    floor = 0.99 if quant else 0.999
    assert (np.sum(out * cpu.encode_images(images), axis=1) >= floor).all()
    assert (np.sum(t_gpu * cpu.encode_texts(texts), axis=1) >= 0.999).all()


# -- IVF search (clipx_torch/search/ivf.py) -------------------------------------

IVF_TIERS = {"f32": ("f32", False, "off"), "f32_quant": ("f32", True, "off"),
             "bf16": ("bf16", False, "off"), "int8": ("int8", False, "off"),
             "int4": ("int4", False, "off"), "pq": ("pq", False, "off"),
             "pq_residual": ("pq", False, "on")}
# scores closer than this are ties up to f32 summation order (a few ulps)
IVF_TIE = 2e-6


def _ivf_corpus(n=20_000, dim=64, clusters=40, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim), dtype=np.float32)
    x = centers[rng.integers(0, clusters, n)] + 0.3 * rng.standard_normal(
        (n, dim), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, 5, replace=False)] + 0.05 * rng.standard_normal(
        (5, dim), dtype=np.float32)
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
        np.float32)


def _assert_same_ranking(D, I, Dr, Ir):
    """Scores within 1e-5; ids identical except within a run of reference
    scores closer than IVF_TIE (the same set there, unless the run reaches
    rank k)."""
    np.testing.assert_allclose(D, Dr, atol=1e-5, rtol=0)
    k = Ir.shape[1]
    for d, ours, ref in zip(Dr, I, Ir):
        start = 0
        while start < k:
            end = start + 1
            while (end < k and np.isfinite(d[end])
                   and d[end - 1] - d[end] <= IVF_TIE):
                end += 1
            if end - start == 1:
                assert ours[start] == ref[start]
            elif end < k:
                assert set(ours[start:end]) == set(ref[start:end])
            start = end


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("nprobe", [1, 32, 100])
def test_ivf_pq_probe_runs_b11_once_per_query_and_chunk(cuda_device,
                                                        monkeypatch, nprobe,
                                                        nq):
    """The IVF-PQ probe on the card launches B11's kernel once per (query,
    probed chunk), never its plain version nor a library int8 GEMM, and on
    the probe's own chunk gathers (dead rows of ragged segments included;
    at nprobe 100 a ragged last chunk, with 4 KiB-row chunks) the kernel
    equals pq_scan_scores_plain bitwise."""
    from clipx_torch.search import ivf as tivf
    from clipx_torch.search import pq as tpq

    corpus, queries = _ivf_corpus()
    idx = tivf.IVFIndex.from_vectors(corpus, dtype="pq", device=cuda_device)
    plain = tpq_scan.pq_scan_scores_plain
    monkeypatch.setattr(tivf, "_PROBE_CHUNK_ROWS", 4096)

    def refuse(*args):
        raise AssertionError("the IVF path called pq_scan_scores_plain")

    monkeypatch.setattr(tpq_scan, "pq_scan_scores_plain", refuse)
    P = idx.probe_bucket(50, nprobe)
    pc = tivf._pq_chunk_segs(P, 64)
    tps.reset_launches()
    idx.search(queries[:nq], 50, nprobe=nprobe)
    assert {k: n for k, n in tps.LAUNCHES.items() if n} == {
        "pq_scan_scores": nq * -(-P // pc)}
    names = _kernel_names(lambda: idx.search(queries[:nq], 50,
                                             nprobe=nprobe))
    scans = [n for n in names if "pq_scan" in n]
    assert len(scans) == 1 and "pq_scan_onehot_kernel<1>" in scans[0], names
    # no int8 library GEMM (the plain version's one-hot product)
    assert not any("gemm" in n.lower() and ("s8" in n or "i8" in n)
                   for n in names), names
    monkeypatch.setattr(tpq_scan, "pq_scan_scores_plain", plain)
    with torch.inference_mode():
        q1 = torch.from_numpy(teng.rotate_rows(queries[:1], idx._rot)).to(
            cuda_device)
        _, seg_idx = tivf._coarse(q1, idx._seg_cent, P)
        _, luti, _ = tpq.quantized_luts(q1, idx._pq.device(cuda_device))
        ragged = False
        for s0 in range(0, P, pc):
            cs = seg_idx[0, s0: s0 + pc]
            chunk = idx._codes3[cs].reshape(len(cs) * 64, -1)
            ragged |= not bool(idx._valid2[cs].all())
            out = tpq_scan.pq_scan_scores(chunk, luti[0][:, None])
            ref = plain(chunk, luti[0][:, None])
            torch.cuda.synchronize()
            assert torch.equal(out, ref)
    assert ragged


@pytest.mark.parametrize("tier", list(IVF_TIERS))
def test_ivf_tiers_on_the_card_match_the_cpu(cuda_device, tmp_path,
                                            monkeypatch, tier):
    """The same .ivf cache installed on the card and on the CPU: the same
    ids (up to f32 summation order among tied scores), scores within
    1e-5."""
    from clipx_torch.search import ivf as tivf

    dtype, quantized, residual = IVF_TIERS[tier]
    monkeypatch.setenv("CLIPX_PQ_RESIDUAL", residual)
    corpus, queries = _ivf_corpus()
    cache = str(tmp_path / "images.index.ivf")
    cpu = tivf.IVFIndex.from_vectors(corpus, quantized=quantized,
                                     dtype=dtype, cache_path=cache,
                                     device="cpu")
    gpu = tivf.IVFIndex.from_vectors(corpus, quantized=quantized,
                                     dtype=dtype, cache_path=cache,
                                     device=cuda_device)
    np.testing.assert_array_equal(gpu._row_ext, cpu._row_ext)
    for nprobe in (1, 17, 100):
        for k in (1, 50):
            Dg, Ig = gpu.search(queries, k, nprobe=nprobe)
            Dc, Ic = cpu.search(queries, k, nprobe=nprobe)
            _assert_same_ranking(Dg, Ig, Dc, Ic)
    np.testing.assert_allclose(gpu.vectors(), cpu.vectors(), atol=1e-6,
                               rtol=0)


def test_two_card_kmeans_builds_give_one_layout(cuda_device):
    """k-means on the card sums its clusters with one-hot f32 products (no
    float atomics): two builds give one layout digest, also on the training
    sample path."""
    from clipx_torch.search import ivf as tivf

    corpus, _ = _ivf_corpus(n=150_000, dim=128, clusters=300)
    digests = set()
    for _ in range(2):
        assign, _ = tivf.train_clusters(corpus, device=cuda_device)
        digests.add(tivf.layout_digest(tivf.cluster_layout(assign)))
    assert len(digests) == 1


# -- the HTTP service on the card ---------------------------------------------------
# tiny-test's head width is 32, which takes none of the packed kernels; the
# service runs here on _d64() (the same two layers, heads of 64), handed to
# make_server as its encoder, over a store and sidecar written from its own
# embeddings of a few seeded photos

SERVE_IMAGES = 8


def _serve_fixture(tmp_path, device, rows: int = 0):
    """(encoder, folder of the photos, argv prefix): the photos' embeddings
    in fn_db and images.index (ids 0..7), plus ``rows`` seeded unit rows
    after them (ids 8.., paths in idx_db only)."""
    from PIL import Image

    from clipx_torch.data.pipeline import decode_bytes_rgb
    from clipx_torch.search.engine import IndexWriter
    from clipx_torch.store.kv import open_env

    enc = Encoder(_d64(), tconvert.init_params(_d64(), seed=0),
                  device=device)
    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.default_rng(4)
    paths = []
    for i in range(SERVE_IMAGES):
        path = photos / f"p{i}.png"
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
                        ).save(path)
        paths.append(str(path))
    pixels = np.stack([decode_bytes_rgb(np.fromfile(p, np.uint8),
                                        enc.image_size) for p in paths])
    embs = enc.encode_images(pixels)
    extra = rng.standard_normal((rows, embs.shape[1]), dtype=np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    vectors = np.concatenate([embs, extra])
    env = open_env(str(tmp_path / "vectors.lmdb"))
    fn_db, idx_db = env.open_db(b"fn_db"), env.open_db(b"idx_db")
    with env.begin(db=fn_db, write=True) as txn:
        for path, e in zip(paths, embs):
            txn.put(path.encode(), e.tobytes())
    with env.begin(db=idx_db, write=True) as txn:
        for i in range(vectors.shape[0]):
            txn.put(f"{i}".encode(), (paths[i] if i < len(paths)
                                      else f"row{i}.jpg").encode())
    env.close()
    writer = IndexWriter(str(tmp_path / "images.index"), *vectors.shape)
    writer.write(vectors)
    writer.close()
    argv = ["--model", "tiny-test", "--port", "0",
            "--db", str(tmp_path / "vectors.lmdb"),
            "--index", str(tmp_path / "images.index")]
    return enc, photos, argv


class _Served:
    """make_server on the card with warm-up, serving on a thread."""

    def __init__(self, argv, enc, monkeypatch):
        from clipx_torch import serve as tserve
        from clipx_torch.ops import _build, _launch

        # a fresh process's view of the kernel libraries: nothing loaded,
        # so warm-up itself must load every one
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_launch, "_fns", {})
        monkeypatch.setenv("CLIPX_SERVE_WARMUP_K", "10")
        self.server = tserve.make_server(
            tserve.build_parser().parse_args(argv), encoder=enc)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        deadline = time.time() + 300
        while self.get("/healthz")[1].get("warm") is not True:
            assert time.time() < deadline, "the service never got warm"
            time.sleep(0.05)

    def request(self, method, path, payload=None):
        conn = HTTPConnection("127.0.0.1", self.port, timeout=120)
        conn.request(method, path,
                     body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = resp.status, json.loads(resp.read())
        conn.close()
        return out

    def get(self, path):
        return self.request("GET", path)

    def post(self, path, payload):
        return self.request("POST", path, payload)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.server._warmup_stop.set()
        self.server._warmup_thread.join(timeout=120)
        service = self.server.RequestHandlerClass.service
        service.close()
        service.env.close()


def _b64_file(path):
    return base64.b64encode(path.read_bytes()).decode()


def _no_builds(monkeypatch):
    """Record every library a request would build or load for the first
    time (warm-up should have left none)."""
    from clipx_torch.ops import _build

    late = []
    real_load, real_build_all = _build.load, _build.build_all

    def load(name):
        if name not in _build._libs:
            late.append(name)
        return real_load(name)

    def build_all(names=_build.SOURCES):
        late.append(("nvcc", tuple(names)))
        return real_build_all(names)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "build_all", build_all)
    return late


def test_served_images_launch_b2_at_bucket_1_and_b1_at_bucket_8(
        cuda_device, tmp_path, monkeypatch):
    """/search_image launches packed_sdpa once a layer and nothing else,
    and its embedding is enc.encode_images of the same decoded pixels,
    bitwise; /encode_image of 8 launches fused_attn_block once a layer
    and nothing else. Warm-up left every kernel library loaded: no request
    builds or loads one."""
    from clipx_torch.data.pipeline import decode_bytes_rgb
    from clipx_torch.ops import _build

    enc, photos, argv = _serve_fixture(tmp_path, cuda_device)
    layers = enc.cfg.vision.layers
    served = _Served(argv, enc, monkeypatch)
    try:
        assert set(_build._libs) == set(_build.SOURCES)
        late = _no_builds(monkeypatch)
        b64 = _b64_file(photos / "p3.png")
        tps.reset_launches()
        status, data = served.post("/search_image", {"image_b64": b64,
                                                     "k": 3})
        assert status == 200 and data["results"][0]["id"] == 3
        assert {n: c for n, c in tps.launch_counts().items() if c} == {
            "packed_sdpa": layers}
        tps.reset_launches()
        status, data = served.post("/encode_image", {"images_b64": [b64]})
        assert status == 200
        pixels = decode_bytes_rgb(np.fromfile(photos / "p3.png", np.uint8),
                                  enc.image_size)
        np.testing.assert_array_equal(
            np.asarray(data["embeddings"], np.float32),
            enc.encode_images(pixels[None]))
        tps.reset_launches()
        status, data = served.post("/encode_image", {"images_b64": [
            _b64_file(photos / f"p{i}.png") for i in range(SERVE_IMAGES)]})
        assert status == 200 and len(data["embeddings"]) == SERVE_IMAGES
        assert {n: c for n, c in tps.launch_counts().items() if c} == {
            "fused_attn_block": layers}
        status, _ = served.get("/search?q=a+photo+of+a+cat&k=3")
        assert status == 200
        assert late == []
    finally:
        served.close()


def test_concurrent_requests_count_every_launch(cuda_device, tmp_path,
                                                monkeypatch):
    """16 clients, 4 /search_image each, all at once: packed_sdpa's count
    is exactly 64 requests x one launch a layer (the counter's lock loses
    no increment)."""
    enc, photos, argv = _serve_fixture(tmp_path, cuda_device)
    served = _Served(argv, enc, monkeypatch)
    b64 = [_b64_file(photos / f"p{i}.png") for i in range(SERVE_IMAGES)]
    errors = []

    def client(c):
        try:
            for r in range(4):
                i = (c + r) % SERVE_IMAGES
                status, data = served.post("/search_image",
                                           {"image_b64": b64[i], "k": 1})
                assert status == 200 and data["results"][0]["id"] == i
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tps.reset_launches()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        counts = {n: c for n, c in tps.launch_counts().items() if c}
        assert counts == {"packed_sdpa": 64 * enc.cfg.vision.layers}
    finally:
        sys.setswitchinterval(interval)
        served.close()


def test_pq_service_launches_b11_once_a_search(cuda_device, tmp_path,
                                               monkeypatch):
    """--corpus-dtype pq: warm-up loads the PQ scan's library, and each
    /search_vector launches pq_scan_scores once (one scan of the whole
    corpus), with the ids of a direct search of the served index."""
    enc, _, argv = _serve_fixture(tmp_path, cuda_device, rows=6000)
    served = _Served(argv + ["--corpus-dtype", "pq"], enc, monkeypatch)
    try:
        late = _no_builds(monkeypatch)
        index = served.server.RequestHandlerClass.service.index
        assert index.pq_storage
        queries = np.asarray(index.vectors()[[2, 100, 5000]])
        for q in queries:
            tps.reset_launches()
            status, data = served.post("/search_vector",
                                       {"vector": q.tolist(), "k": 5})
            assert status == 200
            assert {n: c for n, c in tps.launch_counts().items() if c} == {
                "pq_scan_scores": 1}
            _, I = index.search(q[None], 5)
            assert [r["id"] for r in data["results"]] == I[0].tolist()
        assert late == []
    finally:
        served.close()


# -- device preprocessing, the ResNet towers, the two search knobs ----------

@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("canvas,size", [(256, 224), (37, 32), (512, 448),
                                         (24, 32)])
def test_canvas_resize_on_the_card_matches_the_cpu(cuda_device, canvas,
                                                   size, tf32):
    """device_resize_normalize in f32 on the card against the CPU within
    1e-4, also when the caller has turned TF32 on: the two contractions
    run with it off, and the caller's setting is back afterwards."""
    from clipx_torch.ops.preprocess import device_resize_normalize

    batch = torch.from_numpy(np.random.default_rng(canvas).integers(
        0, 256, (3, canvas, canvas, 3), dtype=np.uint8))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = device_resize_normalize(batch.to(cuda_device), size)
        assert torch.backends.cuda.matmul.allow_tf32 == tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = device_resize_normalize(batch, size)
    assert out.shape == ref.shape == (3, size, size, 3)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)


def test_canvas_path_on_the_card_matches_the_cpu(cuda_device):
    """The Encoder's canvas path (37 px canvases of tiny-test's 32 px
    input) on the card against the CPU, B1 at bucket 4 and B2 at 1."""
    params = tconvert.init_params(_d64(), seed=1)
    gpu = Encoder(_d64(), params, device=cuda_device, batch_buckets=(1, 4))
    cpu = Encoder(_d64(), params, device="cpu", batch_buckets=(1, 4))
    canvases = np.random.default_rng(2).integers(0, 256, (4, 73, 73, 3),
                                                 dtype=np.uint8)
    tps.reset_launches()
    out = gpu.encode_images(canvases)
    one = gpu.encode_images(canvases[:1])
    assert tps.launch_counts() == {**{n: 0 for n in tps.LAUNCHES},
                                   "fused_attn_block": 2, "packed_sdpa": 2}
    ref = cpu.encode_images(canvases)
    assert (np.sum(out * ref, axis=1) >= 0.999).all()
    assert float(one[0] @ ref[0]) >= 0.999
    with pytest.raises(ValueError, match="square canvas"):
        gpu.encode_images(np.zeros((2, 64, 73, 3), np.uint8))


@pytest.mark.parametrize("side", [32, 45])
def test_tiny_rn_encoder_on_the_card_matches_the_cpu(cuda_device, side):
    """tiny-rn-test in bf16 on the card (cuDNN convolutions on
    channels_last kernels) against f32 on the CPU, at the input size and
    on a canvas; the tower launches no kernel of the port's."""
    cfg = tcfg.get_config("tiny-rn-test")
    params = tconvert.init_params(cfg, seed=0)
    gpu = Encoder(cfg, params, device=cuda_device, batch_buckets=(1, 4))
    cpu = Encoder(cfg, params, device="cpu", batch_buckets=(1, 4))
    conv = gpu.params["visual"]["stage1"]["first"]["conv2"]
    assert conv.dtype == torch.bfloat16 and conv.permute(
        3, 2, 0, 1).is_contiguous(memory_format=torch.channels_last)
    images = np.random.default_rng(side).integers(0, 256, (3, side, side, 3),
                                                  dtype=np.uint8)
    tps.reset_launches()
    out = gpu.encode_images(images)
    one = gpu.encode_images(images[:1])
    assert not any(tps.LAUNCHES.values())
    ref = cpu.encode_images(images)
    assert (np.sum(out * ref, axis=1) >= 0.999).all()
    assert float(one[0] @ ref[0]) >= 0.999
    t = ["a photo of a cat", "two dogs"]
    assert (np.sum(gpu.encode_texts(t) * cpu.encode_texts(t), axis=1)
            >= 0.999).all()


def test_int8_scan_element_is_refused_on_the_card(cuda_device, monkeypatch):
    """CLIPX_INT8_SCAN=element raises on the card as on the CPU, before
    any scan; with it unset the same index searches."""
    corpus = np.random.default_rng(4).standard_normal(
        (20_500, 64)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    idx = teng.VectorIndex.from_vectors(corpus, True, cuda_device)
    monkeypatch.setenv("CLIPX_INT8_SCAN", "element")
    with pytest.raises(ValueError, match="CLIPX_INT8_SCAN=element"):
        idx.search(corpus[:3], 50)
    monkeypatch.delenv("CLIPX_INT8_SCAN")
    assert (idx.search(corpus[:3], 50)[1][:, 0] == [0, 1, 2]).all()


def test_pq_lut_bf16_on_the_card_gives_the_same_results(cuda_device,
                                                        monkeypatch):
    """CLIPX_PQ_LUT=bf16 is ignored on the card: the same scores and ids
    as without it, one B11 launch a search."""
    corpus = np.random.default_rng(5).standard_normal(
        (50_000, 64)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    idx = teng.VectorIndex.from_vectors(corpus, device=cuda_device,
                                        dtype="pq")
    queries = corpus[:5]
    want = idx.search(queries, 20)
    monkeypatch.setenv("CLIPX_PQ_LUT", "bf16")
    before = tps.LAUNCHES["pq_scan_scores"]
    got = idx.search(queries, 20)
    assert tps.LAUNCHES["pq_scan_scores"] == before + 1
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


# -- training and the tools (clipx_torch/train.py, clipx_torch/tools/) -------

# a card step against the CPU step, f32 on both with TF32 off: summation
# order only, as the CPU parity tests' tolerances (tests/test_torch_train.py)
# for the ViT tower. cuDNN's f32 convolution algorithms leave ~4e-3
# relative error on the ResNet tower's conv gradients against the CPU's
# (measured at RN50 width), and Adam's first steps move an element by ~lr *
# sign(g), so elements whose gradient sits at that noise move the other
# way: the RN tower's updates are held by their relative L2 error (5e-2)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LR = 1e-3
TRAIN_STEP_ATOL = 2e-3 * TRAIN_LR
TRAIN_RN_UPDATE_RL2 = 5e-2


def _train_steps(model, device, steps=3):
    from clipx_torch import train as ttrain
    from clipx_torch.text.tokenizer import ClipTokenizer

    cfg = tcfg.get_config(model)
    tree = tconvert.init_params(cfg, 0)
    state, tx = ttrain.create_train_state(
        cfg, tx=ttrain.make_optimizer(TRAIN_LR, 0.02, 1, steps),
        device=device, params=tree)
    step = ttrain.make_train_step(cfg, tx)
    rng = np.random.default_rng(1)
    size = cfg.vision.image_size
    ids = torch.from_numpy(ClipTokenizer()(
        ["a red square", "a green field", "blue sky", "city lights"],
        context_length=cfg.text.context_length))
    metrics = []
    for _ in range(steps):
        px = torch.from_numpy(rng.standard_normal(
            (4, size, size, 3)).astype(np.float32))
        state, m = step(state, px.to(device), ids.to(device))
        metrics.append({k: float(v) for k, v in m.items()})
    return (tree, tconvert._flatten(tconvert.to_jax_params(state.params)),
            metrics)


@pytest.mark.parametrize("model", ["tiny-test", "tiny-rn-test"])
@pytest.mark.parametrize("tf32", [False, True])
def test_train_steps_on_the_card_match_the_cpu(cuda_device, model, tf32):
    """Three train steps on the card against the same steps on the CPU:
    loss, accuracy and grad norm, and every parameter's update. With the
    caller's TF32 flags on, the step still runs in full f32 (cuBLAS and
    cuDNN: the ResNet convolutions) and leaves the flags as it found
    them."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        before = tps.launch_counts()
        tree, card, cm = _train_steps(model, cuda_device)
        assert tps.launch_counts() == before      # no kernel of the port
        assert torch.backends.cuda.matmul.allow_tf32 == tf32
        assert torch.backends.cudnn.allow_tf32 == tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    _, cpu, pm = _train_steps(model, "cpu")
    for a, b in zip(cm, pm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
        assert a["accuracy"] == b["accuracy"]
    init = tconvert._flatten(tree)
    if model == "tiny-rn-test":
        err = sum(float(((card[k] - cpu[k]).astype(np.float64) ** 2).sum())
                  for k in cpu)
        ref = sum(float(((cpu[k] - init[k]).astype(np.float64) ** 2).sum())
                  for k in cpu)
        assert ref > 0 and (err / ref) ** 0.5 <= TRAIN_RN_UPDATE_RL2
        return
    for key in cpu:
        np.testing.assert_allclose(card[key] - init[key], cpu[key] - init[key],
                                   rtol=0, atol=TRAIN_STEP_ATOL, err_msg=key)


def test_full_f32_turns_cudnn_tf32_off(cuda_device):
    """The TF32 guard covers cuDNN's flag (on by default in PyTorch) as
    well as cuBLAS's, and restores both."""
    from clipx_torch.runtime.device import full_f32

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with full_f32(cuda_device):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            x = torch.randn((2, 64, 17, 17), device=cuda_device)
            w = torch.randn((64, 64, 3, 3), device=cuda_device)
            out = torch.nn.functional.conv2d(x, w, padding=1)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    ref = torch.nn.functional.conv2d(x.double().cpu(), w.double().cpu(),
                                     padding=1)
    # full f32 (TF32 keeps 10 mantissa bits: errors near 1e-2 here)
    torch.testing.assert_close(out.cpu().double(), ref, atol=1e-3, rtol=0)


def test_kernel_refuses_an_input_that_requires_grad(cuda_device):
    """B7 on CUDA: an input that requires grad is refused by name (its
    output would carry no grad_fn); under torch.no_grad() it launches."""
    gen = torch.Generator().manual_seed(0)
    x = _bf(gen, cuda_device, 2, 50, 768)
    w1 = _bf(gen, cuda_device, 768, 3072, scale=0.02).requires_grad_(True)
    w2 = _bf(gen, cuda_device, 3072, 768, scale=0.02)
    b1 = torch.zeros(3072, device=cuda_device)
    b2 = torch.zeros(768, device=cuda_device)
    before = tps.LAUNCHES["fused_mlp"]
    with pytest.raises(RuntimeError, match="fused_mlp: an input requires"):
        tps.fused_mlp(x, w1, b1, w2, b2)
    with pytest.raises(RuntimeError, match="fused_attn_block"):
        tps._launch_attn_block(
            x, _bf(gen, cuda_device, 768, 2304).requires_grad_(True),
            torch.zeros(2304, device=cuda_device),
            _bf(gen, cuda_device, 768, 768),
            torch.zeros(768, device=cuda_device), 12)
    assert tps.LAUNCHES["fused_mlp"] == before
    with torch.no_grad():
        out = tps.fused_mlp(x, w1, b1, w2, b2)
    assert tps.LAUNCHES["fused_mlp"] == before + 1
    assert out.shape == x.shape and out.grad_fn is None


def test_load_timing_pq_launches_b11(cuda_device, tmp_path):
    """The port's load_timing over a pq deployment on the card: cold, then
    warm with --query (50 searches, B11 each), the same keys as on the
    CPU."""
    from clipx_torch.search.engine import IndexWriter
    from clipx_torch.tools import load_timing

    rows = np.random.default_rng(4).standard_normal((20_000, 64)).astype(
        np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index = str(tmp_path / "images.index")
    writer = IndexWriter(index, *rows.shape)
    writer.write(rows)
    writer.close()
    jpath = str(tmp_path / "lt.json")
    assert load_timing.main(["--index", index, "--corpus-dtype", "pq",
                             "--cold", "--json", jpath]) == 0
    before = tps.LAUNCHES["pq_scan_scores"]
    assert load_timing.main(["--index", index, "--corpus-dtype", "pq",
                             "--query", "--json", jpath]) == 0
    out = json.load(open(jpath))
    assert out["platform"] == "cuda" and out["mode"] == "warm"
    assert out["ntotal"] == 20_000 and out["query_p50_ms"] > 0
    assert tps.LAUNCHES["pq_scan_scores"] - before >= 51


# -- corpus-sharded search and the dp encode (clipx_torch/parallel) --------

def _card_mesh(axis, n, device):
    from clipx_torch.parallel.mesh import make_mesh

    return make_mesh({axis: n}, [device] * n)


@pytest.mark.parametrize("tier", ["f32", "pq"])
def test_sharded_flat_on_four_card_shards_matches_one_device(cuda_device,
                                                             tier):
    """ShardedVectorIndex on 4 shards of one card against the single-device
    index of the same tier on the card: f32 ids identical and scores
    within 1e-5; pq the same ids up to IVF_TIE; B11 launched once a shard
    a search, never its plain version."""
    from clipx_torch.parallel.mips import ShardedVectorIndex

    corpus, queries = _ivf_corpus()
    single = teng.VectorIndex.from_vectors(corpus, device=cuda_device,
                                           dtype=tier)
    sharded = ShardedVectorIndex(corpus, _card_mesh("shard", 4, cuda_device),
                                 dtype=tier)
    assert all(c.device == cuda_device for c in (
        sharded._codes if tier == "pq" else sharded._corpus))
    D1, I1 = single.search(queries, 50)
    tps.reset_launches()
    D, I = sharded.search(queries, 50)
    launched = {k: n for k, n in tps.LAUNCHES.items() if n}
    assert launched == ({"pq_scan_scores": 4} if tier == "pq" else {})
    if tier == "f32":
        np.testing.assert_array_equal(I, I1)
        np.testing.assert_allclose(D, D1, atol=1e-5, rtol=0)
    else:
        _assert_same_ranking(D, I, D1, I1)


def test_sharded_ivf_pq_on_four_card_shards(cuda_device, tmp_path,
                                            monkeypatch):
    """ShardedIVFIndex with residual pq on 4 shards of one card: at nprobe
    100 the single-device ids (up to IVF_TIE); B11 once per (shard, query,
    probed chunk)."""
    from clipx_torch.search import ivf as tivf

    monkeypatch.setenv("CLIPX_PQ_RESIDUAL", "on")
    corpus, queries = _ivf_corpus()
    cache = str(tmp_path / "images.index.ivf")
    single = tivf.IVFIndex.from_vectors(corpus, dtype="pq", cache_path=cache,
                                        device=cuda_device)
    sharded = tivf.ShardedIVFIndex.from_vectors(
        corpus, dtype="pq", cache_path=cache,
        mesh=_card_mesh("shard", 4, cuda_device))
    D1, I1 = single.search(queries, 50, nprobe=100)
    tps.reset_launches()
    D, I = sharded.search(queries, 50, nprobe=100)
    s_loc = sharded._segs() // 4
    chunks = -(-s_loc // tivf._pq_chunk_segs(s_loc, 64))
    assert {k: n for k, n in tps.LAUNCHES.items() if n} == {
        "pq_scan_scores": 4 * len(queries) * chunks}
    _assert_same_ranking(D, I, D1, I1)


def test_dp_encode_on_two_card_positions(cuda_device):
    """The ViT dp encode over a mesh of cuda:0 twice, at D = 64 (the B1
    route): each bucket splits into two even shares, B1 launches once a
    layer a share, and the embeddings equal the single-device encode on the
    card within 2e-3 (bf16; chip_smoke.py's ViT-B/32 leg came out
    bitwise)."""
    cfg = _d64()
    params = tconvert.init_params(cfg, 0)
    single = Encoder(cfg, params, device=cuda_device)
    dp = Encoder(cfg, params, mesh=_card_mesh("dp", 2, cuda_device))
    assert dp.buckets == (4, 8, 32, 128, 256)
    images = np.random.default_rng(3).integers(0, 256, (20, 64, 64, 3),
                                               dtype=np.uint8)
    ref = single.encode_images(images)
    tps.reset_launches()
    out = dp.encode_images(images)
    assert tps.LAUNCHES["fused_attn_block"] == 2 * cfg.vision.layers
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


# -- tensor parallelism (clipx_torch/parallel/tensor.py) ----------------------

def _tp_mesh(device):
    from clipx_torch.parallel.mesh import make_mesh

    return make_mesh({"dp": 2, "tp": 2}, [device] * 4)


def test_tp_encode_on_four_card_positions(cuda_device):
    """The dp 2 x tp 2 Encoder over cuda:0 listed 4 times (bf16, plain
    attention: no kernel of the port) against the single-device encode on
    the card and the CPU's f32 encode of the same weights: cosine >= 0.99
    (chip_smoke.py's COS_MIN), texts too."""
    cfg = _d64()
    params = tconvert.init_params(cfg, 0)
    images = np.random.default_rng(4).integers(0, 256, (12, 64, 64, 3),
                                               dtype=np.uint8)
    texts = ["a red square", "blue sky over a city"]
    tp = Encoder(cfg, params, mesh=_tp_mesh(cuda_device), tp="tp",
                 attn_impl="pallas")
    assert tp.attn_impl == "plain"
    before = tps.launch_counts()
    out, txt = tp.encode_images(images), tp.encode_texts(texts)
    assert tps.launch_counts() == before
    for enc in (Encoder(cfg, params, device=cuda_device),
                Encoder(cfg, params, device="cpu")):
        for a, b in ((out, enc.encode_images(images)),
                     (txt, enc.encode_texts(texts))):
            assert a.shape == b.shape
            assert float((a * b).sum(axis=1).min()) >= 0.99


def test_dp_tp_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Three dp 2 x tp 2 steps of tiny-test over cuda:0 listed 4 times
    against the same steps over 4 CPU positions: the losses within
    TRAIN_LOSS_RTOL, every parameter's update within TRAIN_STEP_ATOL, no
    kernel of the port launched, and the replicated leaves of the two tp
    columns bitwise equal on the card."""
    from clipx_torch import train as ttrain
    from clipx_torch.parallel.mesh import make_mesh
    from clipx_torch.text.tokenizer import ClipTokenizer

    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    rng = np.random.default_rng(1)
    ids = ClipTokenizer()([f"caption {i}" for i in range(8)],
                          context_length=cfg.text.context_length)
    batches = [(rng.standard_normal((8, 32, 32, 3)).astype(np.float32), ids)
               for _ in range(3)]
    runs = []
    for mesh in (_tp_mesh(cuda_device),
                 make_mesh({"dp": 2, "tp": 2}, [torch.device("cpu")] * 4)):
        tx = ttrain.make_optimizer(TRAIN_LR, 0.02, 1, 3)
        state, _ = ttrain.create_train_state(cfg, tx=tx, device="cpu",
                                             params=tree)
        step, shard_state, split = ttrain.make_sharded_train_step(
            cfg, tx, mesh)
        state = shard_state(state)
        before = tps.launch_counts()
        losses = []
        for px, i in batches:
            state, m = step(state, *split(px, i))
            losses.append(float(m["loss"]))
        assert tps.launch_counts() == before
        runs.append((state, losses))
    (card, cl), (cpu, pl) = runs
    np.testing.assert_allclose(cl, pl, rtol=TRAIN_LOSS_RTOL)
    (_, t0), (_, t1) = card.params.placements()
    flags = ttrain._sharded_flags(t0, card.params.specs, card.params.tp)
    for a, b, sharded in zip(ttrain.tree_leaves(t0), ttrain.tree_leaves(t1),
                             flags):
        if not sharded:
            assert torch.equal(a, b)
    init = tconvert._flatten(tree)
    got = tconvert._flatten(card.params.gather())
    want = tconvert._flatten(cpu.params.gather())
    for key in init:
        np.testing.assert_allclose(got[key] - init[key], want[key] - init[key],
                                   rtol=0, atol=TRAIN_STEP_ATOL, err_msg=key)


def test_split_head_tp_encode_on_the_card(cuda_device):
    """tiny-test's 2 heads over dp 1 x tp 8 of cuda:0 listed 8 times (a
    quarter of a head a position; bf16, plain attention) against the
    single-device encode on the card and the CPU's f32 encode: cosine >=
    0.99, texts too, no kernel of the port launched."""
    from clipx_torch.parallel.mesh import make_mesh

    cfg = tcfg.get_config("tiny-test")
    params = tconvert.init_params(cfg, 0)
    images = np.random.default_rng(5).integers(0, 256, (12, 32, 32, 3),
                                               dtype=np.uint8)
    texts = ["a red square", "blue sky over a city"]
    tp = Encoder(cfg, params, mesh=make_mesh({"dp": 1, "tp": 8},
                                             [cuda_device] * 8), tp="tp")
    before = tps.launch_counts()
    out, txt = tp.encode_images(images), tp.encode_texts(texts)
    assert tps.launch_counts() == before
    for enc in (Encoder(cfg, params, device=cuda_device),
                Encoder(cfg, params, device="cpu")):
        for a, b in ((out, enc.encode_images(images)),
                     (txt, enc.encode_texts(texts))):
            assert a.shape == b.shape
            assert float((a * b).sum(axis=1).min()) >= 0.99


def test_split_head_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Three dp 2 x tp 4 steps of tiny-test (half a head a position) over
    cuda:0 listed 8 times against the same steps over 8 CPU positions: the
    losses within TRAIN_LOSS_RTOL, every parameter's update within
    TRAIN_STEP_ATOL, no kernel of the port launched, the replicated leaves
    of the four tp columns bitwise equal on the card."""
    from clipx_torch import train as ttrain
    from clipx_torch.parallel.mesh import make_mesh
    from clipx_torch.text.tokenizer import ClipTokenizer

    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    rng = np.random.default_rng(2)
    ids = ClipTokenizer()([f"caption {i}" for i in range(8)],
                          context_length=cfg.text.context_length)
    batches = [(rng.standard_normal((8, 32, 32, 3)).astype(np.float32), ids)
               for _ in range(3)]
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        mesh = make_mesh({"dp": 2, "tp": 4}, [dev] * 8)
        tx = ttrain.make_optimizer(TRAIN_LR, 0.02, 1, 3)
        state, _ = ttrain.create_train_state(cfg, tx=tx, device="cpu",
                                             params=tree)
        step, shard_state, split = ttrain.make_sharded_train_step(
            cfg, tx, mesh)
        state = shard_state(state)
        before = tps.launch_counts()
        losses = []
        for px, i in batches:
            state, m = step(state, *split(px, i))
            losses.append(float(m["loss"]))
        assert tps.launch_counts() == before
        runs.append((state, losses))
    (card, cl), (cpu, pl) = runs
    np.testing.assert_allclose(cl, pl, rtol=TRAIN_LOSS_RTOL)
    trees = [t for _, t in card.params.placements()]
    assert len(trees) == 4
    flags = ttrain._sharded_flags(trees[0], card.params.specs,
                                  card.params.tp)
    for other in trees[1:]:
        for a, b, sharded in zip(ttrain.tree_leaves(trees[0]),
                                 ttrain.tree_leaves(other), flags):
            if not sharded:
                assert torch.equal(a, b)
    init = tconvert._flatten(tree)
    got = tconvert._flatten(card.params.gather())
    want = tconvert._flatten(cpu.params.gather())
    for key in init:
        np.testing.assert_allclose(got[key] - init[key], want[key] - init[key],
                                   rtol=0, atol=TRAIN_STEP_ATOL, err_msg=key)
