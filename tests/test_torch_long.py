"""The port's long-sequence and packed-projection attention kernels: plain
versions against clipx's Pallas kernels, on the CPU.

``fused_sdpa_long`` (B8), ``fused_sdpa_long_qkv`` (B9), ``flash_attention``
(B10) and ``packed_sdpa_qkv`` (B4) run their plain PyTorch versions for CPU
tensors; here those are held against clipx's kernels in Pallas interpret
mode on the same seeded numpy inputs: in f32 within 2e-5 (f32 summation
order only; the bound clipx's own kernel tests use) and in bf16 within 2
bf16 ulps (the same rounding points leave only summation order). B4 must
equal ``packed_sdpa`` bitwise, as clipx's B4 equals its B2. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipx.ops import flash_attention as jfa
from clipx.ops import packed_sdpa as jps
from clipx_torch.ops import attention as tattn
from clipx_torch.ops import flash_attention as tfa
from clipx_torch.ops import packed_sdpa as tps

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

TOL = 2e-5


def _qkv(rng, shape, scale=0.5):
    return [rng.randn(*shape).astype(np.float32) * scale for _ in range(3)]


def _bf16_ulps(out: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|out - ref| in bf16 ulps (8 significant bits) of the larger value."""
    mag = np.maximum(np.abs(out), np.abs(ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(out - ref) / ulp


@pytest.mark.parametrize("s,causal", [(130, False), (77, True), (197, False)])
def test_fused_sdpa_long_plain_matches_pallas(s, causal):
    rng = np.random.RandomState(s)
    heads = 4
    q, k, v = _qkv(rng, (2, s, heads * 64))
    ref = np.asarray(jps.fused_sdpa_long(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
        causal=causal, interpret=True))
    out = tps.fused_sdpa_long(*map(torch.from_numpy, (q, k, v)), heads=heads,
                              causal=causal)
    assert out.shape == (2, s, heads * 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,causal", [(130, False), (77, True)])
def test_fused_sdpa_long_qkv_plain_matches_pallas(s, causal):
    rng = np.random.RandomState(s + 1)
    heads, w = 4, 4 * 64
    qkv = rng.randn(2, s, 3 * w).astype(np.float32) * 0.3
    wo = rng.randn(w, w).astype(np.float32) * 0.03
    bo = rng.randn(w).astype(np.float32) * 0.01
    ref = np.asarray(jps.fused_sdpa_long_qkv(
        jnp.asarray(qkv), jnp.asarray(wo), jnp.asarray(bo), heads=heads,
        causal=causal, interpret=True))
    out = tps.fused_sdpa_long_qkv(*map(torch.from_numpy, (qkv, wo, bo)),
                                  heads=heads, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,causal", [((2, 2, 130, 64), False),
                                          ((1, 2, 77, 32), True),
                                          ((1, 3, 50, 64), False)])
def test_flash_attention_plain_matches_pallas(shape, causal):
    rng = np.random.RandomState(shape[2] + shape[3])
    q, k, v = _qkv(rng, shape)
    ref = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_packed_sdpa_qkv_plain_matches_pallas_and_packed_sdpa():
    rng = np.random.RandomState(13)
    b, s, heads = 2, 50, 4
    w = heads * 64
    q, k, v = _qkv(rng, (b, s, w))
    qkv = np.concatenate([q, k, v], axis=2)
    ref = np.asarray(jps.packed_sdpa_qkv(jnp.asarray(qkv), heads=heads,
                                         interpret=True))
    out = tps.packed_sdpa_qkv(torch.from_numpy(qkv), heads=heads)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    # clipx's B4 equals its B2 bitwise; the port's plain versions do too
    assert torch.equal(out, tps.packed_sdpa(*map(torch.from_numpy, (q, k, v)),
                                            heads=heads))


@pytest.mark.parametrize("name", ["fused_sdpa_long", "fused_sdpa_long_qkv",
                                  "flash_attention", "packed_sdpa_qkv"])
def test_plain_versions_match_pallas_in_bf16(name):
    """bf16 inputs: the probabilities, head outputs and result round where
    the Pallas kernels round them; only f32 summation order differs, which
    may flip the last bit of a rounding. Tolerance: 2 bf16 ulps; for B9
    also what one flipped head-output rounding carries through wo (one
    bf16 ulp of the largest v times the largest |wo|), which can exceed 2
    ulps of an output near zero."""
    rng = np.random.RandomState(21)
    heads, s = 2, 77 if name != "packed_sdpa_qkv" else 50
    w = heads * 64
    carried = 0.0

    def j16(a):
        return jnp.asarray(a, jnp.bfloat16)

    def t16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    if name == "flash_attention":
        q, k, v = _qkv(rng, (2, heads, s, 64))
        ref = jfa.flash_attention(j16(q), j16(k), j16(v), causal=True,
                                  interpret=True)
        out = tfa.flash_attention(t16(q), t16(k), t16(v), causal=True)
    elif name == "fused_sdpa_long":
        q, k, v = _qkv(rng, (2, s, w))
        ref = jps.fused_sdpa_long(j16(q), j16(k), j16(v), heads=heads,
                                  causal=True, interpret=True)
        out = tps.fused_sdpa_long(t16(q), t16(k), t16(v), heads=heads,
                                  causal=True)
    elif name == "fused_sdpa_long_qkv":
        qkv = rng.randn(2, s, 3 * w).astype(np.float32) * 0.3
        wo = rng.randn(w, w).astype(np.float32) * 0.03
        bo = rng.randn(w).astype(np.float32) * 0.01
        ref = jps.fused_sdpa_long_qkv(j16(qkv), j16(wo), jnp.asarray(bo),
                                      heads=heads, interpret=True)
        out = tps.fused_sdpa_long_qkv(t16(qkv), t16(wo), torch.from_numpy(bo),
                                      heads=heads)
        vmax = float(np.abs(qkv[..., 2 * w:]).max())
        carried = 2.0 ** (np.floor(np.log2(vmax)) - 7) * np.abs(wo).max()
    else:
        qkv = rng.randn(2, s, 3 * w).astype(np.float32) * 0.5
        ref = jps.packed_sdpa_qkv(j16(qkv), heads=heads, interpret=True)
        out = tps.packed_sdpa_qkv(t16(qkv), heads=heads)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    out, ref = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    ulps = _bf16_ulps(out, ref)
    bad = (ulps > 2) & (np.abs(out - ref) > carried)
    assert not bad.any(), f"max {ulps.max()} bf16 ulps"


def test_causal_plain_masks_later_keys():
    """Causal: row i attends to keys 0..i only, so changing the last key
    and value leaves every earlier row unchanged."""
    rng = np.random.RandomState(5)
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 70, 128)))
    out = tps.fused_sdpa_long(q, k, v, heads=2, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 3.0
    v2[:, -1] -= 2.0
    out2 = tps.fused_sdpa_long(q, k2, v2, heads=2, causal=True)
    assert torch.equal(out[:, :-1], out2[:, :-1])
    assert not torch.equal(out[:, -1], out2[:, -1])


@pytest.mark.parametrize("device,s,want", [("cpu", 300, "xla"),
                                           ("cuda", 300, "pallas"),
                                           ("cuda", 256, "pallas"),
                                           ("cuda", 255, "xla"),
                                           ("cuda", 77, "xla")])
def test_multihead_attention_auto(monkeypatch, device, s, want):
    """impl="auto" takes the kernel for CUDA tensors from S = 256 (clipx's
    _PALLAS_MIN_SEQ), plain attention otherwise; "pallas" always takes
    flash_attention (its plain version for CPU tensors)."""
    from clipx_torch.ops import flash_attention as fa_mod

    assert tattn.auto_impl(torch.device(device), s) == want
    calls = []
    monkeypatch.setattr(fa_mod, "flash_attention",
                        lambda *a, **k: calls.append("pallas") or a[0])
    monkeypatch.setattr(tattn, "xla_attention",
                        lambda *a, **k: calls.append("xla") or a[0])
    x = torch.zeros((1, 2, s, 64))
    tattn.multihead_attention(x, x, x)
    tattn.multihead_attention(x, x, x, impl="pallas")
    assert calls == ["xla", "pallas"]


def test_multihead_attention_pallas_matches_xla_on_cpu():
    rng = np.random.RandomState(8)
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 2, 90, 32)))
    for causal in (False, True):
        np.testing.assert_allclose(
            tattn.multihead_attention(q, k, v, causal=causal,
                                      impl="pallas").numpy(),
            tattn.multihead_attention(q, k, v, causal=causal,
                                      impl="xla").numpy(),
            rtol=TOL, atol=TOL)
