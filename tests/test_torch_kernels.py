"""The port's attention kernels: plain versions against clipx's Pallas
kernels, wrapper shape rules, and the no-fallback rule.

On the CPU each wrapper in ``clipx_torch.ops.packed_sdpa`` runs its plain
PyTorch version; here those are held against clipx's kernels run in Pallas
interpret mode (as tests/test_flash_attention.py runs them), on the same
seeded numpy inputs, in f32 (tolerance 2e-5: f32 summation order only; the
same bound clipx's own kernel tests use) and in bf16, where the rounding
points show (tolerance 2 bf16 ulps). The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py
and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clipx.ops import packed_sdpa as jps
from clipx_torch.ops import packed_sdpa as tps

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

TOL = 2e-5


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _attn_inputs(rng, b, s, w):
    x = rng.randn(b, s, w).astype(np.float32) * 0.5
    wqkv = rng.randn(w, 3 * w).astype(np.float32) * 0.03
    bqkv = rng.randn(3 * w).astype(np.float32) * 0.01
    wo = rng.randn(w, w).astype(np.float32) * 0.03
    bo = rng.randn(w).astype(np.float32) * 0.01
    return x, wqkv, bqkv, wo, bo


@pytest.mark.parametrize("s,w,rows", [(17, 128, 2), (50, 128, 4),
                                      (17, 768, 4), (50, 768, 2)])
def test_fused_attn_block_plain_matches_pallas(s, w, rows):
    rng = np.random.RandomState(s + w + rows)
    args = _attn_inputs(rng, 4, s, w)
    heads = w // 64
    ref = np.asarray(jps.fused_attn_block(*(jnp.asarray(a) for a in args),
                                          heads=heads, rows=rows,
                                          interpret=True))
    out = tps.fused_attn_block(*_t(*args), heads=heads).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,w", [(17, 128), (50, 128), (17, 768), (50, 768)])
def test_packed_sdpa_plain_matches_pallas(s, w):
    rng = np.random.RandomState(s * w)
    heads = w // 64
    q, k, v = (rng.randn(3, s, w).astype(np.float32) for _ in range(3))
    ref = np.asarray(jps.packed_sdpa(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), heads=heads,
                                     interpret=True))
    out = tps.packed_sdpa(*_t(q, k, v), heads=heads).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,w,heads", [(17, 128, 2), (50, 192, 3),
                                       (17, 768, 12), (50, 768, 12)])
def test_packed_sdpa_rows_plain_matches_pallas(s, w, heads):
    """Any head count, even batch (odd heads included, as clipx's)."""
    rng = np.random.RandomState(s * w + heads)
    q, k, v = (rng.randn(4, s, w).astype(np.float32) for _ in range(3))
    ref = np.asarray(jps.packed_sdpa_rows(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), heads=heads,
                                          interpret=True))
    out = tps.packed_sdpa_rows(*_t(q, k, v), heads=heads).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_plain_versions_round_like_the_kernels_in_bf16():
    """bf16 inputs: the plain version rounds qkv, the probabilities and the
    head outputs to bf16 and returns bf16 (the Pallas kernel's rounding
    points); f32 accumulation keeps it within bf16 resolution of f32."""
    rng = np.random.RandomState(3)
    args = _attn_inputs(rng, 2, 50, 128)
    out16 = tps.fused_attn_block(*(torch.from_numpy(a).to(torch.bfloat16)
                                   if a.ndim >= 2 else torch.from_numpy(a)
                                   for a in args), heads=2)
    assert out16.dtype == torch.bfloat16
    out32 = tps.fused_attn_block(*_t(*args), heads=2)
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               rtol=3e-2, atol=3e-2)


def _bf16_ulps(out: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|out - ref| in bf16 ulps (8 significant bits) of the larger value."""
    mag = np.maximum(np.abs(out), np.abs(ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(out - ref) / ulp


@pytest.mark.parametrize("name", ["fused_attn_block", "packed_sdpa",
                                  "packed_sdpa_rows"])
def test_plain_versions_match_pallas_in_bf16(name):
    """bf16 inputs through clipx's kernels (interpret mode) and the plain
    versions: the same rounding points (qkv, probabilities, head outputs,
    result) leave only f32 summation order, which may flip the last bit
    of a rounding. Tolerance: 2 bf16 ulps of each output element."""
    rng = np.random.RandomState(11)
    b, s, w, heads = 2, 17, 128, 2

    def j16(a):
        return jnp.asarray(a, jnp.bfloat16)

    def t16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    if name == "fused_attn_block":
        x, wqkv, bqkv, wo, bo = _attn_inputs(rng, b, s, w)
        ref = jps.fused_attn_block(j16(x), j16(wqkv), jnp.asarray(bqkv),
                                   j16(wo), jnp.asarray(bo), heads=heads,
                                   rows=2, interpret=True)
        out = tps.fused_attn_block(t16(x), t16(wqkv), torch.from_numpy(bqkv),
                                   t16(wo), torch.from_numpy(bo),
                                   heads=heads)
    else:
        q, k, v = (rng.randn(b, s, w).astype(np.float32) for _ in range(3))
        ref = getattr(jps, name)(j16(q), j16(k), j16(v), heads=heads,
                                 interpret=True)
        out = getattr(tps, name)(t16(q), t16(k), t16(v), heads=heads)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    ulps = _bf16_ulps(out.float().numpy(),
                      np.asarray(ref.astype(jnp.float32)))
    assert ulps.max() <= 2, f"max {ulps.max()} bf16 ulps"


def test_wrappers_reject_bad_shapes():
    x = torch.zeros((2, 50, 3 * 64))
    with pytest.raises(ValueError):
        tps.packed_sdpa(x, x, x, heads=3)          # odd heads
    y = torch.zeros((3, 50, 2 * 64))
    with pytest.raises(ValueError):
        tps.packed_sdpa_rows(y, y, y, heads=2)     # odd batch
    z = torch.zeros((2, 100, 2 * 64))
    with pytest.raises(ValueError):
        tps.packed_sdpa(z, z, z, heads=2)          # S > 64
    w = 128
    wqkv, wo = torch.zeros((w, 3 * w)), torch.zeros((w, w))
    bqkv, bo = torch.zeros(3 * w), torch.zeros(w)
    with pytest.raises(ValueError):                # D = 32
        tps.fused_attn_block(torch.zeros((2, 17, w)), wqkv, bqkv, wo, bo,
                             heads=4)
    with pytest.raises(ValueError):                # weights of another width
        tps.fused_attn_block(torch.zeros((2, 17, w)), wo, bo, wo, bo,
                             heads=2)


@pytest.mark.parametrize("name", ["fused_attn_block", "packed_sdpa",
                                  "packed_sdpa_rows"])
def test_non_cpu_tensors_never_reach_the_plain_version(name, monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises when it cannot launch (here: no CUDA device) — the plain
    version is never called and nothing is counted as launched."""
    def plain_called(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(tps, "fused_attn_block_plain", plain_called)
    monkeypatch.setattr(tps, "sdpa_plain", plain_called)
    before = dict(tps.LAUNCHES)
    w = 128
    x = torch.empty((2, 17, w), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        if name == "fused_attn_block":
            tps.fused_attn_block(
                x, torch.empty((w, 3 * w), device="meta"),
                torch.empty(3 * w, device="meta"),
                torch.empty((w, w), device="meta"),
                torch.empty(w, device="meta"), heads=2)
        else:
            getattr(tps, name)(x, x, x, heads=2)
    assert tps.LAUNCHES == before


def test_cuda_kernel_path_raises_without_a_gpu(monkeypatch):
    """The launch path itself (as a CUDA tensor would take it) raises
    rather than falling back when the library cannot be built or loaded."""
    from clipx_torch.ops import _build

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(tps, "_fns", {})
    monkeypatch.setattr(tps, "_kernel_device", lambda name, t: t.device)
    monkeypatch.setattr(tps, "_check_cuda", lambda *a, **k: None)
    q = torch.zeros((2, 17, 128))
    with pytest.raises(RuntimeError, match="nvcc"):
        tps._launch_sdpa("packed_sdpa", q, q, q, 2)


def test_launch_counters_reset():
    tps.LAUNCHES["packed_sdpa"] += 3
    tps.reset_launches()
    assert set(tps.LAUNCHES.values()) == {0}
