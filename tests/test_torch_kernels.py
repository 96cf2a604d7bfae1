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
                                  "packed_sdpa_rows", "fused_attn_sublayer",
                                  "fused_mlp"])
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
    elif name == "fused_attn_sublayer":
        x, wqkv, bqkv, wo, bo = _attn_inputs(rng, b, s, w)
        ln = (rng.randn(w).astype(np.float32) * 0.1 + 1.0,
              rng.randn(w).astype(np.float32) * 0.05)
        ref = jps.fused_attn_sublayer(
            j16(x), *(jnp.asarray(a) for a in ln), j16(wqkv),
            jnp.asarray(bqkv), j16(wo), jnp.asarray(bo), heads=heads,
            interpret=True)
        out = tps.fused_attn_sublayer(
            t16(x), *(torch.from_numpy(a) for a in ln), t16(wqkv),
            torch.from_numpy(bqkv), t16(wo), torch.from_numpy(bo),
            heads=heads)
    elif name == "fused_mlp":
        x = rng.randn(b, s, w).astype(np.float32)
        w1, w2 = (rng.randn(*shape).astype(np.float32) * 0.05
                  for shape in ((w, 4 * w), (4 * w, w)))
        b1, b2 = (rng.randn(n).astype(np.float32) * 0.01
                  for n in (4 * w, w))
        ref = jps.fused_mlp(j16(x), j16(w1), jnp.asarray(b1), j16(w2),
                            jnp.asarray(b2), interpret=True)
        out = tps.fused_mlp(t16(x), t16(w1), torch.from_numpy(b1), t16(w2),
                            torch.from_numpy(b2))
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
    qkv = torch.zeros((2, 50, 3 * w))
    with pytest.raises(ValueError):                # odd batch
        tps.packed_sdpa_qkv(torch.zeros((3, 50, 3 * w)), heads=2)
    with pytest.raises(ValueError):                # S > 64
        tps.packed_sdpa_qkv(torch.zeros((2, 65, 3 * w)), heads=2)
    with pytest.raises(ValueError):                # not a packed 3W
        tps.packed_sdpa_qkv(torch.zeros((2, 50, 3 * w + 1)), heads=2)
    with pytest.raises(ValueError):                # q, k, v shapes differ
        tps.fused_sdpa_long(z, z, torch.zeros((2, 101, 2 * 64)), heads=2)
    with pytest.raises(ValueError):                # width not heads * D
        tps.fused_sdpa_long(z, z, z, heads=3)
    with pytest.raises(ValueError):                # weights of another width
        tps.fused_sdpa_long_qkv(qkv, wqkv, bo, heads=2)
    with pytest.raises(ValueError):                # qkv not (B, S, 3W)
        tps.fused_sdpa_long_qkv(z, wo, bo, heads=2)
    from clipx_torch.ops import flash_attention as tfa
    with pytest.raises(ValueError):                # not (B, H, S, D)
        tfa.flash_attention(z, z, z)
    with pytest.raises(ValueError):                # q, k, v shapes differ
        tfa.flash_attention(torch.zeros((1, 2, 9, 64)),
                            torch.zeros((1, 2, 8, 64)),
                            torch.zeros((1, 2, 9, 64)))
    meta = torch.empty((2, 100, 3 * 64), device="meta")
    with pytest.raises(ValueError, match="head dims"):   # D = 48 on a device
        tps.fused_sdpa_long(meta, meta, meta, heads=4)
    x, ln = torch.zeros((2, 17, w)), torch.zeros(w)
    with pytest.raises(ValueError, match="even B"):       # odd batch
        tps.fused_attn_sublayer(torch.zeros((3, 17, w)), ln, ln, wqkv, bqkv,
                                wo, bo, heads=2)
    with pytest.raises(ValueError):                       # S > 64
        tps.fused_attn_sublayer(torch.zeros((2, 65, w)), ln, ln, wqkv, bqkv,
                                wo, bo, heads=2)
    with pytest.raises(ValueError):                       # LN of another width
        tps.fused_attn_sublayer(x, torch.zeros(64), ln, wqkv, bqkv, wo, bo,
                                heads=2)
    w1, w2, b1 = torch.zeros((w, 4 * w)), torch.zeros((4 * w, w)), torch.zeros(
        4 * w)
    with pytest.raises(ValueError, match="shapes"):       # x of another width
        tps.fused_mlp(torch.zeros((2, 17, 64)), w1, b1, w2, bo)
    with pytest.raises(ValueError, match="shapes"):       # w2 not (H, W)
        tps.fused_mlp(x, w1, b1, w1, bo)
    q1, q2 = w1.to(torch.int8), w2.to(torch.int8)
    with pytest.raises(ValueError, match="shapes"):       # biases swapped
        tps.fused_mlp_w8a8(x, q1, b1, bo, q2, bo, b1)
    m = torch.empty((2, 17, 96), device="meta")
    with pytest.raises(ValueError, match="W % 64"):       # on a device
        tps.fused_mlp(m, torch.empty((96, 384), device="meta"),
                      torch.empty(384, device="meta"),
                      torch.empty((384, 96), device="meta"),
                      torch.empty(96, device="meta"))


@pytest.mark.parametrize("name", ["fused_attn_block", "packed_sdpa",
                                  "packed_sdpa_rows", "packed_sdpa_qkv",
                                  "fused_sdpa_long", "fused_sdpa_long_qkv",
                                  "flash_attention", "fused_attn_sublayer",
                                  "fused_mlp", "fused_mlp_w8a8"])
def test_non_cpu_tensors_never_reach_the_plain_version(name, monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path, which
    raises when it cannot launch (here: no CUDA device) — the plain
    version is never called and nothing is counted as launched."""
    from clipx_torch.ops import flash_attention as tfa

    def plain_called(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    for plain in ("fused_attn_block_plain", "sdpa_plain", "attend_plain",
                  "packed_sdpa_qkv_plain", "fused_sdpa_long_plain",
                  "fused_sdpa_long_qkv_plain", "fused_attn_sublayer_plain",
                  "fused_mlp_plain", "fused_mlp_w8a8_plain"):
        monkeypatch.setattr(tps, plain, plain_called)
    monkeypatch.setattr(tfa, "flash_attention_plain", plain_called)
    before = dict(tps.LAUNCHES)
    w = 128

    def meta(*shape):
        return torch.empty(shape, device="meta")

    x = meta(2, 17, w)
    with pytest.raises(ValueError, match="no kernel for device"):
        if name == "fused_attn_block":
            tps.fused_attn_block(x, meta(w, 3 * w), meta(3 * w), meta(w, w),
                                 meta(w), heads=2)
        elif name == "packed_sdpa_qkv":
            tps.packed_sdpa_qkv(meta(2, 17, 3 * w), heads=2)
        elif name == "fused_sdpa_long":
            y = meta(2, 130, w)
            tps.fused_sdpa_long(y, y, y, heads=2, causal=True)
        elif name == "fused_sdpa_long_qkv":
            tps.fused_sdpa_long_qkv(meta(2, 130, 3 * w), meta(w, w), meta(w),
                                    heads=2)
        elif name == "flash_attention":
            y = meta(2, 2, 130, 64)
            tfa.flash_attention(y, y, y)
        elif name == "fused_attn_sublayer":
            tps.fused_attn_sublayer(x, meta(w), meta(w), meta(w, 3 * w),
                                    meta(3 * w), meta(w, w), meta(w),
                                    heads=2)
        elif name == "fused_mlp":
            tps.fused_mlp(x, meta(w, 4 * w), meta(4 * w), meta(4 * w, w),
                          meta(w))
        elif name == "fused_mlp_w8a8":
            tps.fused_mlp_w8a8(x, meta(w, 4 * w), meta(4 * w), meta(4 * w),
                               meta(4 * w, w), meta(w), meta(w))
        else:
            getattr(tps, name)(x, x, x, heads=2)
    assert tps.LAUNCHES == before


def test_cuda_kernel_path_raises_without_a_gpu(monkeypatch):
    """The launch path itself (as a CUDA tensor would take it) raises
    rather than falling back when the library cannot be built or loaded."""
    from clipx_torch.ops import _build, _launch

    def no_build(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_launch, "_fns", {})
    monkeypatch.setattr(tps, "kernel_device",
                        lambda name, t, *inputs: t.device)
    monkeypatch.setattr(tps, "check_cuda", lambda *a, **k: None)
    q = torch.zeros((2, 17, 128))
    with pytest.raises(RuntimeError, match="nvcc"):
        tps._launch_sdpa("packed_sdpa", q, q, q, 2)


def _capture_launch(monkeypatch, module):
    """Sends ``module``'s kernel path to a recorder on meta tensors: the
    tensors it checks and the arguments it would launch with."""
    seen = {"checked": {}, "launch": None}
    monkeypatch.setattr(module, "kernel_device",
                        lambda name, t, *inputs: t.device)
    monkeypatch.setattr(module, "check_cuda", lambda name, dtype, device, **
                        ts: seen["checked"].update(ts))
    monkeypatch.setattr(module, "c_fn", lambda *a: None)
    monkeypatch.setattr(module, "launch",
                        lambda name, fn, device, *a: seen.update(launch=a))
    return seen


@pytest.mark.parametrize("half", [1, 8, 12, 24, 128])
def test_pq_scan_launch_pads_rows_to_the_kernels_loads(monkeypatch, half):
    """The kernel reads code rows 8 bytes at a time: the wrapper hands it
    rows padded with zeros to a multiple of 8 (the pitch), and the real
    half for the LUT's subspaces."""
    from clipx_torch.ops import pq_scan as tpq

    seen = _capture_launch(monkeypatch, tpq)
    n, q = 70, 9
    out = tpq.pq_scan_scores(torch.empty((n, half), dtype=torch.int8,
                                         device="meta"),
                             torch.empty((half * 32, q), device="meta",
                                         dtype=torch.bfloat16))
    pitch = -(-half // 8) * 8
    assert tuple(out.shape) == (q, n)
    assert tuple(seen["checked"]["packed"].shape) == (n, pitch)
    assert seen["checked"]["lut_t"].dtype == torch.int8
    assert seen["launch"][3:] == (n, half, pitch, q)


@pytest.mark.parametrize("given", [True, False])
def test_fused_mlp_w8a8_launches_on_kmajor_weights(monkeypatch, given):
    """The W8A8 kernel reads (N, K) weights: the wrapper passes the copies
    it is given untouched, or makes them itself (counted in
    W8A8_WEIGHT_COPIES); launch_mlp_w8a8 refuses copies of another shape."""
    seen = _capture_launch(monkeypatch, tps)
    w = 128

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)

    x = meta(2, 17, w, dtype=torch.bfloat16)
    w1_q, w2_q = meta(w, 4 * w, dtype=torch.int8), meta(4 * w, w,
                                                        dtype=torch.int8)
    w1_qt, w2_qt = meta(4 * w, w, dtype=torch.int8), meta(w, 4 * w,
                                                          dtype=torch.int8)
    copies = dict(tps.W8A8_WEIGHT_COPIES)
    kw = {"w1_qt": w1_qt, "w2_qt": w2_qt} if given else {}
    out = tps.fused_mlp_w8a8(x, w1_q, meta(4 * w), meta(4 * w), w2_q,
                             meta(w), meta(w), **kw)
    assert tuple(out.shape) == tuple(x.shape)
    assert tps.W8A8_WEIGHT_COPIES["calls"] == copies["calls"] + (not given)
    got = seen["checked"]
    assert tuple(got["w1_qt"].shape) == (4 * w, w)
    assert tuple(got["w2_qt"].shape) == (w, 4 * w)
    assert (got["w1_qt"] is w1_qt) == given
    assert (got["w2_qt"] is w2_qt) == given
    assert seen["launch"][13:] == (34, w, 4 * w, 1,
                                   tps.gemm_tile_n_mn(34, 4 * w),
                                   tps.gemm_tile_n_mn(34, w))
    with pytest.raises(ValueError, match="w1_qt"):
        tps.launch_mlp_w8a8(x.reshape(-1, w), w1_q, meta(4 * w), meta(4 * w),
                            w2_q, meta(w), meta(w), quick=True)


@pytest.mark.parametrize("heads", [1, 2, 3, 5, 12, 16, 20])
def test_gemm_tile_n_covers_every_width(heads):
    """The out projection's tile width divides N = heads * 64 and is one of
    the GEMM's instances; it is the widest that does."""
    n = 64 * heads
    bn = tps.gemm_tile_n(n)
    assert bn in (64, 128, 192) and n % bn == 0
    assert all(n % wider for wider in (64, 128, 192) if wider > bn)


def test_gemm_tile_n_at_the_towers_widths():
    assert [tps.gemm_tile_n(n) for n in (128, 192, 512, 768, 1024)] == [
        128, 192, 128, 192, 128]
    with pytest.raises(ValueError):
        tps.gemm_tile_n(96)


# (M, N) of B7's GEMMs and B9's out projection on the paths, and the width
# the H100 measured fastest there (chip_smoke.py, phase kernels)
TOWER_GEMMS = {
    (6400, 3072): 128,   # ViT-B/32 image MLP, up, batch 128 (192: +1-2 %)
    (6400, 768): 192,    # its down projection (1.5 waves beat 2.3 and 4.5)
    (77, 2048): 64,      # text tower, one query: 32 blocks beat 16
    (77, 512): 64,
    (4928, 2048): 128,   # text tower, the 64-text bucket
    (4928, 512): 128,
    (73856, 1024): 128,  # B9 at ViT-L/14@336px, batch 128
}


@pytest.mark.parametrize("m,n", sorted(TOWER_GEMMS))
def test_gemm_tile_n_mn_picks_the_measured_widths(m, n):
    assert tps.gemm_tile_n_mn(m, n) == TOWER_GEMMS[(m, n)]


@pytest.mark.parametrize("n", [64 * h for h in (1, 2, 3, 4, 5, 8, 12, 16,
                                                 20, 32, 48, 64)])
def test_gemm_tile_n_mn_divides_n(n):
    for m in (1, 77, 128, 129, 3152, 6400, 25216, 73856):
        bn = tps.gemm_tile_n_mn(m, n)
        assert bn in tps.GEMM_TILES and n % bn == 0
    with pytest.raises(ValueError):
        tps.gemm_tile_n_mn(64, n + 32)


@pytest.mark.parametrize("name", ["fused_attn_block", "fused_attn_sublayer",
                                  "fused_mlp", "fused_sdpa_long_qkv",
                                  "packed_sdpa", "packed_sdpa_rows",
                                  "packed_sdpa_qkv", "fused_sdpa_long",
                                  "flash_attention"])
def test_attn_launchers_match_their_c_entries(name, monkeypatch):
    """The launchers pass exactly the arguments their C entries declare
    (the stream comes last), no qkv scratch, and each GEMM's tile width:
    ``gemm_tile_n`` for B1 and B5, ``gemm_tile_n_mn`` of (M, N) for B7's
    two GEMMs and B9's out projection. The SDPA wrappers all call
    ``clipx_sdpa`` with their layout's element strides (16-byte multiples,
    as the kernel's TMA tensor maps need) and, for the packed projection,
    k and v at W and 2W elements past q."""
    import ctypes

    from clipx_torch.ops import flash_attention as tfa

    calls = []
    for mod in (tps, tfa):
        monkeypatch.setattr(mod, "kernel_device",
                            lambda n, t, *inputs: t.device)
        monkeypatch.setattr(mod, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tps, "c_fn", lambda lib, sym, argtypes: (lib, sym,
                                                                argtypes))
    monkeypatch.setattr(tps, "launch", lambda n, fn, device, *args:
                        calls.append((n, fn, args)))
    b, s, w, heads = 2, 17, 192, 3
    d = w // heads
    x = torch.zeros((b, s, w), dtype=torch.bfloat16)
    wqkv = torch.zeros((w, 3 * w), dtype=torch.bfloat16)
    wo = torch.zeros((w, w), dtype=torch.bfloat16)
    bqkv, bo, ln = torch.zeros(3 * w), torch.zeros(w), torch.ones(w)
    sym, longs = "clipx_" + name, []
    if name == "fused_attn_block":
        out = tps._launch_attn_block(x, wqkv, bqkv, wo, bo, heads)
        lib, want, n_ptr = "attn_block", [b, s, w, heads,
                                          tps.gemm_tile_n(w)], 7
    elif name == "fused_attn_sublayer":
        out = tps._launch_attn_sublayer(x, ln, ln, wqkv, bqkv, wo, bo, heads,
                                        1e-5)
        lib, want, n_ptr = "attn_block", [b, s, w, heads,
                                          tps.gemm_tile_n(w)], 10
    elif name == "fused_mlp":
        x = x.reshape(b * s, w)
        out = tps._launch_mlp(x, wqkv, bqkv, wqkv.T.contiguous(), bo, False)
        lib, n_ptr = "mlp", 7
        want = [b * s, w, 3 * w, 0, tps.gemm_tile_n_mn(b * s, 3 * w),
                tps.gemm_tile_n_mn(b * s, w)]
    elif name == "fused_sdpa_long_qkv":
        qkv = torch.zeros((b, s, 3 * w), dtype=torch.bfloat16)
        out = tps._launch_long_qkv(qkv, wo, bo, heads, True)
        lib, n_ptr = "sdpa", 5
        want = [b, s, w, heads, 1, tps.gemm_tile_n_mn(b * s, w)]
    else:
        lib, sym, n_ptr = "sdpa", "clipx_sdpa", 4
        causal = name == "fused_sdpa_long"
        want = [b, heads, s, d, int(causal)]
        bshd = [s * w, d, w]
        if name == "packed_sdpa_qkv":
            qkv = torch.zeros((b, s, 3 * w), dtype=torch.bfloat16)
            out = tps._launch_sdpa_qkv(qkv, heads)
            longs = [s * 3 * w, d, 3 * w] + bshd
            q0 = qkv.data_ptr()
            ptrs = [q0, q0 + 2 * w, q0 + 4 * w]
        elif name == "flash_attention":
            x = torch.zeros((b, heads, s, d), dtype=torch.bfloat16)
            out = tfa._launch(x, x, x, False)
            longs = [heads * s * d, s * d, d] * 2
            want[-1] = 0
            ptrs = [x.data_ptr()] * 3
        else:
            out = tps._launch_sdpa(name, x, x, x, heads, causal)
            longs = bshd * 2
            ptrs = [x.data_ptr()] * 3
    assert out.shape == x.shape
    (launched, (lib_got, sym_got, argtypes), args), = calls
    assert launched == name and lib_got == lib and sym_got == sym
    assert len(args) + 1 == len(argtypes) and argtypes[-1] is ctypes.c_void_p
    ints = [a for a, t in zip(args, argtypes) if t is ctypes.c_int]
    assert ints == want
    assert [a for a, t in zip(args, argtypes)
            if t is ctypes.c_longlong] == longs
    pointers = [a for a, t in zip(args, argtypes) if t is ctypes.c_void_p]
    assert len(pointers) == n_ptr
    if lib == "sdpa" and n_ptr == 4:
        assert pointers == ptrs + [out.data_ptr()]


def test_sdpa_launcher_refuses_what_tma_cannot_take(monkeypatch):
    """The SDPA kernel reads q, k and v through TMA tensor maps: a base
    that is not 16-byte aligned, or a stride that is not a multiple of 16
    bytes, raises ValueError before anything is built or launched."""
    monkeypatch.setattr(tps, "c_fn", lambda *a: pytest.fail("built"))
    monkeypatch.setattr(tps, "launch", lambda *a: pytest.fail("launched"))
    out = torch.zeros((2, 17, 128), dtype=torch.bfloat16)
    base = out.data_ptr()
    good = dict(batch=2, heads=2, seq=17, head_dim=64,
                in_strides=(17 * 128, 64, 128), out_strides=(17 * 128, 64, 128),
                causal=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tps.launch_sdpa("fused_sdpa_long", base + 2, base, base, out, **good)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tps.launch_sdpa("fused_sdpa_long", base, base, base + 8, out, **good)
    bad = dict(good, in_strides=(17 * 132, 64, 132))
    with pytest.raises(ValueError, match="strides"):
        tps.launch_sdpa("fused_sdpa_long", base, base, base, out, **bad)
    bad = dict(good, out_strides=(17 * 128, 63, 128))
    with pytest.raises(ValueError, match="strides"):
        tps.launch_sdpa("flash_attention", base, base, base, out, **bad)


def test_build_sources_are_the_cuda_files():
    """``_build.SOURCES`` names every csrc/*.cu and nothing else, and every
    quoted ``#include`` of a csrc file names a header that exists (the
    retired short_sdpa.cuh, long_sdpa.cu, gemm.cuh and gemm_s8.cuh are gone
    with their users)."""
    import os
    import re

    from clipx_torch.ops import _build

    files = os.listdir(_build.CSRC_DIR)
    assert set(_build.SOURCES) == {f[:-3] for f in files if f.endswith(".cu")}
    assert not {"short_sdpa.cu", "short_sdpa.cuh", "long_sdpa.cu", "gemm.cuh",
                "gemm_s8.cuh"} & set(files)
    for f in files:
        with open(os.path.join(_build.CSRC_DIR, f)) as fh:
            for inc in re.findall(r'#include\s+"([^"]+)"', fh.read()):
                assert inc in files, f"{f} includes missing {inc}"


@pytest.mark.parametrize("launcher", ["mlp", "long_qkv", "attn_block"])
def test_launchers_refuse_a_tile_width_that_does_not_divide_n(launcher,
                                                             monkeypatch):
    monkeypatch.setattr(tps, "kernel_device", lambda n, t, *inputs: t.device)
    monkeypatch.setattr(tps, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tps, "launch", lambda *a: pytest.fail("launched"))
    w = 256
    wo, bo = torch.zeros((w, w), dtype=torch.bfloat16), torch.zeros(w)
    with pytest.raises(ValueError, match="tile width 192"):
        if launcher == "mlp":
            tps._launch_mlp(torch.zeros((5, w), dtype=torch.bfloat16),
                            torch.zeros((w, 4 * w), dtype=torch.bfloat16),
                            torch.zeros(4 * w), wo, bo, True, (192, 64))
        elif launcher == "long_qkv":
            tps._launch_long_qkv(torch.zeros((1, 70, 3 * w),
                                             dtype=torch.bfloat16),
                                 wo, bo, 4, False, 192)
        else:
            tps._launch_attn_block(torch.zeros((1, 50, w),
                                               dtype=torch.bfloat16),
                                   torch.zeros((w, 3 * w),
                                               dtype=torch.bfloat16),
                                   torch.zeros(3 * w), wo, bo, 4, 192)


def test_launch_counters_reset():
    tps.LAUNCHES["packed_sdpa"] += 3
    tps.reset_launches()
    assert set(tps.LAUNCHES.values()) == {0}
