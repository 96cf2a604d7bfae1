"""The port's W8A8 compute and fused MLP / sublayer kernels against clipx.

- ``models.quant``: the same seeded weights and activations through clipx's
  and the port's quantizers give bitwise equal int8 codes and equal scales;
  ``dense_w8a8`` agrees within 1e-6 in f32.
- The plain versions of ``fused_mlp`` (B7), ``fused_mlp_w8a8`` (B6) and
  ``fused_attn_sublayer`` (B5) against clipx's Pallas kernels in interpret
  mode (as tests/test_flash_attention.py runs them), at small widths: 2e-5
  for B7 and 3e-5 for B5 (f32 summation order only; clipx's own bounds for
  these kernels), and 1e-3 of max|ref| for B6, whose f32 activation may
  round an occasional requantized code the other way.
- The Encoder with ``compute_quant="int8"`` against clipx's int8 Encoder
  (cosine >= 0.9999), and clipx's drift gates held on the port itself.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clipx import config as jcfg
from clipx.models import clip as jclip
from clipx.models import layers as jlayers
from clipx.models import quant as jquant
from clipx.ops import packed_sdpa as jps
from clipx_torch import config as tcfg
from clipx_torch.models import convert as tconvert
from clipx_torch.models import quant as tquant
from clipx_torch.ops import packed_sdpa as tps

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

W, H = 128, 512


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("shape", [(3, 64, 128), (96, 160), (W, H)])
def test_quantize_weight_matches_clipx(shape):
    w = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    w[..., 5] = 0.0  # an all-zero output channel takes the 1e-12 floor
    ref_q, ref_s = jquant.quantize_weight(w)
    q, s = tquant.quantize_weight(w)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def _clipx_row_codes(x):
    """clipx's dense_w8a8 activation quantization, step by step."""
    x32 = jnp.asarray(x, jnp.float32)
    scale = jnp.maximum(jnp.abs(x32).max(axis=-1, keepdims=True),
                        1e-12) / 127.0
    return jnp.clip(jnp.rint(x32 / scale), -127, 127).astype(jnp.int8), scale


@pytest.mark.parametrize("bias", [True, False])
def test_dense_w8a8_matches_clipx(bias):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 7, W)).astype(np.float32)
    x[1, 2] = 0.0  # a zero row
    w = rng.normal(size=(W, H)).astype(np.float32) * 0.05
    b = rng.normal(size=(H,)).astype(np.float32) if bias else None
    w_i8, s = jquant.quantize_weight(w)
    ref = np.asarray(jquant.dense_w8a8(jnp.asarray(x), w_i8, s,
                                       None if b is None else jnp.asarray(b)))
    tw, ts = tquant.quantize_weight(w)
    out = tquant.dense_w8a8(torch.from_numpy(x), tw, ts,
                            None if b is None else torch.from_numpy(b))
    assert out.dtype == torch.float32 and out.shape == (4, 7, H)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    ref_codes, ref_scale = _clipx_row_codes(x)
    codes, scale = tquant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
    assert (out.numpy()[1, 2] == (0 if b is None else b)).all()


def test_dense_w8a8_tracks_dense_and_keeps_zero_rows_finite():
    """clipx's gates (tests/test_quant.py) on the port: W8A8 within 2 % of
    the row magnitude of the f32 dense; a zero input row stays 0."""
    from clipx_torch.models.layers import dense

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 7, 96)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(96, 160)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(160,)).astype(np.float32))
    w_i8, s = tquant.quantize_weight(w)
    ref = dense(x, w, b)
    got = tquant.dense_w8a8(x, w_i8, s, b)
    assert float((got - ref).abs().max() / ref.abs().max()) < 0.02
    z_i8, zs = tquant.quantize_weight(torch.ones((8, 16)))
    out = tquant.dense_w8a8(torch.zeros((2, 8)), z_i8, zs)
    assert bool(torch.isfinite(out).all()) and bool((out == 0).all())


def _mlp_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 33, W).astype(np.float32) * 0.5  # odd row count
    w1 = rng.randn(W, H).astype(np.float32) * 0.05
    b1 = rng.randn(H).astype(np.float32) * 0.01
    w2 = rng.randn(H, W).astype(np.float32) * 0.05
    b2 = rng.randn(W).astype(np.float32) * 0.01
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("quick", [True, False])
def test_fused_mlp_plain_matches_pallas(quick):
    args = _mlp_inputs(12)
    ref = np.asarray(jps.fused_mlp(*(jnp.asarray(a) for a in args),
                                   quick=quick, interpret=True))
    out = tps.fused_mlp(*_t(*args), quick=quick)
    assert out.shape == args[0].shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quick", [True, False])
def test_fused_mlp_w8a8_plain_matches_pallas(quick):
    x, w1, b1, w2, b2 = _mlp_inputs(14)
    w1_q, s1 = jquant.quantize_weight(w1)
    w2_q, s2 = jquant.quantize_weight(w2)
    ref = np.asarray(jps.fused_mlp_w8a8(jnp.asarray(x), w1_q, s1,
                                        jnp.asarray(b1), w2_q, s2,
                                        jnp.asarray(b2), quick=quick,
                                        interpret=True))
    args = _t(x, w1_q, s1, b1, w2_q, s2, b2)
    out = tps.fused_mlp_w8a8(*args, quick=quick).numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-3
    # the plain version ignores the kernel's K-major weight copies
    kmajor = tps.fused_mlp_w8a8(*args, quick=quick,
                                w1_qt=args[1].T.contiguous(),
                                w2_qt=args[4].T.contiguous()).numpy()
    np.testing.assert_array_equal(kmajor, out)


@pytest.mark.parametrize("layers", [None, 3])
def test_quantize_mlp_stack_makes_kmajor_copies(layers):
    """quantize_mlp_stack's w1_qt / w2_qt, the fused W8A8 kernel's K-major
    weights, are w1_q / w2_q transposed over their last two axes, bitwise
    and contiguous, for one layer and for a layer stack; the rest of the
    group is clipx's."""
    rng = np.random.default_rng(7)
    lead = () if layers is None else (layers,)
    mlp = {"w1": rng.normal(size=lead + (W, H)).astype(np.float32),
           "b1": rng.normal(size=lead + (H,)).astype(np.float32),
           "w2": rng.normal(size=lead + (H, W)).astype(np.float32),
           "b2": rng.normal(size=lead + (W,)).astype(np.float32)}
    q = tquant.quantize_mlp_stack({k: torch.from_numpy(v)
                                   for k, v in mlp.items()})
    ref = jquant.quantize_mlp_stack(mlp)
    assert set(q) == set(ref) | {"w1_qt", "w2_qt"}
    for key in ref:
        np.testing.assert_array_equal(q[key].numpy(), np.asarray(ref[key]))
    for i, shape in ((1, (H, W)), (2, (W, H))):
        qt = q[f"w{i}_qt"]
        assert qt.dtype == torch.int8 and qt.is_contiguous()
        assert tuple(qt.shape) == lead + shape
        assert torch.equal(qt, q[f"w{i}_q"].transpose(-1, -2))


def test_mlp_block_passes_the_kmajor_copies(monkeypatch):
    """Under CLIPX_FUSED_MLP_INT8=on mlp_block hands fused_mlp_w8a8 the
    copies quantize_mlp_stack made (no per-call transpose), and None for a
    group without them."""
    from clipx_torch.models import layers as tlayers

    monkeypatch.setenv("CLIPX_FUSED_MLP_INT8", "on")
    seen = []

    def record(x, *args, **kw):
        seen.append(kw)
        return x

    monkeypatch.setattr(tps, "fused_mlp_w8a8", record)
    rng = np.random.default_rng(8)
    p = tquant.quantize_mlp_stack({
        "w1": torch.from_numpy(rng.normal(size=(W, H)).astype(np.float32)),
        "b1": torch.zeros(H), "w2": torch.from_numpy(
            rng.normal(size=(H, W)).astype(np.float32)), "b2": torch.zeros(W)})
    x = torch.zeros((2, 3, W))
    tlayers.mlp_block(x, p, "quick_gelu")
    assert seen[-1]["w1_qt"] is p["w1_qt"] and seen[-1]["w2_qt"] is p["w2_qt"]
    tlayers.mlp_block(x, {k: v for k, v in p.items()
                          if not k.endswith("_qt")}, "quick_gelu")
    assert seen[-1]["w1_qt"] is None and seen[-1]["w2_qt"] is None


@pytest.mark.parametrize("b,s", [(2, 50), (4, 17)])
def test_fused_attn_sublayer_plain_matches_pallas(b, s):
    rng = np.random.RandomState(15 + s)
    heads = W // 64
    x = rng.randn(b, s, W).astype(np.float32) * 0.3
    ln_s = rng.randn(W).astype(np.float32) * 0.1 + 1.0
    ln_b = rng.randn(W).astype(np.float32) * 0.05
    wqkv = rng.randn(W, 3 * W).astype(np.float32) * 0.03
    bqkv = rng.randn(3 * W).astype(np.float32) * 0.01
    wo = rng.randn(W, W).astype(np.float32) * 0.03
    bo = rng.randn(W).astype(np.float32) * 0.01
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    ref = np.asarray(jps.fused_attn_sublayer(
        *(jnp.asarray(a) for a in args), heads=heads, eps=1e-5,
        interpret=True))
    out = tps.fused_attn_sublayer(*_t(*args), heads=heads, eps=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("width,hidden", [(768, 3072), (512, 2048),
                                          (1024, 4096), (64, 256), (128, 512),
                                          (1280, 5120), (640, 2560)])
def test_fusible_rules_match_clipx(width, hidden):
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        assert (tps.mlp_fusible(width, hidden, tdt)
                == jps.mlp_fusible(width, hidden, jdt))
    assert tps.mlp_w8a8_fusible(width, hidden) == jps.mlp_w8a8_fusible(
        width, hidden)


def test_fusible_rules_at_the_presets():
    """ViT-B/32 fuses in bf16 (both towers), not in f32; ViT-L fuses in
    neither; the W8A8 rule holds at ViT-B/32 and not at ViT-L."""
    assert tps.mlp_fusible(768, 3072, torch.bfloat16)
    assert tps.mlp_fusible(512, 2048, torch.bfloat16)
    assert not tps.mlp_fusible(768, 3072, torch.float32)
    assert not tps.mlp_fusible(1024, 4096, torch.bfloat16)
    assert tps.mlp_w8a8_fusible(768, 3072)
    assert not tps.mlp_w8a8_fusible(1024, 4096)


# ---------------------------------------------------------------------------
# the Encoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree_util.tree_map(
        np.asarray, jclip.init_params(jcfg.get_config("tiny-test"),
                                      jax.random.PRNGKey(0)))


def _images(seed, n=4):
    return np.random.default_rng(seed).integers(0, 255, (n, 32, 32, 3),
                                                dtype=np.uint8)


def _port(params, **kw):
    from clipx_torch.runtime.encoder import Encoder

    return Encoder(tcfg.get_config("tiny-test"), params, device="cpu",
                   batch_buckets=(4,), **kw)


def _clipx(params, **kw):
    from clipx.runtime.encoder import Encoder

    return Encoder(jcfg.get_config("tiny-test"), params, batch_buckets=(4,),
                   **kw)


def test_from_jax_params_keeps_int8_groups(monkeypatch, tiny_params):
    """clipx's int8 Encoder params (MLP, attention and patch embedding
    quantized) carried across in bf16: int8 codes stay int8, the scales and
    biases beside them stay f32, the rest follows the bf16 rule."""
    monkeypatch.setenv("CLIPX_INT8_ATTN", "on")
    monkeypatch.setenv("CLIPX_INT8_PATCH", "on")
    ref = _clipx(tiny_params, compute_quant="int8").params
    placed = tconvert.from_jax_params(ref, tcfg.get_config("tiny-test"),
                                      dtype=torch.bfloat16)
    v, rv = placed["visual"], ref["visual"]
    for ours, theirs in ((v["blocks"]["mlp"], rv["blocks"]["mlp"]),
                         (v["blocks"]["attn"], rv["blocks"]["attn"]),
                         (v["patch_embed"], rv["patch_embed"])):
        for key, t in ours.items():
            want = torch.int8 if key.endswith("_q") else torch.float32
            assert t.dtype == want, key
            np.testing.assert_array_equal(t.numpy(), np.asarray(theirs[key]))
    assert placed["text"]["blocks"]["mlp"]["w1"].dtype == torch.bfloat16
    assert v["ln_pre"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("env", [
    {}, {"CLIPX_FUSED_MLP_INT8": "on"},
    {"CLIPX_INT8_ATTN": "on", "CLIPX_INT8_PATCH": "on"}])
def test_int8_encoder_matches_clipx(monkeypatch, tiny_params, env):
    """The port's int8 Encoder against clipx's on the same params: the same
    int8 weights, and image embeddings at cosine >= 0.9999. Under
    CLIPX_FUSED_MLP_INT8=on clipx runs as on a TPU (its fused_mlp_w8a8 in
    interpret mode), the port its plain version of the same kernel."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if env.get("CLIPX_FUSED_MLP_INT8") == "on":
        monkeypatch.setattr(jlayers, "_on_tpu", lambda: True)
    ref, ours = _clipx(tiny_params, compute_quant="int8"), _port(
        tiny_params, compute_quant="int8")
    assert ours.compute_quant == ref.compute_quant == "int8"
    for name, group in ref.params["visual"]["blocks"].items():
        for key, val in group.items():
            if key.endswith("_q") or key.startswith("s"):
                np.testing.assert_array_equal(
                    ours.params["visual"]["blocks"][name][key].numpy(),
                    np.asarray(val))
    images = _images(5)
    cos = (ours.encode_images(images) * ref.encode_images(images)).sum(1)
    assert (cos >= 0.9999).all(), cos


@pytest.mark.parametrize("env,gate", [
    ({}, 0.99), ({"CLIPX_FUSED_MLP_INT8": "on"}, 0.99),
    ({"CLIPX_INT8_ATTN": "on", "CLIPX_INT8_PATCH": "on"}, 0.98)])
def test_int8_encoder_drift_gates(monkeypatch, tiny_params, env, gate):
    """clipx's gates (tests/test_quant.py) on the port: int8 against the
    port's own non-quantized encode, cosine > 0.99 (> 0.98 with the
    attention and patch GEMMs quantized too); the text tower is untouched,
    so its embeddings are bit-identical; self-retrieval holds."""
    from clipx_torch.search.engine import VectorIndex

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    base, q = _port(tiny_params), _port(tiny_params, compute_quant="int8")
    mlp = q.params["visual"]["blocks"]["mlp"]
    assert mlp["w1_q"].dtype == torch.int8 and "w1" not in mlp
    assert ("wq_q" in q.params["visual"]["blocks"]["attn"]) == bool(env.get(
        "CLIPX_INT8_ATTN"))
    assert "w1" in q.params["text"]["blocks"]["mlp"]
    images = _images(2, 8)
    e0, e1 = base.encode_images(images), q.encode_images(images)
    assert ((e0 * e1).sum(1) > gate).all()
    np.testing.assert_array_equal(base.encode_texts(["a photo"]),
                                  q.encode_texts(["a photo"]))
    _, ids = VectorIndex.from_vectors(e1, device="cpu").search(e1, 1)
    assert (ids[:, 0] == np.arange(8)).all()


def test_int8_encoder_guards_and_env(monkeypatch, tiny_params):
    with pytest.raises(ValueError, match="compute mode"):
        _port(tiny_params, compute_quant="fp4")
    monkeypatch.setenv("CLIPX_COMPUTE", "int8")
    assert _port(tiny_params).compute_quant == "int8"
    # an explicit argument beats the environment, as in clipx
    assert _port(tiny_params, compute_quant="bf16").compute_quant is None
    monkeypatch.setenv("CLIPX_COMPUTE", "bf16")
    assert _port(tiny_params, compute_quant="int8").compute_quant == "int8"
    with pytest.raises(ValueError, match="compute mode"):
        monkeypatch.setenv("CLIPX_COMPUTE", "int4")
        _port(tiny_params)
