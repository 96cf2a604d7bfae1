"""The port's contrastive training (clipx_torch/train.py) against clipx's, on
the CPU in f32.

One numpy-seeded param tree (the port's ``init_params``, handed to both
packages) and one seeded batch go through ``contrastive_loss``,
``jax.grad`` against autograd leaf by leaf, the optimizer's schedule and
clip against optax's, and three steps of each ``make_train_step``; for the
ViT tower (tiny-test) and the ResNet tower (tiny-rn-test). Then the kernel
wrappers' refusal of an input that requires grad, and the checkpoint's
round trip.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from clipx import config as jcfg
from clipx import train as jtrain
from clipx_torch import config as tcfg
from clipx_torch import train as ttrain
from clipx_torch.models import convert as tconvert
from clipx_torch.text.tokenizer import ClipTokenizer

torch.set_num_threads(1)

BATCH = 4
# f32 on both sides, different summation orders (XLA's fused reductions,
# PyTorch's eager ones): the loss within 1e-5 relative
LOSS_RTOL = 1e-5
# each leaf's gradient within 1e-4 of that leaf's largest |g| (a sum over
# the batch and the positions of products whose order differs); a leaf
# whose true gradient is 0 (the key bias: softmax ignores a shift that
# every key shares) holds rounding noise only, so the scale has a floor of
# 1e-3 of the tree's largest |g|
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-3
# parameters after three steps: Adam divides each gradient by its own
# running RMS, so a gradient element near 0 whose sign the summation order
# flips moves by up to lr either way; the bound is 1e-3 of the peak lr a
# step for all but those, and the comparison is on the update itself
LR = 1e-3
STEP_ATOL = 2e-3 * LR


def _params(model: str, seed: int = 0):
    return tconvert.init_params(tcfg.get_config(model), seed)


def _batch(model: str, seed: int = 1):
    cfg = tcfg.get_config(model)
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    pixels = rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
    ids = ClipTokenizer()(["a red square", "a green field", "blue sky",
                           "noise over the city lights"][:BATCH],
                          context_length=cfg.text.context_length)
    return pixels, ids


def _jparams(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v))
    return out


def _port_loss_and_grads(model, tree, pixels, ids, remat=False):
    cfg = tcfg.get_config(model)
    params = ttrain.trainable_params(tree, "cpu")
    loss, metrics = ttrain.contrastive_loss(
        params, cfg, torch.from_numpy(pixels), torch.from_numpy(ids),
        remat=remat)
    leaves = ttrain.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    gtree = dict(zip(_flat(params).keys(), (g.numpy() for g in grads)))
    return (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
            gtree)


@pytest.mark.parametrize("model", ["tiny-test", "tiny-rn-test"])
def test_loss_metrics_and_grads_match_clipx(model):
    tree = _params(model)
    pixels, ids = _batch(model)
    jc = jcfg.get_config(model)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jtrain.contrastive_loss(p, jc, jnp.asarray(pixels),
                                          jnp.asarray(ids),
                                          attn_impl="plain"),
        has_aux=True)(_jparams(tree))
    loss, m, g = _port_loss_and_grads(model, tree, pixels, ids)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=LOSS_RTOL)
    assert m["accuracy"] == float(jm["accuracy"])
    np.testing.assert_allclose(m["logit_scale"], float(jm["logit_scale"]),
                               rtol=1e-6)
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jg))
    assert set(jflat) == set(g)
    top = max(float(np.abs(ref).max()) for ref in jflat.values())
    for key, ref in jflat.items():
        scale = max(float(np.abs(ref).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(g[key], ref, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=key)


def test_remat_gives_the_same_loss_and_grads():
    """--remat recomputes each block in the backward pass: the same
    operations on the same inputs, so the same numbers bit for bit."""
    tree = _params("tiny-test")
    pixels, ids = _batch("tiny-test")
    loss, _, g = _port_loss_and_grads("tiny-test", tree, pixels, ids)
    loss_r, _, g_r = _port_loss_and_grads("tiny-test", tree, pixels, ids,
                                          remat=True)
    assert loss_r == loss
    for key in g:
        np.testing.assert_array_equal(g_r[key], g[key], err_msg=key)


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 5), (4, 2), (1, 1)])
def test_schedule_matches_optax(warmup, total):
    """The lr at every count from 0 to past the end, against optax's
    warmup_cosine_decay_schedule with clipx's arguments (f32 in optax)."""
    ref = optax.warmup_cosine_decay_schedule(0.0, LR, warmup,
                                             max(total, warmup + 1))
    ours = ttrain.make_optimizer(LR, 0.02, warmup, total).schedule
    for count in range(0, max(total, warmup + 1) + 2):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=count)
    if warmup:
        assert ours(0) == 0.0    # the first update moves nothing


@pytest.mark.parametrize("scale", [0.1, 0.999, 1.0, 7.5])
def test_clip_matches_optax_above_and_below_the_norm(scale):
    """optax.clip_by_global_norm(1.0): untouched below the norm, scaled by
    1/||g|| at and above it (no epsilon)."""
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in
              ((3, 4), (5,), (2, 2, 2))]
    norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                       for x in leaves))
    leaves = [x * np.float32(scale / norm) for x in leaves]
    tx = optax.clip_by_global_norm(1.0)
    ref, _ = tx.update([jnp.asarray(x) for x in leaves], tx.init(None))
    grads = [torch.from_numpy(x.copy()) for x in leaves]
    got = ttrain.make_optimizer().clip(grads)
    np.testing.assert_allclose(float(got), scale, rtol=1e-6)
    for g, r, x in zip(grads, ref, leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
        if scale < 1.0:
            np.testing.assert_array_equal(g.numpy(), x)


def test_global_norm_is_accurate_at_a_full_width_leaf():
    """The clip's global norm over a leaf the size of a ViT-B/32 MLP stack
    slice (8 M elements) within 1e-6 of the f64 norm: PyTorch's CPU f32
    vector_norm and _foreach_norm add in order and come out ~1e-3 low at
    this size (measured on a full-width card-vs-CPU step), which optax's
    XLA reduction does not."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn((4, 2048, 1024), generator=gen) * 1e-3,
             torch.randn((7,), generator=gen)]
    ref = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    norm = float(ttrain.make_optimizer().clip([g.clone() for g in grads]))
    assert abs(norm - ref) <= 1e-6 * ref


def _clipx_steps(model, tree, batches, warmup, total, wd=0.02):
    jc = jcfg.get_config(model)
    tx = jtrain.make_optimizer(LR, wd, warmup, total)
    params = _jparams(tree)
    state = jtrain.TrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
    step = jax.jit(jtrain.make_train_step(jc, tx, attn_impl="plain"))
    metrics = []
    for pixels, ids in batches:
        state, m = step(state, jnp.asarray(pixels), jnp.asarray(ids))
        metrics.append({k: float(v) for k, v in m.items()})
    return _flat(jax.tree_util.tree_map(np.asarray, state.params)), metrics


def _port_steps(model, tree, batches, warmup, total, wd=0.02):
    cfg = tcfg.get_config(model)
    state, tx = ttrain.create_train_state(
        cfg, tx=ttrain.make_optimizer(LR, wd, warmup, total), device="cpu",
        params=tree)
    step = ttrain.make_train_step(cfg, tx)
    metrics = []
    for pixels, ids in batches:
        state, m = step(state, torch.from_numpy(pixels),
                        torch.from_numpy(ids))
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == len(batches) and state.opt_state.count == state.step
    return _flat(state.params), metrics


@pytest.mark.parametrize("model", ["tiny-test", "tiny-rn-test"])
def test_three_train_steps_match_clipx(model):
    """Three steps of make_train_step from one tree and three batches, with
    warmup 1 (step 0 moves nothing): metrics within the loss tolerance,
    every parameter's update within STEP_ATOL of clipx's."""
    tree = _params(model)
    batches = [_batch(model, seed) for seed in (1, 2, 3)]
    jp, jm = _clipx_steps(model, tree, batches, warmup=1, total=3)
    tp, tm = _port_steps(model, tree, batches, warmup=1, total=3)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        assert a["accuracy"] == b["accuracy"]
    init = _flat(tree)
    assert set(tp) == set(jp) == set(init)
    for key in jp:
        np.testing.assert_allclose(tp[key] - init[key], jp[key] - init[key],
                                   rtol=0, atol=STEP_ATOL, err_msg=key)


def test_first_update_moves_nothing_but_fills_the_moments():
    """optax reads the schedule before the update: lr(0) = 0, so step 0
    leaves every parameter (weight decay included) exactly as it was,
    while the moments take the first gradient."""
    tree = _params("tiny-test")
    tp, _ = _port_steps("tiny-test", tree, [_batch("tiny-test")], warmup=2,
                        total=5, wd=0.5)
    for key, val in _flat(tree).items():
        np.testing.assert_array_equal(tp[key], val, err_msg=key)
    cfg = tcfg.get_config("tiny-test")
    state, tx = ttrain.create_train_state(
        cfg, tx=ttrain.make_optimizer(LR, 0.5, 2, 5), device="cpu",
        params=tree)
    pixels, ids = _batch("tiny-test")
    state, _ = ttrain.make_train_step(cfg, tx)(
        state, torch.from_numpy(pixels), torch.from_numpy(ids))
    assert all(float(m.abs().max()) > 0
               for m in ttrain.tree_leaves(state.opt_state.mu))


def test_kernel_wrappers_refuse_an_input_that_requires_grad():
    """A kernel's output has no grad_fn, so a wrapper refuses an input
    that requires grad while grad mode is on; the CPU's plain route
    refuses it too, as the card would. Under torch.no_grad() it runs."""
    from clipx_torch.ops import packed_sdpa as tps
    from clipx_torch.ops._launch import kernel_device

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 128), generator=gen)
    w1 = torch.randn((128, 256), generator=gen).requires_grad_(True)
    b1, w2 = torch.zeros(256), torch.randn((256, 128), generator=gen)
    b2 = torch.zeros(128)
    with pytest.raises(RuntimeError, match="fused_mlp: an input requires"):
        tps.fused_mlp(x, w1, b1, w2, b2)
    with pytest.raises(RuntimeError, match="packed_sdpa_rows"):
        tps.packed_sdpa_rows(x.requires_grad_(True), x, x, heads=2)
    with pytest.raises(RuntimeError, match="fused_attn_block"):
        kernel_device("fused_attn_block", x)
    with torch.no_grad():
        out = tps.fused_mlp(x, w1, b1, w2, b2)
        tps.packed_sdpa_rows(x, x, x, heads=2)
    assert out.shape == x.shape
    x.requires_grad_(False)
    tps.fused_mlp(x, w1.detach(), b1, w2, b2)   # nothing requires grad


def test_checkpoint_round_trip_and_refusals(tmp_path):
    """save_train_state -> restore_train_state brings back params, both
    moments, the count and the step into a fresh state; clipx's orbax
    directory and a foreign file are refused with a message."""
    cfg = tcfg.get_config("tiny-rn-test")
    tree = _params("tiny-rn-test")
    state, tx = ttrain.create_train_state(
        cfg, tx=ttrain.make_optimizer(LR, 0.02, 1, 4), device="cpu",
        params=tree)
    step = ttrain.make_train_step(cfg, tx)
    pixels, ids = _batch("tiny-rn-test")
    for _ in range(2):
        state, _ = step(state, torch.from_numpy(pixels),
                        torch.from_numpy(ids))
    path = str(tmp_path / "latest")
    ttrain.save_train_state(path, state)
    fresh, _ = ttrain.create_train_state(cfg, tx=tx, device="cpu",
                                         params=_params("tiny-rn-test", 5))
    back = ttrain.restore_train_state(path, fresh)
    assert back.step == 2 and back.opt_state.count == 2
    for part in ("params", "mu", "nu"):
        a = _flat(getattr(state, part) if part == "params"
                  else getattr(state.opt_state, part))
        b = _flat(getattr(back, part) if part == "params"
                  else getattr(back.opt_state, part))
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    # the conv kernels keep their stored permutation
    w = back.params["visual"]["stem"]["conv1"]
    assert w.stride() == state.params["visual"]["stem"]["conv1"].stride()
    orbax = tmp_path / "orbax_latest"
    orbax.mkdir()
    with pytest.raises(ttrain.CheckpointFormatError, match="orbax"):
        ttrain.restore_train_state(str(orbax), fresh)
    other = tmp_path / "other.npz"
    np.savez(other, x=np.zeros(3))
    with pytest.raises(ttrain.CheckpointFormatError, match="not a"):
        ttrain.restore_train_state(str(other), fresh)
    # the trained tree goes back to clipx's numpy layout: HWIO kernels
    out = tconvert.to_jax_params(state.params)
    assert out["visual"]["stem"]["conv1"].shape == tree["visual"]["stem"][
        "conv1"].shape
    assert out["visual"]["stem"]["conv1"].flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(
        out["visual"]["stem"]["conv1"],
        state.params["visual"]["stem"]["conv1"].detach().numpy())
