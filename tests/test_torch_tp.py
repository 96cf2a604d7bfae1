"""The port's tensor parallelism (``clipx_torch/parallel/tensor.py``, the
TP specs of ``parallel/mesh.py``, ``train.make_sharded_train_step`` and the
Encoder's ``mesh=..., tp="tp"``) against clipx's, on the CPU in f32.

clipx runs on ``make_mesh({"dp": 4, "tp": 2})`` over the suite's 8 virtual
CPU devices, the port on ``make_mesh({"dp": 4, "tp": 2}, [cpu] * 8)``. One
numpy-seeded param tree (the port's ``init_params``) and one seeded batch go
to both. Tolerances: clipx's own for the TP encode (2e-4,
``tests/test_parallel.py``) and the dp x tp Encoder (2e-5 / 2e-6), and
``tests/test_torch_train.py``'s for the step: the loss within
``LOSS_RTOL``, each leaf's gradient within ``GRAD_TOL`` of its largest
|g| (floored), each parameter's update after three steps within
``STEP_ATOL``. Replicated leaves are compared bitwise across replicas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipx import config as jcfg
from clipx import train as jtrain
from clipx.models import clip as jclip
from clipx.parallel import mesh as jmesh
from clipx.runtime.encoder import Encoder as JEncoder
from clipx_torch import config as tcfg
from clipx_torch import train as ttrain
from clipx_torch.models import convert as tconvert
from clipx_torch.parallel import mesh as tmesh
from clipx_torch.parallel import tensor as ttensor
from clipx_torch.parallel.distributed import Group
from clipx_torch.runtime.encoder import Encoder as TEncoder
from clipx_torch.text.tokenizer import ClipTokenizer
from test_torch_train import GRAD_FLOOR, GRAD_TOL, LOSS_RTOL, LR, STEP_ATOL

torch.set_num_threads(1)

CPU = torch.device("cpu")
BATCH = 8
CAPTIONS = ["a red square", "a green field", "blue sky", "city lights",
            "a dog on the beach", "two cats asleep", "a sunset",
            "noise over the city lights"]


def _tmesh(dp=4, tp=2):
    return tmesh.make_mesh({"dp": dp, "tp": tp}, [CPU] * (dp * tp))


def _jmesh(dp=4, tp=2):
    return jmesh.make_mesh({"dp": dp, "tp": tp}, jax.devices()[: dp * tp])


def _batch(model, seed=1):
    cfg = tcfg.get_config(model)
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    pixels = rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
    ids = ClipTokenizer()([f"{c} {seed}" for c in CAPTIONS],
                          context_length=cfg.text.context_length)
    return pixels, ids


def _flat(tree):
    return tconvert._flatten(tconvert.to_jax_params(tree))


def _spec_tuples(tree):
    return {k: (_spec_tuples(v) if isinstance(v, dict) else tuple(v))
            for k, v in tree.items()}


# -- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("tp", ["tp", None])
def test_param_specs_equal_clipx(tp):
    assert tmesh.param_specs(tp) == _spec_tuples(jmesh.param_specs(tp))


def test_mesh_positions_are_row_major_in_the_given_order():
    """{"dp": 4, "tp": 2}: position 2 i + j is dp row i, tp column j, as
    clipx's reshape of the device list; {"tp": 2, "dp": 4} the other way
    round."""
    mesh = _tmesh()
    assert mesh.groups("tp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups("dp") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    jm = _jmesh()
    for pos in range(8):
        assert jm.devices.reshape(-1)[pos] == jm.devices[
            mesh.coord(pos, "dp"), mesh.coord(pos, "tp")]
    other = tmesh.make_mesh({"tp": 2, "dp": 4}, [CPU] * 8)
    assert other.groups("tp") == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_shard_params_slices_whole_heads_and_round_trips():
    """Each tp column holds its contiguous slice of the sharded leaves
    (one tree a column on a repeated device), the replicated leaves whole;
    gather() gives the tree back bitwise. At tp 4 each column holds half a
    head (clipx's column slice); a sharded dim that does not divide raises,
    naming the leaf."""
    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    sh = tmesh.shard_params(tree, _tmesh())
    assert [pos for pos, _ in sh.placements()] == [0, 1]
    assert all(sh.trees[p] is sh.trees[p % 2] for p in range(8))
    wq = tree["visual"]["blocks"]["attn"]["wq"]
    half = wq.shape[-1] // 2
    np.testing.assert_array_equal(
        sh.trees[1]["visual"]["blocks"]["attn"]["wq"].numpy(),
        wq[..., half:])
    wo = tree["text"]["blocks"]["attn"]["wo"]
    np.testing.assert_array_equal(
        sh.trees[1]["text"]["blocks"]["attn"]["wo"].numpy(),
        wo[:, wo.shape[1] // 2:])
    np.testing.assert_array_equal(sh.trees[1]["visual"]["proj"].numpy(),
                                  tree["visual"]["proj"])
    back = _flat(sh.gather())
    for key, val in tconvert._flatten(tree).items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)
    quarter = tmesh.shard_params(tree, tmesh.make_mesh({"dp": 1, "tp": 4},
                                                       [CPU] * 4))
    w, r = wq.shape[-1] // 4, wo.shape[1] // 4
    np.testing.assert_array_equal(
        quarter.trees[3]["visual"]["blocks"]["attn"]["wq"].numpy(),
        wq[..., 3 * w:])
    np.testing.assert_array_equal(
        quarter.trees[1]["text"]["blocks"]["attn"]["wo"].numpy(),
        wo[:, r:2 * r])
    with pytest.raises(ValueError, match="visual/patch_embed/kernel: dim 1 "
                       "of size 64 does not split"):
        tmesh.shard_params(tree, tmesh.make_mesh({"dp": 1, "tp": 3},
                                                 [CPU] * 3))


# -- the TP forward and the Encoder --------------------------------------------

def test_tp_encode_matches_clipx():
    """tiny-test on a dp 4 x tp 2 mesh: each dp row's share through the TP
    forward against clipx's jit of encode_image over its TP-sharded params
    (tests/test_parallel.py's bound); the text tower too."""
    cfg = tcfg.get_config("tiny-test")
    jc = jcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    pixels, ids = _batch("tiny-test")
    jm = _jmesh()
    jparams = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jm)
    bsh = jmesh.batch_sharding(jm)
    ref_img = np.asarray(jax.jit(lambda p, x: jclip.encode_image(p, jc, x))(
        jparams, jax.device_put(pixels, bsh)))
    ref_txt = np.asarray(jax.jit(lambda p, x: jclip.encode_text(p, jc, x))(
        jparams, jax.device_put(ids, bsh)))
    mesh = _tmesh()
    sh = tmesh.shard_params(tree, mesh)
    img, txt = [], []
    for i, row in enumerate(mesh.groups("tp")):
        g = Group(mesh, row)
        trees = [sh.trees[p] for p in row]
        rows_of = slice(2 * i, 2 * i + 2)
        px = torch.from_numpy(pixels[rows_of])
        ti = torch.from_numpy(ids[rows_of])
        a = ttensor.encode_image(trees, cfg, [px, px], g)
        b = ttensor.encode_text(trees, cfg, [ti, ti], g)
        assert torch.equal(a[0], a[1]) and torch.equal(b[0], b[1])
        img.append(a[0].numpy())
        txt.append(b[0].numpy())
    np.testing.assert_allclose(np.concatenate(img), ref_img, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(np.concatenate(txt), ref_txt, rtol=2e-4,
                               atol=2e-4)


def test_encoder_dp_tp_matches_clipx_single_device():
    """Encoder(mesh=dp 4 x tp 2, tp="tp") against clipx's single-device
    Encoder (tests/test_parallel.py::test_dp_encode_tp_sharded_params's
    bound), images (a full bucket and a ragged one) and texts."""
    cfg = tcfg.get_config("tiny-test")
    jc = jcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 1)
    single = JEncoder(jc, jax.tree_util.tree_map(jnp.asarray, tree))
    dptp = TEncoder(cfg, tree, mesh=_tmesh(), tp="tp")
    assert all(b % 8 == 0 for b in dptp.buckets)
    rng = np.random.RandomState(1)
    s = cfg.vision.image_size
    batch = rng.randint(0, 256, (8, s, s, 3), dtype=np.uint8)
    np.testing.assert_allclose(dptp.encode_images(batch),
                               single.encode_images(batch),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(dptp.encode_images(batch[:3]),
                               single.encode_images(batch[:3]),
                               rtol=2e-5, atol=2e-6)
    texts = ["a red square", "blue sky over a city"]
    np.testing.assert_allclose(dptp.encode_texts(texts),
                               single.encode_texts(texts),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_tp_forces_plain_attention(impl):
    """clipx's test_tp_forces_plain_attention_even_when_pallas_requested:
    under tp every requested attn_impl becomes "plain", and the encode
    launches no kernel of the port."""
    from clipx_torch.ops import packed_sdpa as tps

    cfg = tcfg.get_config("tiny-test")
    enc = TEncoder(cfg, tconvert.init_params(cfg, 0), mesh=_tmesh(),
                   tp="tp", attn_impl=impl)
    assert enc.attn_impl == "plain"
    jc = jcfg.get_config("tiny-test")
    jenc = JEncoder(jc, jclip.init_params(jc, jax.random.PRNGKey(0)),
                    mesh=_jmesh(), tp="tp", attn_impl=impl)
    assert jenc.attn_impl == "plain"
    before = tps.launch_counts()
    enc.encode_images(np.zeros((2, 32, 32, 3), np.uint8))
    assert tps.launch_counts() == before


@pytest.mark.parametrize("case", ["resnet", "int8"])
def test_tp_refusals_match_clipx(case, monkeypatch):
    """The ResNet towers and CLIPX_COMPUTE=int8 refuse tp with clipx's
    messages."""
    model = "tiny-rn-test" if case == "resnet" else "tiny-test"
    if case == "int8":
        monkeypatch.setenv("CLIPX_COMPUTE", "int8")
    cfg, jc = tcfg.get_config(model), jcfg.get_config(model)
    tree = tconvert.init_params(cfg, 0)
    with pytest.raises(ValueError) as ref:
        JEncoder(jc, jax.tree_util.tree_map(jnp.asarray, tree),
                 mesh=_jmesh(), tp="tp")
    with pytest.raises(ValueError) as ours:
        TEncoder(cfg, tree, mesh=_tmesh(), tp="tp")
    assert str(ours.value) == str(ref.value)


# -- the dp x tp train step ----------------------------------------------------

class _Recording(ttrain.AdamW):
    """AdamW that keeps a copy of the gradients it is given (before its
    clip), one list a tree it updates."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seen = []

    def update(self, grads, state, params, norm=None):
        self.seen.append((params, [g.clone() for g in grads]))
        return super().update(grads, state, params, norm)


def _sharded(model, tree, mesh, warmup=1, total=3, remat=False,
             tx_cls=ttrain.AdamW):
    cfg = tcfg.get_config(model)
    base = ttrain.make_optimizer(LR, 0.02, warmup, total)
    tx = tx_cls(base.schedule, weight_decay=0.02)
    state, _ = ttrain.create_train_state(cfg, tx=tx, device="cpu",
                                         params=tree)
    step, shard_state, split = ttrain.make_sharded_train_step(
        cfg, tx, mesh, remat=remat)
    return shard_state(state), step, split, tx


def _gathered_grads(sharded, seen):
    """The sharded step's gradient, leaf by leaf, whole: each leaf's tp
    slices (one tree a tp column) joined."""
    first = {}
    for tree, grads in seen:
        for pos in range(sharded.mesh.size):
            if sharded.trees[pos] is tree:
                first.setdefault(sharded.column(pos), grads)
    names = list(tconvert._flatten(sharded.trees[0]).keys())
    parts = [dict(zip(names, first[j])) for j in range(sharded.tp_size)]
    flags = ttrain._sharded_flags(sharded.trees[0], sharded.specs, sharded.tp)
    out = {}
    for (name, grad), is_sharded in zip(parts[0].items(), flags):
        if not is_sharded:
            out[name] = grad.numpy()
            continue
        spec = sharded.specs
        for key in name.split("/"):
            spec = spec[key]
        dim = spec.index(sharded.tp)
        out[name] = torch.cat([p[name] for p in parts], dim=dim).numpy()
    return out


def _replicas_equal(sharded):
    """Every leaf of every tree equals that of another tree of its tp
    column bitwise, and every replicated leaf equals column 0's."""
    trees = [t for _, t in sharded.placements()]
    ref = _flat(trees[0])
    flags = ttrain._sharded_flags(sharded.trees[0], sharded.specs, sharded.tp)
    for t in trees[1:]:
        other = _flat(t)
        for (key, val), is_sharded in zip(ref.items(), flags):
            if not is_sharded:
                np.testing.assert_array_equal(other[key], val, err_msg=key)


@pytest.mark.parametrize("model", ["tiny-test", "tiny-rn-test"])
def test_sharded_step_matches_clipx(model):
    """The dp 4 x tp 2 step against clipx's make_sharded_train_step on its
    dp 4 x tp 2 mesh: the first step's loss and each leaf's gradient
    (against jax.grad of the whole batch's loss), then every parameter's
    update after three steps; the replicated leaves bitwise equal across
    the port's replicas."""
    cfg, jc = tcfg.get_config(model), jcfg.get_config(model)
    tree = tconvert.init_params(cfg, 0)
    batches = [_batch(model, seed) for seed in (1, 2, 3)]
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtrain.contrastive_loss(
            p, jc, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]),
            attn_impl="plain"),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    jm = _jmesh()
    jtx = jtrain.make_optimizer(LR, 0.02, 1, 3)
    jstate = jtrain.TrainState(jax.tree_util.tree_map(jnp.asarray, tree),
                               jtx.init(tree), jnp.zeros((), jnp.int32))
    jstep, jshard, bsh = jtrain.make_sharded_train_step(jc, jtx, jm)
    jlosses = []
    for px, ids in batches:
        # placed by shard_state before every step: one compile of the step
        jstate, m = jstep(jshard(jstate), jax.device_put(px, bsh),
                          jax.device_put(ids, bsh))
        jlosses.append(float(m["loss"]))
    jparams = tconvert._flatten(jax.tree_util.tree_map(np.asarray,
                                                       jstate.params))

    state, step, split, tx = _sharded(model, tree, _tmesh(),
                                      tx_cls=_Recording)
    losses = []
    for i, (px, ids) in enumerate(batches):
        state, m = step(state, *split(px, ids))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = _gathered_grads(state.params, tx.seen)
    np.testing.assert_allclose(losses[0], float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    jflat = tconvert._flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert set(jflat) == set(grads)
    top = max(float(np.abs(ref).max()) for ref in jflat.values())
    for key, ref in jflat.items():
        scale = max(float(np.abs(ref).max()), GRAD_FLOOR * top)
        np.testing.assert_allclose(grads[key], ref, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=key)
    assert state.step == 3 and state.opt_state.count == 3
    ours = _flat(state.params.gather())
    init = tconvert._flatten(tree)
    for key in jparams:
        np.testing.assert_allclose(ours[key] - init[key],
                                   jparams[key] - init[key], rtol=0,
                                   atol=STEP_ATOL, err_msg=key)
    _replicas_equal(state.params)
    _replicas_equal(state.opt_state.mu)


def test_sharded_step_at_dp_1_tp_2_matches_the_single_device_step():
    """tp alone (one dp row of two positions): three steps within STEP_ATOL
    of the port's single-device step, the losses within LOSS_RTOL."""
    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    batches = [_batch("tiny-test", seed) for seed in (1, 2, 3)]
    state, step, split, _ = _sharded("tiny-test", tree, _tmesh(1, 2))
    single, tx = ttrain.create_train_state(
        cfg, tx=ttrain.make_optimizer(LR, 0.02, 1, 3), device="cpu",
        params=tree)
    one = ttrain.make_train_step(cfg, tx)
    for px, ids in batches:
        state, m = step(state, *split(px, ids))
        single, m1 = one(single, torch.from_numpy(px), torch.from_numpy(ids))
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                                   rtol=LOSS_RTOL)
    ours, ref = _flat(state.params.gather()), _flat(single.params)
    init = tconvert._flatten(tree)
    for key in ref:
        np.testing.assert_allclose(ours[key] - init[key],
                                   ref[key] - init[key], rtol=0,
                                   atol=STEP_ATOL, err_msg=key)


def test_remat_under_dp_tp_gives_the_same_loss_and_params():
    """--remat recomputes each block (its collectives included) in the
    backward pass: the same losses and parameters bit for bit."""
    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    batches = [_batch("tiny-test", seed) for seed in (1, 2)]
    runs = []
    for remat in (False, True):
        state, step, split, _ = _sharded("tiny-test", tree, _tmesh(2, 2),
                                         remat=remat)
        losses = []
        for px, ids in batches:
            state, m = step(state, *split(px, ids))
            losses.append(float(m["loss"]))
        runs.append((losses, _flat(state.params.gather())))
    assert runs[0][0] == runs[1][0]
    for key, val in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][key], val, err_msg=key)


def test_shard_state_preserves_opt_state():
    """clipx's test_shard_state_preserves_opt_state: a state with trained
    moments and a count goes through shard_state and back bitwise (the
    count and the step kept, so --resume keeps its warmup place)."""
    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    state, tx = ttrain.create_train_state(
        cfg, tx=ttrain.make_optimizer(LR, 0.02, 1, 5), device="cpu",
        params=tree)
    one = ttrain.make_train_step(cfg, tx)
    for seed in (1, 2):
        px, ids = _batch("tiny-test", seed)
        state, _ = one(state, torch.from_numpy(px), torch.from_numpy(ids))
    _, shard_state, _ = ttrain.make_sharded_train_step(cfg, tx, _tmesh())
    sharded = shard_state(state)
    assert sharded.step == 2 and sharded.opt_state.count == 2
    back = ttrain.unshard_state(sharded)
    for part in ("mu", "nu"):
        a = _flat(getattr(state.opt_state, part))
        b = _flat(getattr(back.opt_state, part))
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert back.step == 2 and back.opt_state.count == 2


@pytest.mark.parametrize("model", ["tiny-test", "tiny-rn-test"])
def test_checkpoints_cross_between_dp_tp_and_one_device(model, tmp_path):
    """A dp x tp checkpoint restores bitwise into a single-device state,
    and a single-device one into a dp x tp state (through unshard_state's
    template, as the CLI's --resume does); params.npz of a sharded state is
    the whole tree in clipx's layout."""
    cfg = tcfg.get_config(model)
    tree = tconvert.init_params(cfg, 0)
    state, step, split, tx = _sharded(model, tree, _tmesh(), total=5)
    for seed in (1, 2):
        state, _ = step(state, *split(*_batch(model, seed)))
    path = str(tmp_path / "latest")
    ttrain.save_train_state(path, state)
    fresh, _ = ttrain.create_train_state(cfg, tx=tx, device="cpu",
                                         params=tconvert.init_params(cfg, 5))
    one = ttrain.restore_train_state(path, fresh)
    whole = ttrain.unshard_state(state)
    assert one.step == 2 and one.opt_state.count == 2
    for a, b in ((one.params, whole.params), (one.opt_state.mu,
                                              whole.opt_state.mu),
                 (one.opt_state.nu, whole.opt_state.nu)):
        fa, fb = _flat(a), _flat(b)
        for key in fb:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
    # the reverse: one device's checkpoint into the dp x tp layout
    single_path = str(tmp_path / "single")
    ttrain.save_train_state(single_path, one)
    _, shard_state, _ = ttrain.make_sharded_train_step(cfg, tx, _tmesh())
    other, _, _, _ = _sharded(model, tconvert.init_params(cfg, 7), _tmesh())
    back = shard_state(ttrain.restore_train_state(
        single_path, ttrain.unshard_state(other)))
    assert back.step == 2 and back.opt_state.count == 2
    fb, fw = _flat(back.params.gather()), _flat(whole.params)
    for key in fw:
        np.testing.assert_array_equal(fb[key], fw[key], err_msg=key)
    out = str(tmp_path / "params.npz")
    ttrain.save_params(out, state.params)
    saved = tconvert.load_params(out)
    for key, val in tconvert._flatten(saved).items():
        np.testing.assert_array_equal(val, fw[key], err_msg=key)


# -- split heads: a tp size that does not divide the heads ---------------------
#
# tiny-test has 2 heads of 32 in each tower: over {"dp": 2, "tp": 4} each
# position holds half a head, over {"dp": 1, "tp": 8} a quarter. clipx's
# GSPMD runs both from the same column and row specs; the port gathers q, k
# and v over the row (tp_gather) and each position attends over the heads
# its columns overlap. The tolerances are those of the whole-heads cases.

SPLIT = [(2, 4), (1, 8)]
SPLIT_IDS = ["dp2xtp4", "dp1xtp8"]


@pytest.mark.parametrize("dp,tp", SPLIT, ids=SPLIT_IDS)
def test_split_head_shards_round_trip(dp, tp):
    """shard_params gives tp column j the columns j W/tp ... (j+1) W/tp of
    wq/wk/wv/w1 and their biases and those rows of wo/w2 (clipx's specs,
    part of a head each); gather() gives the tree back bitwise."""
    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    sh = tmesh.shard_params(tree, _tmesh(dp, tp))
    assert len(sh.placements()) == tp
    flat = tconvert._flatten(tree)
    for j in range(tp):
        part = _flat(sh.trees[j])
        for key, val in flat.items():
            spec = sh.specs
            for name in key.split("/"):
                spec = spec[name]
            if "tp" not in spec:
                np.testing.assert_array_equal(part[key], val, err_msg=key)
                continue
            dim = spec.index("tp")
            size = val.shape[dim] // tp
            np.testing.assert_array_equal(
                part[key], np.take(val, range(j * size, (j + 1) * size),
                                   axis=dim), err_msg=key)
    back = _flat(sh.gather())
    for key, val in flat.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)


@pytest.mark.parametrize("dp,tp", SPLIT, ids=SPLIT_IDS)
def test_split_head_tp_encode_matches_clipx(dp, tp):
    """Each dp row's share through the split-head TP forward against
    clipx's jit of encode_image/encode_text over its TP-sharded params on
    the same mesh (2e-4, as test_tp_encode_matches_clipx); every position
    of a row gets the same bits."""
    cfg = tcfg.get_config("tiny-test")
    jc = jcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    pixels, ids = _batch("tiny-test")
    jm = _jmesh(dp, tp)
    jparams = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jm)
    bsh = jmesh.batch_sharding(jm)
    ref_img = np.asarray(jax.jit(lambda p, x: jclip.encode_image(p, jc, x))(
        jparams, jax.device_put(pixels, bsh)))
    ref_txt = np.asarray(jax.jit(lambda p, x: jclip.encode_text(p, jc, x))(
        jparams, jax.device_put(ids, bsh)))
    mesh = _tmesh(dp, tp)
    sh = tmesh.shard_params(tree, mesh)
    share = BATCH // dp
    img, txt = [], []
    for i, row in enumerate(mesh.groups("tp")):
        g = Group(mesh, row)
        trees = [sh.trees[p] for p in row]
        rows_of = slice(share * i, share * (i + 1))
        px = [torch.from_numpy(pixels[rows_of])] * tp
        ti = [torch.from_numpy(ids[rows_of])] * tp
        a = ttensor.encode_image(trees, cfg, px, g)
        b = ttensor.encode_text(trees, cfg, ti, g)
        assert all(torch.equal(a[0], x) for x in a)
        assert all(torch.equal(b[0], x) for x in b)
        img.append(a[0].numpy())
        txt.append(b[0].numpy())
    np.testing.assert_allclose(np.concatenate(img), ref_img, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(np.concatenate(txt), ref_txt, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dp,tp", SPLIT, ids=SPLIT_IDS)
def test_split_head_encoder_matches_clipx_single_device(dp, tp):
    """Encoder(mesh=..., tp="tp") at a tp size that splits the heads
    against clipx's single-device Encoder (2e-5 / 2e-6, as
    test_encoder_dp_tp_matches_clipx_single_device), images and texts."""
    cfg = tcfg.get_config("tiny-test")
    jc = jcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 1)
    single = JEncoder(jc, jax.tree_util.tree_map(jnp.asarray, tree))
    enc = TEncoder(cfg, tree, mesh=_tmesh(dp, tp), tp="tp")
    assert enc.attn_impl == "plain"
    rng = np.random.RandomState(2)
    s = cfg.vision.image_size
    batch = rng.randint(0, 256, (5, s, s, 3), dtype=np.uint8)
    np.testing.assert_allclose(enc.encode_images(batch),
                               single.encode_images(batch),
                               rtol=2e-5, atol=2e-6)
    texts = ["a red square", "blue sky over a city"]
    np.testing.assert_allclose(enc.encode_texts(texts),
                               single.encode_texts(texts),
                               rtol=2e-5, atol=2e-6)


def _clipx_grads(tree, batch):
    jc = jcfg.get_config("tiny-test")
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.contrastive_loss(
            p, jc, jnp.asarray(batch[0]), jnp.asarray(batch[1]),
            attn_impl="plain"),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    return float(loss), tconvert._flatten(
        jax.tree_util.tree_map(np.asarray, grads))


def _grad_error(ours, ref):
    """Each leaf's largest |ours - ref| over its GRAD_TOL bound (the scale
    of test_sharded_step_matches_clipx): at most 1 where they agree."""
    top = max(float(np.abs(r).max()) for r in ref.values())
    return {key: float(np.abs(ours[key] - r).max()) / (
        GRAD_TOL * max(float(np.abs(r).max()), GRAD_FLOOR * top))
        for key, r in ref.items()}


@pytest.mark.parametrize("dp,tp", SPLIT, ids=SPLIT_IDS)
def test_split_head_sharded_step_matches_clipx(dp, tp):
    """The split-head step against clipx's make_sharded_train_step on the
    same mesh: the first loss and each leaf's gradient (against jax.grad
    of the whole batch's loss), every parameter's update after three
    steps; replicated leaves and moments bitwise across replicas."""
    cfg = tcfg.get_config("tiny-test")
    jc = jcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    batches = [_batch("tiny-test", seed) for seed in (1, 2, 3)]
    jloss, jflat = _clipx_grads(tree, batches[0])
    jm = _jmesh(dp, tp)
    jtx = jtrain.make_optimizer(LR, 0.02, 1, 3)
    jstate = jtrain.TrainState(jax.tree_util.tree_map(jnp.asarray, tree),
                               jtx.init(tree), jnp.zeros((), jnp.int32))
    jstep, jshard, bsh = jtrain.make_sharded_train_step(jc, jtx, jm)
    jlosses = []
    for px, ids in batches:
        jstate, m = jstep(jshard(jstate), jax.device_put(px, bsh),
                          jax.device_put(ids, bsh))
        jlosses.append(float(m["loss"]))
    jparams = tconvert._flatten(jax.tree_util.tree_map(np.asarray,
                                                       jstate.params))

    state, step, split, tx = _sharded("tiny-test", tree, _tmesh(dp, tp),
                                      tx_cls=_Recording)
    losses = []
    for i, (px, ids) in enumerate(batches):
        state, m = step(state, *split(px, ids))
        losses.append(float(m["loss"]))
        if i == 0:
            grads = _gathered_grads(state.params, tx.seen)
    np.testing.assert_allclose(losses[0], jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert set(jflat) == set(grads)
    worst = _grad_error(grads, jflat)
    assert max(worst.values()) <= 1.0, worst
    init = tconvert._flatten(tree)
    ours = _flat(state.params.gather())
    for key in jparams:
        np.testing.assert_allclose(ours[key] - init[key],
                                   jparams[key] - init[key], rtol=0,
                                   atol=STEP_ATOL, err_msg=key)
    _replicas_equal(state.params)
    _replicas_equal(state.opt_state.mu)


def test_split_head_backward_sums_the_row_before_slicing(monkeypatch):
    """At dp 1 x tp 4 head 0 spans positions 0 and 1, and each computes it
    for its own half of the output columns. tp_gather's backward (the sum
    over the row, then each position's slice) gives the q/k/v gradients
    of jax.grad; gather's backward (each position's slice of its own
    gradient only) loses the other position's share of that head, and the
    gradients of wq/wk/wv leave GRAD_TOL by far."""
    tree = tconvert.init_params(tcfg.get_config("tiny-test"), 0)
    batch = _batch("tiny-test", 1)
    _, ref = _clipx_grads(tree, batch)

    def grads():
        state, step, split, tx = _sharded("tiny-test", tree, _tmesh(1, 4),
                                          tx_cls=_Recording)
        state, _ = step(state, *split(*batch))
        return _grad_error(_gathered_grads(state.params, tx.seen), ref)

    good = grads()
    assert max(good.values()) <= 1.0, good
    monkeypatch.setattr(ttensor, "tp_gather", ttensor.gather)
    bad = grads()
    for tower in ("visual", "text"):
        for w in ("wq", "wk", "wv"):
            assert bad[f"{tower}/blocks/attn/{w}"] > 10.0, bad


@pytest.mark.parametrize("dp,tp", SPLIT, ids=SPLIT_IDS)
def test_split_head_remat_and_checkpoints(dp, tp, tmp_path):
    """--remat under split heads gives the same losses and params bit for
    bit; the trained state's checkpoint restores bitwise into one device
    and back into the split layout, and params.npz is the whole tree."""
    cfg = tcfg.get_config("tiny-test")
    tree = tconvert.init_params(cfg, 0)
    batches = [_batch("tiny-test", seed) for seed in (1, 2)]
    runs = []
    for remat in (False, True):
        state, step, split, tx = _sharded("tiny-test", tree, _tmesh(dp, tp),
                                          remat=remat, total=5)
        losses = []
        for px, ids in batches:
            state, m = step(state, *split(px, ids))
            losses.append(float(m["loss"]))
        runs.append((losses, _flat(state.params.gather())))
    assert runs[0][0] == runs[1][0]
    for key, val in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][key], val, err_msg=key)

    path = str(tmp_path / "latest")
    ttrain.save_train_state(path, state)
    whole = ttrain.unshard_state(state)
    fresh, _ = ttrain.create_train_state(cfg, tx=tx, device="cpu",
                                         params=tconvert.init_params(cfg, 5))
    one = ttrain.restore_train_state(path, fresh)
    assert one.step == 2 and one.opt_state.count == 2
    for a, b in ((one.params, whole.params), (one.opt_state.mu,
                                              whole.opt_state.mu),
                 (one.opt_state.nu, whole.opt_state.nu)):
        fa, fb = _flat(a), _flat(b)
        for key in fb:
            np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
    _, shard_state, _ = ttrain.make_sharded_train_step(cfg, tx,
                                                       _tmesh(dp, tp))
    back = shard_state(one)
    fb, fw = _flat(back.params.gather()), _flat(whole.params)
    for key in fw:
        np.testing.assert_array_equal(fb[key], fw[key], err_msg=key)
    out = str(tmp_path / "params.npz")
    ttrain.save_params(out, state.params)
    for key, val in tconvert._flatten(tconvert.load_params(out)).items():
        np.testing.assert_array_equal(val, fw[key], err_msg=key)
