"""CLIP contrastive training on one device or a dp x tp mesh (PyTorch).

Counterpart of ``clipx/train.py``: the symmetric InfoNCE loss, clipx's
optimizer chain, the train state, the single-device train step and the
sharded one (``make_sharded_train_step``: the batch split over ``dp``, the
ViT params over ``tp`` by ``parallel/mesh.py``'s specs, the forward of
``parallel/tensor.py``).

Loss: ``(ce(logits_per_image) + ce(logits_per_text)) / 2`` over
``scale * img @ txt.T`` with labels on the diagonal, ``scale =
exp(min(logit_scale, log 100))``, cross-entropy in f32.

Optimizer: optax's ``chain(clip_by_global_norm(1.0), adamw(warmup_cosine,
b1=0.9, b2=0.98, eps=1e-6, weight_decay))``, written with
``torch._foreach_*`` ops so that its numbers are optax's:

- the schedule is read at the count *before* the update, so the first
  update has lr = 0 and moves no parameter (weight decay included) while
  the Adam moments still take the first gradient;
- the clip scales by ``max_norm / ||g||`` only when ``||g|| >= max_norm``,
  with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- weight decay reaches every leaf (optax's mask is None): biases,
  LayerNorms, embeddings and ``logit_scale``, as ``-lr * (adam + wd * p)``.

The step is eager autograd over the port's tree of leaf tensors, in f32
with TF32 off (``runtime.device.full_f32``, cuBLAS and cuDNN). Like
clipx's it takes ``attn_impl="plain"``, which keeps every fused kernel off
the path: the kernels have no backward, and their wrappers refuse an input
that requires grad (``ops._launch.refuse_grad``).

The sharded step computes clipx's loss over the *global* batch: each dp
row encodes its share over its tp positions, the embeddings are gathered
over dp (the global negatives), and every position computes the same (B,
B) loss; each collective's backward is the one that keeps the gradient of
that one loss (``parallel/distributed.py``). Each position's gradient is
then summed over its dp column in mesh order, the global norm counts each
sharded leaf's slices once and each replicated leaf once, and AdamW
updates every distinct (device, tp column) tree with the same numbers, so
replicas stay bitwise equal. Like clipx's it keeps every kernel off the
path (plain attention). The ResNet towers ignore ``tp``: their params are
replicated and only the batch is split.

Checkpoints: clipx writes an orbax directory; the port writes one ``.npz``
file (numpy arrays only, nothing pickled) holding the params, both Adam
moments, the optimizer's count and the step, atomically (a temporary file,
then ``os.replace``). Reading clipx's orbax directory needs JAX, so it is
refused with ``CheckpointFormatError``. A sharded state is gathered whole
first (``unshard_state``), in clipx's layout, and written by process 0
while the others wait.
"""

from __future__ import annotations

import math
import os
import zipfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from clipx_torch.config import CLIPConfig
from clipx_torch.models import clip as model_lib
from clipx_torch.models import convert
from clipx_torch.parallel import distributed as dist_lib
from clipx_torch.parallel import mesh as mesh_lib
from clipx_torch.parallel import tensor as tensor_lib
from clipx_torch.runtime.device import full_f32, resolve_device

Params = Dict[str, Any]

LOGIT_SCALE_MAX = math.log(100.0)
CKPT_FORMAT = "clipx_torch-train-1"


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The leaves of a nested dict in insertion order (the order every tree
    built from the same params shares)."""
    out = []
    for val in tree.values():
        if isinstance(val, dict):
            out.extend(tree_leaves(val))
        else:
            out.append(val)
    return out


def tree_map(fn: Callable, tree: Params) -> Params:
    return {key: (tree_map(fn, val) if isinstance(val, dict) else fn(val))
            for key, val in tree.items()}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def contrastive_loss(params: Params, cfg: CLIPConfig, pixels: torch.Tensor,
                     token_ids: torch.Tensor, *,
                     dtype: torch.dtype = torch.float32, remat: bool = False,
                     attn_impl: str = "plain"):
    """(loss, metrics) of one batch: symmetric InfoNCE, the metrics
    ``loss``, ``accuracy`` (row argmax == label) and ``logit_scale`` (the
    clamped, exponentiated scale), as detached tensors."""
    img = model_lib.encode_image(params, cfg, pixels, normalize=True,
                                 dtype=dtype, remat=remat,
                                 attn_impl=attn_impl)
    txt = model_lib.encode_text(params, cfg, token_ids, normalize=True,
                                dtype=dtype, remat=remat,
                                attn_impl=attn_impl)
    return _clip_loss(img, txt, params["logit_scale"])


def _clip_loss(img: torch.Tensor, txt: torch.Tensor,
               logit_scale: torch.Tensor):
    """``contrastive_loss`` from the normalized embeddings."""
    scale = torch.exp(torch.clamp(logit_scale.float(), max=LOGIT_SCALE_MAX))
    logits = scale * img @ txt.T                      # (B, B)
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = F.cross_entropy(logits, labels, reduction="none")
    lt = F.cross_entropy(logits.T, labels, reduction="none")
    loss = 0.5 * (li.mean() + lt.mean())
    accuracy = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss.detach(), "accuracy": accuracy.detach(),
                  "logit_scale": scale.detach()}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def warmup_cosine_schedule(peak: float, warmup_steps: int,
                           decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps) with end value 0: linear from 0 to ``peak`` over the
    warmup, then a half cosine to 0 at ``decay_steps``, flat after."""
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        c = min(count - warmup_steps, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / span))

    return schedule


class AdamWState(NamedTuple):
    count: int       # updates made so far: the schedule's step
    mu: Params
    nu: Params


class AdamW:
    """clipx's optimizer chain (the module docstring's three rules) on a
    tree of leaf tensors, updated in place with ``torch._foreach_*`` ops.
    The clip and the update stay on the device: the global norm decides
    through ``torch.where``, so a step waits for nothing on the host."""

    def __init__(self, schedule: Callable[[int], float], *,
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        self.schedule = schedule
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Params) -> AdamWState:
        # zeros_like keeps each leaf's strides (the ResNet conv kernels'
        # stored permutation), so the foreach updates pair like with like
        return AdamWState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def clip(self, grads: List[torch.Tensor],
             norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """optax.clip_by_global_norm in place; returns the global norm,
        from each leaf's ``square().sum()``: a pairwise sum on the CPU,
        where PyTorch's f32 ``vector_norm`` and ``_foreach_norm`` add in
        order and come out ~1e-3 low at 28 M elements (a ViT-B/32 MLP
        stack). A given ``norm`` (the sharded step's, over every shard) is
        used as it is."""
        if norm is None:
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one,
                                               one * self.max_norm))
        return norm

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamWState,
               params: Params, norm: Optional[torch.Tensor] = None
               ) -> Tuple[AdamWState, torch.Tensor]:
        """Apply one update to ``params`` (in place) from ``grads`` (the
        leaves' gradients in ``tree_leaves`` order, clipped in place by
        ``norm``, or by their own global norm). Returns the new state and
        the global norm before the clip."""
        p = tree_leaves(params)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        norm = self.clip(grads, norm)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        count = state.count + 1
        # optax's bias corrections, in f32 as it computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(state.count))
        torch._foreach_add_(p, upd)
        return AdamWState(count, state.mu, state.nu), norm


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.02,
                   warmup_steps: int = 200,
                   total_steps: int = 10_000) -> AdamW:
    """clipx's ``make_optimizer``: the clip at 1.0, then AdamW(b1 0.9, b2
    0.98, eps 1e-6) on the warmup-cosine schedule to ``max(total_steps,
    warmup_steps + 1)``."""
    return AdamW(warmup_cosine_schedule(
        learning_rate, warmup_steps, max(total_steps, warmup_steps + 1)),
        weight_decay=weight_decay)


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Params
    opt_state: AdamWState
    step: int


def trainable_params(tree: Params, device=None) -> Params:
    """clipx's numpy param tree -> the port's f32 leaf tensors on
    ``device``, each requiring grad (``from_jax_params``' layout: the ResNet
    conv kernels are views of their stored permutation, so the optimizer's
    in-place updates land in that storage)."""
    params = convert.from_jax_params(tree, device=resolve_device(device),
                                     dtype=torch.float32)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def create_train_state(cfg: CLIPConfig, seed: int = 0,
                       tx: Optional[AdamW] = None, *, device=None,
                       params: Optional[Params] = None
                       ) -> Tuple[TrainState, AdamW]:
    """A fresh state: ``params`` (clipx's numpy tree, e.g. a loaded
    ``.npz``) or the port's seeded numpy init (``convert.init_params``,
    not JAX's PRNG: the two packages' random inits differ)."""
    tx = tx or make_optimizer()
    if params is None:
        params = convert.init_params(cfg, seed)
    tree = trainable_params(params, device)
    return TrainState(tree, tx.init(tree), 0), tx


def make_train_step(cfg: CLIPConfig, tx: AdamW, *,
                    dtype: torch.dtype = torch.float32, remat: bool = False,
                    attn_impl: str = "plain"):
    """A (state, pixels, token_ids) -> (state, metrics) step. The params
    and moments are updated in place; the metrics (``contrastive_loss``'s
    and ``grad_norm``, the global norm before the clip) stay on the
    device until read."""

    def step(state: TrainState, pixels: torch.Tensor,
             token_ids: torch.Tensor):
        leaves = tree_leaves(state.params)
        with full_f32(leaves[0].device):
            loss, metrics = contrastive_loss(
                state.params, cfg, pixels, token_ids, dtype=dtype,
                remat=remat, attn_impl=attn_impl)
            grads = list(torch.autograd.grad(loss, leaves))
            opt_state, norm = tx.update(grads, state.opt_state,
                                        state.params)
        metrics["grad_norm"] = norm
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step


# ---------------------------------------------------------------------------
# the sharded step (dp x tp)
# ---------------------------------------------------------------------------

def _sharded_flags(tree: Params, specs: Optional[Params], tp: Optional[str]
                   ) -> List[bool]:
    """For each leaf of ``tree`` in ``tree_leaves`` order: is it sharded
    over ``tp``."""
    out = []
    for key, val in tree.items():
        spec = specs[key] if specs is not None else None
        if isinstance(val, dict):
            out.extend(_sharded_flags(val, spec, tp))
        else:
            out.append(spec is not None and tp in spec)
    return out


def _column_sum(group: dist_lib.Group, parts: List[List[torch.Tensor]]
                ) -> List[torch.Tensor]:
    """The leaves' gradients summed over a dp column: this process's
    positions in mesh order on the first local device, then one
    ``all_reduce`` of them all, flattened, over the column's processes."""
    dev = group.devices[0]
    acc = [g.to(dev) for g in parts[0]]
    for other in parts[1:]:
        torch._foreach_add_(acc, [g.to(dev) for g in other])
    if group.pg is not None:
        flat = torch.cat([g.reshape(-1) for g in acc])
        dist.all_reduce(flat, group=group.pg)
        start = 0
        for g in acc:
            g.copy_(flat[start: start + g.numel()].view(g.shape))
            start += g.numel()
    return acc


def make_sharded_train_step(cfg: CLIPConfig, tx: AdamW, mesh, *,
                            dp: str = "dp", tp: Optional[str] = "tp",
                            dtype: torch.dtype = torch.float32,
                            remat: bool = False):
    """clipx's ``make_sharded_train_step`` over ``mesh`` (a "dp" axis and
    optionally a "tp" one; positions may repeat a device, and may lie in
    several processes). Returns ``(step, shard_state, split_batch)``:

    - ``shard_state(state)``: a whole ``TrainState`` -> the sharded one
      (params, both moments sliced like their params, the count and the
      step kept, so ``--resume`` keeps its place in the schedule);
    - ``split_batch(pixels, ids)``: this process's rows of the global batch
      (those of the dp rows it holds, in order) -> one (pixels, ids) pair a
      local position, each on its device;
    - ``step(state, pixels, ids)`` with ``split_batch``'s lists -> (state,
      metrics), the params and moments updated in place; the metrics
      (``contrastive_loss``'s and ``grad_norm``) those of the first local
      position, equal on every one.

    ResNet towers have no TP rules (RN50 fits a card): their params are
    replicated and ``tp`` is ignored, as in clipx."""
    if dp not in mesh.axis_names or set(mesh.axis_names) - {dp, tp}:
        raise ValueError(f"the train mesh has a {dp!r} axis and at most a "
                         f"{tp!r} one, got {mesh}")
    if getattr(cfg.vision, "tower", "vit") == "resnet":
        tp = None
    if tp is not None and tp not in mesh.axis_names:
        tp = None
    local = mesh.local_positions()
    # the collectives' groups, made in the same order on every process
    rows = ([dist_lib.Group(mesh, r) for r in mesh.groups(tp)] if tp
            else [dist_lib.Group(mesh, [p]) for p in range(mesh.size)])
    cols = [dist_lib.Group(mesh, c) for c in mesh.groups(dp)]
    world = dist_lib.Group(mesh, range(mesh.size))
    rows = [g for g in rows if g.local]
    cols = [g for g in cols if g.local]
    column_of = {p: g for g in cols for p in g.local}
    owner: dict = {}   # tp column -> the first position that holds it
    for pos in range(mesh.size):
        owner.setdefault(mesh.coord(pos, tp) if tp else 0, pos)

    def shard_state(state: TrainState) -> TrainState:
        params = mesh_lib.shard_params(state.params, mesh, tp, cfg=cfg)
        for _, tree in params.placements():
            for leaf in tree_leaves(tree):
                leaf.requires_grad_(True)
        opt = state.opt_state
        return TrainState(params, AdamWState(
            opt.count, mesh_lib.shard_params(opt.mu, mesh, tp),
            mesh_lib.shard_params(opt.nu, mesh, tp)), state.step)

    def split_batch(pixels, ids):
        pixels, ids = torch.as_tensor(pixels), torch.as_tensor(ids)
        held = sorted({mesh.coord(p, dp) for p in local})
        if pixels.shape[0] % len(held):
            raise ValueError(f"batch {pixels.shape[0]} does not split over "
                             f"{len(held)} 'dp' rows")
        if pixels.device.type == "cpu" and any(
                mesh.devices[p].type == "cuda" for p in local):
            pixels, ids = pixels.pin_memory(), ids.pin_memory()
        n = pixels.shape[0] // len(held)
        placed: dict = {}
        out_px, out_ids = [], []
        for p in local:
            k, dev = held.index(mesh.coord(p, dp)), mesh.devices[p]
            if (k, dev) not in placed:
                rows_of = slice(k * n, (k + 1) * n)
                placed[k, dev] = (
                    pixels[rows_of].to(dev, non_blocking=True),
                    ids[rows_of].to(dev, non_blocking=True))
            out_px.append(placed[k, dev][0])
            out_ids.append(placed[k, dev][1])
        return out_px, out_ids

    def embed(trees, pixels, ids, group):
        if tp is None:
            return ([model_lib.encode_image(t, cfg, x, normalize=True,
                                            dtype=dtype, remat=remat,
                                            attn_impl="plain")
                     for t, x in zip(trees, pixels)],
                    [model_lib.encode_text(t, cfg, i, normalize=True,
                                           dtype=dtype, remat=remat,
                                           attn_impl="plain")
                     for t, i in zip(trees, ids)])
        kw = dict(normalize=True, dtype=dtype, remat=remat)
        return (tensor_lib.encode_image(trees, cfg, pixels, group, **kw),
                tensor_lib.encode_text(trees, cfg, ids, group, **kw))

    def step(state: TrainState, pixels, ids):
        params = state.params
        at = {p: i for i, p in enumerate(local)}
        # one alias of its tree a position: each position's gradient comes
        # back on its own, to be summed over the column in mesh order
        alias = {p: tree_map(lambda t: t.view_as(t), params.trees[p])
                 for p in local}
        with full_f32(mesh.devices[local[0]]):  # one device type a mesh
            img, txt = {}, {}
            for g in rows:
                i, t = embed([alias[p] for p in g.local],
                             [pixels[at[p]] for p in g.local],
                             [ids[at[p]] for p in g.local], g)
                img.update(zip(g.local, i))
                txt.update(zip(g.local, t))
            losses, metrics = [], None
            for g in cols:
                gi = dist_lib.gather([img[p] for p in g.local], g, 0)
                gt = dist_lib.gather([txt[p] for p in g.local], g, 0)
                for p, a, b in zip(g.local, gi, gt):
                    # every position computes the whole loss, so the one
                    # leaf used only after the gather takes its gradient
                    # from dp row 0 alone: the column's sum is then exact
                    scale = alias[p]["logit_scale"]
                    if mesh.coord(p, dp):
                        scale = scale.detach()
                    loss, m = _clip_loss(a, b, scale)
                    losses.append(loss)
                    if p == local[0]:
                        metrics = m
            inputs = [leaf for p in local for leaf in tree_leaves(alias[p])]
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(inputs, torch.autograd.grad(
                         losses, inputs, allow_unused=True))]
            del alias, img, txt, losses
            count = len(inputs) // len(local)
            per_pos = {p: list(grads[at[p] * count: (at[p] + 1) * count])
                       for p in local}
            del grads
            with torch.no_grad():
                norm, totals = _reduce_and_norm(params, per_pos)
                opt = state.opt_state
                for pos, tree in params.placements():
                    dev = mesh.devices[pos]
                    tx.update(totals[pos], AdamWState(
                        opt.count, opt.mu.trees[pos], opt.nu.trees[pos]),
                        tree, norm=norm.to(dev))
        metrics["grad_norm"] = norm
        return TrainState(params, AdamWState(
            state.opt_state.count + 1, state.opt_state.mu,
            state.opt_state.nu), state.step + 1), metrics

    def _reduce_and_norm(params, per_pos):
        """Each placement's gradient (its column's sum, a tensor of its
        own) and the global norm: the squared sums of every column's
        gradient, from the process holding the column's first position,
        summed over the processes (each entry comes from one process, so
        every one gets the same bits), then each sharded leaf's columns
        summed and each replicated leaf counted once."""
        sums = {}
        first = params.placements()
        flags = _sharded_flags(first[0][1], params.specs, params.tp)
        dev0 = mesh.devices[local[0]]
        sq = torch.zeros((len(flags), params.tp_size), device=dev0)
        for g in cols:
            sums[id(g)] = _column_sum(g, [per_pos[p] for p in g.local])
            j = params.column(g.positions[0])
            if g.local[0] == g.positions[0] == owner[j]:
                sq[:, j] = torch.stack([t.square().sum()
                                        for t in sums[id(g)]]).to(dev0)
        if world.pg is not None:
            dist.all_reduce(sq, group=world.pg)
        mask = torch.tensor(flags, device=dev0)
        norm = torch.where(mask, sq.sum(dim=1), sq[:, 0]).sum().sqrt()
        totals, used = {}, set()
        for pos, _ in first:
            total = sums[id(column_of[pos])]
            dev = mesh.devices[pos]
            fresh = id(column_of[pos]) not in used and total[0].device == dev
            used.add(id(column_of[pos]))
            totals[pos] = (total if fresh else
                           [t.to(dev, copy=True) for t in total])
        return norm, totals

    return step, shard_state, split_batch


def unshard_state(state: TrainState) -> TrainState:
    """The inverse of ``shard_state``: every leaf of the params and both
    moments whole, as f32 tensors on the CPU in clipx's layout (a template
    for ``restore_train_state``, or what ``save_train_state`` writes). Over
    several processes every process must call it."""
    opt = state.opt_state
    return TrainState(state.params.gather(), AdamWState(
        opt.count, opt.mu.gather(), opt.nu.gather()), state.step)


def _written_by_process_0(mesh, write) -> None:
    """``write()`` on process 0 of ``mesh``'s group; every process waits
    for it."""
    if mesh.rank == 0:
        write()
    if mesh.multi_process:
        dist.barrier()


def save_params(path: str, params) -> None:
    """``convert.save_params`` of a whole tree, or of a sharded one
    gathered whole (every process calls it, process 0 writes)."""
    if isinstance(params, mesh_lib.Sharded):
        full = params.gather()
        _written_by_process_0(params.mesh,
                              lambda: convert.save_params(path, full))
        return
    convert.save_params(path, params)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class CheckpointFormatError(ValueError):
    """A path that holds no checkpoint of this package's format."""


def save_train_state(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` as one ``.npz`` (``CKPT_FORMAT``), through
    a temporary file that replaces ``path`` once it is complete on disk. A
    sharded state is gathered whole first: every process calls this, and
    process 0 writes."""
    if isinstance(state.params, mesh_lib.Sharded):
        full = unshard_state(state)
        _written_by_process_0(state.params.mesh,
                              lambda: save_train_state(path, full))
        return
    flat = {"format": np.array(CKPT_FORMAT),
            "step": np.array(state.step, np.int64),
            "count": np.array(state.opt_state.count, np.int64)}
    for part, tree in (("params", state.params),
                       ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        for key, arr in convert._flatten(tree).items():
            flat[f"{part}/{key}"] = arr
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Load ``path`` into ``template``'s tensors (in place, keeping their
    devices and strides): params, both moments, the optimizer's count and
    the step. Raises ``CheckpointFormatError`` for clipx's orbax directory
    and for any file that is not this format or does not fit the model."""
    if os.path.isdir(path):
        raise CheckpointFormatError(
            f"{path} is a directory: clipx's orbax checkpoint (JAX), which "
            "clipx_torch cannot read. Resume it with python -m "
            "clipx.cli.train, or start the port in another "
            "--checkpoint-dir (its own format is one .npz file)")
    try:
        with np.load(path, allow_pickle=False) as z:
            if "format" not in z.files or str(z["format"]) != CKPT_FORMAT:
                raise CheckpointFormatError(
                    f"{path} is not a clipx_torch training checkpoint "
                    f"(format {CKPT_FORMAT})")
            step, count = int(z["step"]), int(z["count"])
            with torch.no_grad():
                for part, tree in (("params", template.params),
                                   ("mu", template.opt_state.mu),
                                   ("nu", template.opt_state.nu)):
                    _load_tree(z, part, tree, path)
    except (OSError, zipfile.BadZipFile, EOFError) as exc:
        raise CheckpointFormatError(f"{path} is unreadable as a clipx_torch "
                                    f"training checkpoint: {exc}") from None
    return TrainState(template.params,
                      AdamWState(count, template.opt_state.mu,
                                 template.opt_state.nu), step)


def _named_leaves(tree: Params, prefix: str):
    for key, val in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(val, dict):
            yield from _named_leaves(val, name)
        else:
            yield name, val


def _load_tree(z, prefix: str, tree: Params, path: str) -> None:
    for name, dst in _named_leaves(tree, prefix):
        if name not in z.files or tuple(z[name].shape) != tuple(dst.shape):
            raise CheckpointFormatError(
                f"{path} does not fit this model: {name} is missing or has "
                "another shape")
        dst.copy_(torch.from_numpy(z[name]))
