"""CLIP contrastive training on one device (PyTorch).

Counterpart of the single-device parts of ``clipx/train.py``: the symmetric
InfoNCE loss, clipx's optimizer chain, the train state and the train step.
clipx's dp x tp step (``make_sharded_train_step``) belongs to the
multi-device port.

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

Checkpoints: clipx writes an orbax directory; the port writes one ``.npz``
file (numpy arrays only, nothing pickled) holding the params, both Adam
moments, the optimizer's count and the step, atomically (a temporary file,
then ``os.replace``). Reading clipx's orbax directory needs JAX, so it is
refused with ``CheckpointFormatError``.
"""

from __future__ import annotations

import math
import os
import zipfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from clipx_torch.config import CLIPConfig
from clipx_torch.models import clip as model_lib
from clipx_torch.models import convert
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
    scale = torch.exp(torch.clamp(params["logit_scale"].float(),
                                  max=LOGIT_SCALE_MAX))
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
    def clip(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.clip_by_global_norm in place; returns the global norm,
        from each leaf's ``square().sum()``: a pairwise sum on the CPU,
        where PyTorch's f32 ``vector_norm`` and ``_foreach_norm`` add in
        order and come out ~1e-3 low at 28 M elements (a ViT-B/32 MLP
        stack)."""
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one,
                                               one * self.max_norm))
        return norm

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamWState,
               params: Params) -> Tuple[AdamWState, torch.Tensor]:
        """Apply one update to ``params`` (in place) from ``grads`` (the
        leaves' gradients in ``tree_leaves`` order, clipped in place).
        Returns the new state and the global norm before the clip."""
        p = tree_leaves(params)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        norm = self.clip(grads)
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
# checkpoints
# ---------------------------------------------------------------------------

class CheckpointFormatError(ValueError):
    """A path that holds no checkpoint of this package's format."""


def save_train_state(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` as one ``.npz`` (``CKPT_FORMAT``), through
    a temporary file that replaces ``path`` once it is complete on disk."""
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
