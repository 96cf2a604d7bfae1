"""Seeded SigLIP parameters made on the device: the inputs of the SigLIP
cells.

The tree has the port's SigLIP layout (``clipx_torch.models.convert``'s
``from_siglip_state_dict``): ``x @ W`` weights (in, out), the patch
embedding a (p*p*3, W) matrix over (ph, pw, channel) patches with its bias,
each tower's blocks stacked along a leading layer axis, the pooling head
(``map_head``: probe, q/k/v/out, LayerNorm, MLP) and the text ``head``.
As in ``weights.py``: every leaf comes from one ``torch.randn`` call on the
device, in f32, then scaled to OpenAI CLIP's initialisation stds, with small
random biases and LayerNorm parameters, so that a bias, a LayerNorm or the
head's MLP dropped on the timed path shows in the outputs. The same seed on
the same device gives the same tree.
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import BIAS_STD, LN_BIAS_STD, LN_SCALE_STD


def _leaves(vision: dict, text: dict):
    """(path, shape, kind, std) of every leaf, in a fixed order."""
    out = []

    def ln(path, shape):
        out.append((path + ("scale",), shape, "ln_scale", 0))
        out.append((path + ("bias",), shape, "bias", 0))

    def attn_mlp(prefix, lead, w, hidden, layers):
        attn_std = w ** -0.5
        proj_std = w ** -0.5 * (2 * layers) ** -0.5
        fc_std = (2 * w) ** -0.5
        for name in ("wq", "wk", "wv"):
            out.append((prefix + ("attn", name), lead + (w, w), "w",
                        attn_std))
        out.append((prefix + ("attn", "wo"), lead + (w, w), "w", proj_std))
        for name in ("bq", "bk", "bv", "bo"):
            out.append((prefix + ("attn", name), lead + (w,), "bias", 0))
        out.append((prefix + ("mlp", "w1"), lead + (w, hidden), "w", fc_std))
        out.append((prefix + ("mlp", "b1"), lead + (hidden,), "bias", 0))
        out.append((prefix + ("mlp", "w2"), lead + (hidden, w), "w",
                    proj_std))
        out.append((prefix + ("mlp", "b2"), lead + (w,), "bias", 0))

    def blocks(prefix, layers, w, hidden):
        for name in ("ln_1", "ln_2"):
            ln(prefix + (name,), (layers, w))
        attn_mlp(prefix, (layers,), w, hidden, layers)

    w, p = vision["width"], vision["patch_size"]
    seq = (vision["image_size"] // p) ** 2
    v = ("visual",)
    out.append((v + ("patch_embed", "kernel"), (p * p * 3, w), "w", w ** -0.5))
    out.append((v + ("patch_embed", "bias"), (w,), "bias", 0))
    out.append((v + ("pos_embedding",), (seq, w), "w", w ** -0.5))
    blocks(v + ("blocks",), vision["layers"], w, vision["mlp_dim"])
    ln(v + ("ln_post",), (w,))
    h = v + ("map_head",)
    out.append((h + ("probe",), (1, 1, w), "w", w ** -0.5))
    attn_mlp(h, (), w, vision["mlp_dim"], 1)
    ln(h + ("ln",), (w,))
    tw = text["width"]
    t = ("text",)
    out.append((t + ("token_embedding",), (text["vocab_size"], tw), "w",
                0.02))
    out.append((t + ("pos_embedding",), (text["context_length"], tw), "w",
                0.01))
    blocks(t + ("blocks",), text["layers"], tw, text["mlp_dim"])
    ln(t + ("ln_final",), (tw,))
    out.append((t + ("head", "kernel"), (tw, text["embed_dim"]), "w",
                tw ** -0.5))
    out.append((t + ("head", "bias"), (text["embed_dim"],), "bias", 0))
    return out


def make_params(config: dict, seed: int, device) -> dict:
    """The nested f32 parameter tree of ``config`` (a SigLIP configuration
    file's ``vision`` and ``text`` groups) on ``device``, from ``seed``."""
    leaves = _leaves(config["vision"], config["text"])
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, shape, kind, std in leaves:
        n = math.prod(shape)
        leaf = flat[off: off + n].view(shape)
        off += n
        if kind == "w":
            leaf.mul_(std)
        elif kind == "bias":
            leaf.mul_(LN_BIAS_STD if path[-2].startswith("ln")
                      else BIAS_STD)
        else:  # ln_scale
            leaf.mul_(LN_SCALE_STD).add_(1.0)
        if len(shape) < 2:
            # the program keeps 1-D leaves as they are: give it its own
            # storage, so the large buffer goes once the program has cast
            # the matrices
            leaf = leaf.clone()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    tree["logit_scale"] = torch.tensor(math.log(10.0), device=device)
    tree["logit_bias"] = torch.tensor(-10.0, device=device)
    return tree
