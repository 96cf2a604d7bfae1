"""Seeded CLIP parameters made on the device: the benchmark's inputs.

The tree has clipx's parameter layout (``x @ W`` weights, (in, out); the
patch embedding a (p*p*3, W) matrix over (ph, pw, channel) patches; each
tower's blocks stacked along a leading layer axis), which is what the
port's ``Encoder`` takes. Every leaf comes from one ``torch.randn`` call on
the device, in f32, then scaled: the stds of OpenAI CLIP's initialisation
for the matrices, and small random biases and LayerNorm parameters, so that
a bias or a LayerNorm dropped on the timed path shows in the outputs.
The same seed on the same device gives the same tree; the reference makes
it again for itself rather than reading the program's copy.
"""

from __future__ import annotations

import math

import torch


def _leaves(vision: dict, text: dict):
    """(path, shape, kind, std) of every leaf, in a fixed order."""
    out = []

    def blocks(prefix, layers, w):
        attn_std = w ** -0.5
        proj_std = w ** -0.5 * (2 * layers) ** -0.5
        fc_std = (2 * w) ** -0.5
        for ln in ("ln_1", "ln_2"):
            out.append((prefix + (ln, "scale"), (layers, w), "ln_scale", 0))
            out.append((prefix + (ln, "bias"), (layers, w), "bias", 0))
        for name in ("wq", "wk", "wv"):
            out.append((prefix + ("attn", name), (layers, w, w), "w",
                        attn_std))
        out.append((prefix + ("attn", "wo"), (layers, w, w), "w", proj_std))
        for name in ("bq", "bk", "bv", "bo"):
            out.append((prefix + ("attn", name), (layers, w), "bias", 0))
        out.append((prefix + ("mlp", "w1"), (layers, w, 4 * w), "w", fc_std))
        out.append((prefix + ("mlp", "b1"), (layers, 4 * w), "bias", 0))
        out.append((prefix + ("mlp", "w2"), (layers, 4 * w, w), "w",
                    proj_std))
        out.append((prefix + ("mlp", "b2"), (layers, w), "bias", 0))

    def ln(path, w):
        out.append((path + ("scale",), (w,), "ln_scale", 0))
        out.append((path + ("bias",), (w,), "bias", 0))

    w, p = vision["width"], vision["patch_size"]
    seq = (vision["image_size"] // p) ** 2 + 1
    v = ("visual",)
    out.append((v + ("patch_embed", "kernel"), (p * p * 3, w), "w", w ** -0.5))
    out.append((v + ("class_embedding",), (w,), "w", w ** -0.5))
    out.append((v + ("pos_embedding",), (seq, w), "w", w ** -0.5))
    ln(v + ("ln_pre",), w)
    blocks(v + ("blocks",), vision["layers"], w)
    ln(v + ("ln_post",), w)
    out.append((v + ("proj",), (w, vision["embed_dim"]), "w", w ** -0.5))
    tw = text["width"]
    t = ("text",)
    out.append((t + ("token_embedding",), (text["vocab_size"], tw), "w",
                0.02))
    out.append((t + ("pos_embedding",), (text["context_length"], tw), "w",
                0.01))
    blocks(t + ("blocks",), text["layers"], tw)
    ln(t + ("ln_final",), tw)
    out.append((t + ("text_projection",), (tw, text["embed_dim"]), "w",
                tw ** -0.5))
    return out


# small random biases and LayerNorm affine parameters
BIAS_STD = 0.02
LN_SCALE_STD = 0.1
LN_BIAS_STD = 0.05


def make_params(config: dict, seed: int, device) -> dict:
    """The nested f32 parameter tree of ``config`` (a configuration file's
    ``vision`` and ``text`` groups) on ``device``, from ``seed``."""
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
    tree["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device)
    return tree


def to_host(tree):
    """The tree as host numpy arrays (what a checkpoint loads as)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
