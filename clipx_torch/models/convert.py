"""Checkpoints and parameters for the port: numpy trees <-> torch tensors.

Counterpart of ``clipx/models/convert.py``. Parameters travel as the
nested dict of numpy arrays that ``clipx.models.convert`` produces: stacked
per-tower blocks, ``x @ W`` (in, out) weight layout; for the ResNet towers
HWIO conv kernels with folded BatchNorm. This module

- reads torch CLIP state dicts in the OpenAI (ViT and ModifiedResNet) and
  HuggingFace layouts, and Hugging Face SigLIP state dicts (``SiglipModel``:
  ``vision_model.*``, ``text_model.*``, ``logit_scale``, ``logit_bias``),
  into that tree (``from_state_dict``);
- reads and writes the flat-key ``.npz`` of ``clipx.models.convert.
  save_params`` (``load_params`` / ``save_params``), so a checkpoint saved
  by either package loads in the other;
- makes seeded random parameters (``init_params``);
- turns a tree into tensors on a device (``from_jax_params``) and back
  into numpy (``to_jax_params``).

All conversion is host numpy; torch is only needed to read ``.pt`` files
and to place the result.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from clipx_torch.config import (CLIPConfig, ResNetVisionConfig, TextConfig,
                                VisionConfig)

Params = Dict[str, Any]
Arrays = Mapping[str, np.ndarray]


def _np(sd: Arrays, key: str) -> np.ndarray:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def _stack(per_layer):
    return np.stack(per_layer, axis=0)


def _conv_to_patch_kernel(w: np.ndarray) -> np.ndarray:
    """torch conv (out, in=3, kh, kw) -> (kh*kw*in, out) matmul kernel,
    matching the (ph, pw, channel) patch flatten order of
    clipx_torch.models.clip.patchify."""
    out, cin, kh, kw = w.shape
    return w.transpose(2, 3, 1, 0).reshape(kh * kw * cin, out)


# ---------------------------------------------------------------------------
# OpenAI layout
# ---------------------------------------------------------------------------

def _is_resnet_sd(sd: Arrays) -> bool:
    return any(k.startswith("visual.layer1.") for k in sd)


def _layers(sd: Arrays, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))


def _conv_hwio(w: np.ndarray) -> np.ndarray:
    """torch conv (out, in, kh, kw) -> HWIO (kh, kw, in, out)."""
    return w.transpose(2, 3, 1, 0)


def _fold_bn(sd: Arrays, prefix: str) -> Params:
    from clipx_torch.models.resnet import fold_bn

    return fold_bn(_np(sd, f"{prefix}.weight"), _np(sd, f"{prefix}.bias"),
                   _np(sd, f"{prefix}.running_mean"),
                   _np(sd, f"{prefix}.running_var"))


def _rn_block(sd: Arrays, prefix: str) -> Params:
    p = {
        "conv1": _conv_hwio(_np(sd, f"{prefix}.conv1.weight")),
        "bn1": _fold_bn(sd, f"{prefix}.bn1"),
        "conv2": _conv_hwio(_np(sd, f"{prefix}.conv2.weight")),
        "bn2": _fold_bn(sd, f"{prefix}.bn2"),
        "conv3": _conv_hwio(_np(sd, f"{prefix}.conv3.weight")),
        "bn3": _fold_bn(sd, f"{prefix}.bn3"),
    }
    if f"{prefix}.downsample.0.weight" in sd:
        # torch layout: Sequential(avgpool, conv1x1, bn)
        p["down_conv"] = _conv_hwio(_np(sd, f"{prefix}.downsample.0.weight"))
        p["down_bn"] = _fold_bn(sd, f"{prefix}.downsample.1")
    return p


def _rn_visual(sd: Arrays, v) -> Params:
    from clipx_torch.models.resnet import _stack_blocks

    out: Params = {"stem": {
        "conv1": _conv_hwio(_np(sd, "visual.conv1.weight")),
        "bn1": _fold_bn(sd, "visual.bn1"),
        "conv2": _conv_hwio(_np(sd, "visual.conv2.weight")),
        "bn2": _fold_bn(sd, "visual.bn2"),
        "conv3": _conv_hwio(_np(sd, "visual.conv3.weight")),
        "bn3": _fold_bn(sd, "visual.bn3"),
    }}
    for i, n_blocks in enumerate(v.layers):
        stage: Params = {"first": _rn_block(sd, f"visual.layer{i + 1}.0")}
        if n_blocks > 1:
            stage["rest"] = _stack_blocks(
                [_rn_block(sd, f"visual.layer{i + 1}.{j}")
                 for j in range(1, n_blocks)])
        out[f"stage{i + 1}"] = stage
    ap = "visual.attnpool"
    out["attnpool"] = {
        "pos_embedding": _np(sd, f"{ap}.positional_embedding"),
        "wq": _np(sd, f"{ap}.q_proj.weight").T,
        "bq": _np(sd, f"{ap}.q_proj.bias"),
        "wk": _np(sd, f"{ap}.k_proj.weight").T,
        "bk": _np(sd, f"{ap}.k_proj.bias"),
        "wv": _np(sd, f"{ap}.v_proj.weight").T,
        "bv": _np(sd, f"{ap}.v_proj.bias"),
        "wc": _np(sd, f"{ap}.c_proj.weight").T,
        "bc": _np(sd, f"{ap}.c_proj.bias"),
    }
    return out


def _config_from_openai_resnet(sd: Arrays) -> CLIPConfig:
    width = int(np.asarray(sd["visual.conv1.weight"]).shape[0]) * 2
    layers = tuple(_layers(sd, rf"visual\.layer{s}\.(\d+)\.")
                   for s in range(1, 5))
    pos = int(np.asarray(
        sd["visual.attnpool.positional_embedding"]).shape[0])
    image_size = 32 * int(round((pos - 1) ** 0.5))
    embed_dim = int(np.asarray(sd["visual.attnpool.c_proj.weight"]).shape[0])
    t_layers = _layers(sd, r"transformer\.resblocks\.(\d+)\.")
    t_width = int(np.asarray(sd["ln_final.weight"]).shape[0])
    vocab = int(np.asarray(sd["token_embedding.weight"]).shape[0])
    ctx = int(np.asarray(sd["positional_embedding"]).shape[0])
    return CLIPConfig(
        name=f"openai-rn-w{width}",
        vision=ResNetVisionConfig(image_size=image_size, layers=layers,
                                  width=width, embed_dim=embed_dim),
        text=TextConfig(context_length=ctx, vocab_size=vocab, width=t_width,
                        layers=t_layers, heads=t_width // 64,
                        embed_dim=embed_dim),
    )


def config_from_openai_state_dict(sd: Arrays) -> CLIPConfig:
    """Infer the architecture from an OpenAI CLIP state dict (ViT or
    ModifiedResNet)."""
    if _is_resnet_sd(sd):
        return _config_from_openai_resnet(sd)
    conv = sd["visual.conv1.weight"]
    width = int(conv.shape[0])
    patch = int(conv.shape[-1])
    seq = int(np.asarray(sd["visual.positional_embedding"]).shape[0])
    image_size = patch * int(round((seq - 1) ** 0.5))
    v_layers = _layers(sd, r"visual\.transformer\.resblocks\.(\d+)\.")
    t_layers = _layers(sd, r"transformer\.resblocks\.(\d+)\.")
    embed_dim = int(np.asarray(sd["text_projection"]).shape[1])
    t_width = int(np.asarray(sd["ln_final.weight"]).shape[0])
    vocab = int(np.asarray(sd["token_embedding.weight"]).shape[0])
    ctx = int(np.asarray(sd["positional_embedding"]).shape[0])
    return CLIPConfig(
        name=f"openai-vit-{width}x{patch}",
        vision=VisionConfig(image_size=image_size, patch_size=patch,
                            width=width, layers=v_layers, heads=width // 64,
                            embed_dim=embed_dim),
        text=TextConfig(context_length=ctx, vocab_size=vocab, width=t_width,
                        layers=t_layers, heads=t_width // 64,
                        embed_dim=embed_dim),
    )


def _openai_blocks(sd: Arrays, prefix: str, layers: int) -> Params:
    cols = {k: [] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",
                            "l1s", "l1b", "l2s", "l2b", "w1", "b1", "w2",
                            "b2")}
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        qw, kw, vw = np.split(_np(sd, f"{p}.attn.in_proj_weight"), 3, axis=0)
        qb, kb, vb = np.split(_np(sd, f"{p}.attn.in_proj_bias"), 3, axis=0)
        for key, val in (("wq", qw.T), ("wk", kw.T), ("wv", vw.T),
                         ("bq", qb), ("bk", kb), ("bv", vb),
                         ("wo", _np(sd, f"{p}.attn.out_proj.weight").T),
                         ("bo", _np(sd, f"{p}.attn.out_proj.bias")),
                         ("l1s", _np(sd, f"{p}.ln_1.weight")),
                         ("l1b", _np(sd, f"{p}.ln_1.bias")),
                         ("l2s", _np(sd, f"{p}.ln_2.weight")),
                         ("l2b", _np(sd, f"{p}.ln_2.bias")),
                         ("w1", _np(sd, f"{p}.mlp.c_fc.weight").T),
                         ("b1", _np(sd, f"{p}.mlp.c_fc.bias")),
                         ("w2", _np(sd, f"{p}.mlp.c_proj.weight").T),
                         ("b2", _np(sd, f"{p}.mlp.c_proj.bias"))):
            cols[key].append(val)
    s = {k: _stack(v) for k, v in cols.items()}
    return {
        "ln_1": {"scale": s["l1s"], "bias": s["l1b"]},
        "attn": {k: s[k] for k in ("wq", "wk", "wv", "wo",
                                   "bq", "bk", "bv", "bo")},
        "ln_2": {"scale": s["l2s"], "bias": s["l2b"]},
        "mlp": {k: s[k] for k in ("w1", "b1", "w2", "b2")},
    }


def from_openai_state_dict(sd: Arrays, cfg: CLIPConfig) -> Params:
    v, t = cfg.vision, cfg.text
    if getattr(v, "tower", "vit") == "resnet":
        visual = _rn_visual(sd, v)
    else:
        visual = {
            "patch_embed": {"kernel": _conv_to_patch_kernel(
                _np(sd, "visual.conv1.weight"))},
            "class_embedding": _np(sd, "visual.class_embedding"),
            "pos_embedding": _np(sd, "visual.positional_embedding"),
            "ln_pre": {"scale": _np(sd, "visual.ln_pre.weight"),
                       "bias": _np(sd, "visual.ln_pre.bias")},
            "blocks": _openai_blocks(sd, "visual.transformer", v.layers),
            "ln_post": {"scale": _np(sd, "visual.ln_post.weight"),
                        "bias": _np(sd, "visual.ln_post.bias")},
            "proj": _np(sd, "visual.proj"),
        }
    return {
        "visual": visual,
        "text": {
            "token_embedding": _np(sd, "token_embedding.weight"),
            "pos_embedding": _np(sd, "positional_embedding"),
            "blocks": _openai_blocks(sd, "transformer", t.layers),
            "ln_final": {"scale": _np(sd, "ln_final.weight"),
                         "bias": _np(sd, "ln_final.bias")},
            "text_projection": _np(sd, "text_projection"),
        },
        "logit_scale": _np(sd, "logit_scale").reshape(()),
    }


# ---------------------------------------------------------------------------
# HuggingFace transformers layout
# ---------------------------------------------------------------------------

def _hf_blocks(sd: Arrays, prefix: str, layers: int) -> Params:
    def g(name, transpose=False):
        out = [_np(sd, f"{prefix}.layers.{i}.{name}") for i in range(layers)]
        return _stack([o.T for o in out] if transpose else out)

    return {
        "ln_1": {"scale": g("layer_norm1.weight"),
                 "bias": g("layer_norm1.bias")},
        "attn": {
            "wq": g("self_attn.q_proj.weight", True),
            "wk": g("self_attn.k_proj.weight", True),
            "wv": g("self_attn.v_proj.weight", True),
            "wo": g("self_attn.out_proj.weight", True),
            "bq": g("self_attn.q_proj.bias"),
            "bk": g("self_attn.k_proj.bias"),
            "bv": g("self_attn.v_proj.bias"),
            "bo": g("self_attn.out_proj.bias"),
        },
        "ln_2": {"scale": g("layer_norm2.weight"),
                 "bias": g("layer_norm2.bias")},
        "mlp": {"w1": g("mlp.fc1.weight", True), "b1": g("mlp.fc1.bias"),
                "w2": g("mlp.fc2.weight", True), "b2": g("mlp.fc2.bias")},
    }


def from_hf_state_dict(sd: Arrays, cfg: CLIPConfig) -> Params:
    v, t = cfg.vision, cfg.text
    return {
        "visual": {
            "patch_embed": {"kernel": _conv_to_patch_kernel(
                _np(sd, "vision_model.embeddings.patch_embedding.weight"))},
            "class_embedding": _np(
                sd, "vision_model.embeddings.class_embedding"),
            "pos_embedding": _np(
                sd, "vision_model.embeddings.position_embedding.weight"),
            # yes, HF really spells it "pre_layrnorm"
            "ln_pre": {"scale": _np(sd, "vision_model.pre_layrnorm.weight"),
                       "bias": _np(sd, "vision_model.pre_layrnorm.bias")},
            "blocks": _hf_blocks(sd, "vision_model.encoder", v.layers),
            "ln_post": {"scale": _np(sd, "vision_model.post_layernorm.weight"),
                        "bias": _np(sd, "vision_model.post_layernorm.bias")},
            "proj": _np(sd, "visual_projection.weight").T,
        },
        "text": {
            "token_embedding": _np(
                sd, "text_model.embeddings.token_embedding.weight"),
            "pos_embedding": _np(
                sd, "text_model.embeddings.position_embedding.weight"),
            "blocks": _hf_blocks(sd, "text_model.encoder", t.layers),
            "ln_final": {"scale": _np(sd, "text_model.final_layer_norm.weight"),
                         "bias": _np(sd, "text_model.final_layer_norm.bias")},
            "text_projection": _np(sd, "text_projection.weight").T,
        },
        "logit_scale": _np(sd, "logit_scale").reshape(()),
    }


def _siglip_map_head(sd: Arrays, prefix: str) -> Params:
    """The pooling head: its probe, the packed ``in_proj`` of
    ``nn.MultiheadAttention`` split into q, k and v, LayerNorm and MLP."""
    wq, wk, wv = np.split(_np(sd, f"{prefix}.attention.in_proj_weight"), 3,
                          axis=0)
    bq, bk, bv = np.split(_np(sd, f"{prefix}.attention.in_proj_bias"), 3,
                          axis=0)
    return {
        "probe": _np(sd, f"{prefix}.probe"),
        "attn": {"wq": wq.T, "wk": wk.T, "wv": wv.T,
                 "wo": _np(sd, f"{prefix}.attention.out_proj.weight").T,
                 "bq": bq, "bk": bk, "bv": bv,
                 "bo": _np(sd, f"{prefix}.attention.out_proj.bias")},
        "ln": {"scale": _np(sd, f"{prefix}.layernorm.weight"),
               "bias": _np(sd, f"{prefix}.layernorm.bias")},
        "mlp": {"w1": _np(sd, f"{prefix}.mlp.fc1.weight").T,
                "b1": _np(sd, f"{prefix}.mlp.fc1.bias"),
                "w2": _np(sd, f"{prefix}.mlp.fc2.weight").T,
                "b2": _np(sd, f"{prefix}.mlp.fc2.bias")},
    }


def from_siglip_state_dict(sd: Arrays, cfg: CLIPConfig) -> Params:
    """A Hugging Face ``SiglipModel`` state dict -> the port's SigLIP tree:
    the patch convolution (and its bias) as the (p*p*3, W) patch matrix,
    linear layers transposed to (in, out), each tower's blocks stacked."""
    v, t = cfg.vision, cfg.text
    emb = "vision_model.embeddings"
    temb = "text_model.embeddings"
    return {
        "visual": {
            "patch_embed": {
                "kernel": _conv_to_patch_kernel(
                    _np(sd, f"{emb}.patch_embedding.weight")),
                "bias": _np(sd, f"{emb}.patch_embedding.bias")},
            "pos_embedding": _np(sd, f"{emb}.position_embedding.weight"),
            "blocks": _hf_blocks(sd, "vision_model.encoder", v.layers),
            "ln_post": {"scale": _np(sd, "vision_model.post_layernorm.weight"),
                        "bias": _np(sd, "vision_model.post_layernorm.bias")},
            "map_head": _siglip_map_head(sd, "vision_model.head"),
        },
        "text": {
            "token_embedding": _np(sd, f"{temb}.token_embedding.weight"),
            "pos_embedding": _np(sd, f"{temb}.position_embedding.weight"),
            "blocks": _hf_blocks(sd, "text_model.encoder", t.layers),
            "ln_final": {"scale": _np(sd, "text_model.final_layer_norm.weight"),
                         "bias": _np(sd, "text_model.final_layer_norm.bias")},
            "head": {"kernel": _np(sd, "text_model.head.weight").T,
                     "bias": _np(sd, "text_model.head.bias")},
        },
        "logit_scale": _np(sd, "logit_scale").reshape(()),
        "logit_bias": _np(sd, "logit_bias").reshape(()),
    }


def detect_format(sd: Arrays) -> str:
    if "visual.conv1.weight" in sd:
        return "openai"
    if "vision_model.head.probe" in sd:
        return "siglip"
    if "vision_model.embeddings.patch_embedding.weight" in sd:
        return "hf"
    raise ValueError("unrecognized CLIP state dict layout")


def from_state_dict(sd: Arrays, cfg: CLIPConfig) -> Params:
    fmt = detect_format(sd)
    if fmt == "openai":
        return from_openai_state_dict(sd, cfg)
    if fmt == "siglip":
        return from_siglip_state_dict(sd, cfg)
    return from_hf_state_dict(sd, cfg)


def load_torch_checkpoint(path: str, cfg: CLIPConfig) -> Params:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return from_state_dict(dict(obj.items()), cfg)


# ---------------------------------------------------------------------------
# on-disk params (flat npz, the format of clipx.models.convert.save_params)
# ---------------------------------------------------------------------------

def _flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = _to_numpy(val)
    return out


def save_params(path: str, params: Params) -> None:
    np.savez(path, **_flatten(params))


def load_params(path: str) -> Params:
    flat = np.load(path)
    tree: Params = {}
    for key in flat.files:
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[key]
    return tree


# ---------------------------------------------------------------------------
# random init and placement
# ---------------------------------------------------------------------------

def _ln_init(width: int, layers: int | None = None) -> Params:
    shape = (width,) if layers is None else (layers, width)
    return {"scale": np.ones(shape, np.float32),
            "bias": np.zeros(shape, np.float32)}


def _init_block_stack(rng: np.random.Generator, layers: int,
                      width: int, hidden: int | None = None) -> Params:
    """OpenAI-CLIP-style init for a stack of residual blocks (the stds of
    clipx.models.layers.init_block_stack); the MLP 4 x width unless
    ``hidden`` says otherwise."""
    attn_std = width ** -0.5
    proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
    fc_std = (2 * width) ** -0.5
    hidden = width * 4 if hidden is None else hidden

    def nrm(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    zeros = lambda n: np.zeros((layers, n), np.float32)  # noqa: E731
    return {
        "ln_1": _ln_init(width, layers),
        "attn": {"wq": nrm((layers, width, width), attn_std),
                 "wk": nrm((layers, width, width), attn_std),
                 "wv": nrm((layers, width, width), attn_std),
                 "wo": nrm((layers, width, width), proj_std),
                 "bq": zeros(width), "bk": zeros(width), "bv": zeros(width),
                 "bo": zeros(width)},
        "ln_2": _ln_init(width, layers),
        "mlp": {"w1": nrm((layers, width, hidden), fc_std),
                "b1": zeros(hidden),
                "w2": nrm((layers, hidden, width), proj_std),
                "b2": zeros(width)},
    }


def init_params(cfg: CLIPConfig, seed: int = 0) -> Params:
    """Seeded random parameters (numpy tree) with the shapes and stds of
    ``clipx.models.clip.init_params``. The numbers come from numpy's PCG64
    generator, not ``jax.random``, so they differ from clipx's for the same
    seed: to compare the two packages, convert one tree and hand it to
    both."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text

    def nrm(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    if getattr(v, "tower", "vit") == "resnet":
        from clipx_torch.models.resnet import init_visual

        visual = init_visual(cfg, rng)
    elif v.pool == "map":
        return _init_siglip(cfg, rng, nrm)
    else:
        patch_dim = v.patch_size * v.patch_size * 3
        visual = {
            "patch_embed": {"kernel": nrm((patch_dim, v.width),
                                          v.width ** -0.5)},
            "class_embedding": nrm((v.width,), v.width ** -0.5),
            "pos_embedding": nrm((v.seq_len, v.width), v.width ** -0.5),
            "ln_pre": _ln_init(v.width),
            "blocks": _init_block_stack(rng, v.layers, v.width),
            "ln_post": _ln_init(v.width),
            "proj": nrm((v.width, v.embed_dim), v.width ** -0.5),
        }
    return {
        "visual": visual,
        "text": {
            "token_embedding": nrm((t.vocab_size, t.width), 0.02),
            "pos_embedding": nrm((t.context_length, t.width), 0.01),
            "blocks": _init_block_stack(rng, t.layers, t.width),
            "ln_final": _ln_init(t.width),
            "text_projection": nrm((t.width, t.embed_dim), t.width ** -0.5),
        },
        "logit_scale": np.asarray(np.log(1.0 / 0.07), np.float32),
    }


def _init_siglip(cfg: CLIPConfig, rng: np.random.Generator, nrm) -> Params:
    """SigLIP's tree, the same stds as the CLIP towers' (the pooling head
    one unstacked block of attention and MLP, its probe a token's std)."""
    v, t = cfg.vision, cfg.text
    patch_dim = v.patch_size * v.patch_size * 3
    head = _init_block_stack(rng, 1, v.width, v.mlp_dim)
    return {
        "visual": {
            "patch_embed": {"kernel": nrm((patch_dim, v.width),
                                          v.width ** -0.5),
                            "bias": np.zeros((v.width,), np.float32)},
            "pos_embedding": nrm((v.seq_len, v.width), v.width ** -0.5),
            "blocks": _init_block_stack(rng, v.layers, v.width, v.mlp_dim),
            "ln_post": _ln_init(v.width),
            "map_head": {
                "probe": nrm((1, 1, v.width), v.width ** -0.5),
                "attn": {k: a[0] for k, a in head["attn"].items()},
                "ln": _ln_init(v.width),
                "mlp": {k: a[0] for k, a in head["mlp"].items()}},
        },
        "text": {
            "token_embedding": nrm((t.vocab_size, t.width), 0.02),
            "pos_embedding": nrm((t.context_length, t.width), 0.01),
            "blocks": _init_block_stack(rng, t.layers, t.width, t.mlp_dim),
            "ln_final": _ln_init(t.width),
            "head": {"kernel": nrm((t.width, t.embed_dim), t.width ** -0.5),
                     "bias": np.zeros((t.embed_dim,), np.float32)},
        },
        "logit_scale": np.asarray(np.log(10.0), np.float32),
        "logit_bias": np.asarray(-10.0, np.float32),
    }


def from_jax_params(tree: Params, cfg: CLIPConfig | None = None,
                    device="cpu", dtype: torch.dtype = torch.float32) -> Params:
    """clipx's param tree (numpy arrays, tensors, or anything
    ``np.asarray`` takes) -> the same tree of torch tensors on ``device``.
    Arrays of rank >= 2 are cast to ``dtype`` (the compute dtype) and rank
    0-1 arrays stay f32: clipx's Encoder rule. Note that it makes the
    stacked per-layer biases and LayerNorm params (rank 2) bf16 in a bf16
    Encoder, in both packages; they are upcast to f32 where they are used.
    int8 leaves (the W8A8 weights of ``models.quant``) stay int8, and so
    that the rest of a quantized group (a dict holding a ``*_q`` key: its
    scales and biases) stays f32, as clipx's Encoder reattaches those groups
    after its bf16 cast. The ResNet towers' HWIO conv kernels keep their
    shape and values, with their memory laid out for cuDNN
    (``_conv_storage``). ``cfg`` is accepted for symmetry with the
    converters; the tree carries its own shapes."""
    del cfg
    quantized = any(key.endswith("_q") for key in tree)
    out: Params = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = from_jax_params(val, None, device, dtype)
            continue
        if isinstance(val, torch.Tensor):
            t = val.detach()
        else:
            a = np.asarray(val)
            t = torch.from_numpy(np.array(
                a, dtype=np.int8 if a.dtype == np.int8 else np.float32))
        if t.dtype == torch.int8:
            out[key] = t.to(device=device)
            continue
        keep_f32 = quantized or t.dim() < 2
        t = t.to(device=device, dtype=torch.float32 if keep_f32 else dtype)
        if key in _CONV_KEYS and t.dim() >= 4:
            t = _conv_storage(t)
        out[key] = t
    return out


def _to_numpy(val) -> np.ndarray:
    """One leaf as a C-ordered host array: int8 stays int8, every other
    tensor becomes f32. A stored-permuted conv kernel (``_conv_storage``)
    leaves in its logical HWIO order."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        if t.dtype != torch.int8:
            t = t.float()
        return np.array(t.numpy(), order="C")   # a copy, 0-d stays 0-d
    return np.asarray(val)


def to_jax_params(tree: Params) -> Params:
    """The reverse of ``from_jax_params``: the port's tree of tensors (a
    trained one included) -> clipx's numpy tree, the layout that
    ``save_params`` writes and ``clipx.models.convert.load_params`` reads:
    host f32 arrays (int8 stays int8), ResNet conv kernels in HWIO."""
    return {key: (to_jax_params(val) if isinstance(val, dict)
                  else _to_numpy(val)) for key, val in tree.items()}


# the conv kernels of models/resnet.py's tree
_CONV_KEYS = ("conv1", "conv2", "conv3", "down_conv")


def _conv_storage(w: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel, (kh, kw, I, O) or stacked (L, kh, kw, I, O), with the
    same shape and values but its memory in (O, kh, kw, I) order, so that
    ``resnet.conv2d``'s ``permute(3, 2, 0, 1)`` of it (of each layer of a
    stack) is an OIHW kernel in channels_last memory: cuDNN's NHWC
    convolutions read it as it is, with no copy a call."""
    lead = tuple(range(w.dim() - 4))
    kh, kw, i, o = (len(lead) + n for n in range(4))
    # physical axes: (*lead, O, kh, kw, I); back to (*lead, kh, kw, I, O)
    physical = w.permute(*lead, o, kh, kw, i).contiguous()
    return physical.permute(*lead, kh + 1, kw + 1, i + 1, kh)
