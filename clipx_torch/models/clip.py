"""CLIP ViT image tower and causal text tower in PyTorch.

Counterpart of ``clipx/models/clip.py`` for the ViT presets (the ResNet
towers wait for a later port). Same layouts as clipx at the public
functions: pixels (B, H, W, 3) NHWC, already normalized; token ids
(B, context_length); params the nested dict of ``from_jax_params``.
Embeddings come back float32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from clipx_torch.config import CLIPConfig
from clipx_torch.models.layers import dense, layer_norm, transformer

Params = Dict[str, Any]


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_patches, patch*patch*3), row-major patches,
    flattened in (ph, pw, channel) order (the patch-kernel layout of
    convert._conv_to_patch_kernel)."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _project(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """x @ proj accumulated in f32 from the exactly upcast inputs: the
    f32 result of clipx's ``dot(..., preferred_element_type=f32)``."""
    return torch.matmul(x.float(), proj.float())


def _l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def encode_image(params: Params, cfg: CLIPConfig, pixels: torch.Tensor, *,
                 normalize: bool = False,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Image embeddings (B, embed_dim) float32. ``normalize=True``
    additionally L2-normalizes, as the indexer stores them."""
    if getattr(cfg.vision, "tower", "vit") != "vit":
        raise NotImplementedError("ResNet towers are not ported yet")
    v = cfg.vision
    p = params["visual"]
    x = dense(patchify(pixels.to(dtype), v.patch_size),
              p["patch_embed"]["kernel"])
    cls = p["class_embedding"].to(dtype).expand(x.shape[0], 1, v.width)
    x = torch.cat([cls, x], dim=1)
    x = x + p["pos_embedding"].to(dtype)
    x = layer_norm(x, p["ln_pre"], cfg.layernorm_eps)
    x = transformer(x, p["blocks"], v.heads, causal=False,
                    eps=cfg.layernorm_eps, use_quick_gelu=cfg.quick_gelu)
    x = layer_norm(x[:, 0, :], p["ln_post"], cfg.layernorm_eps)
    emb = _project(x, p["proj"])
    return _l2_normalize(emb) if normalize else emb


def encode_text(params: Params, cfg: CLIPConfig, token_ids: torch.Tensor, *,
                normalize: bool = False,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Text embeddings (B, embed_dim) float32 from (B, context_length)
    zero-padded token ids. The sequence feature is read at the EOT
    position, the argmax of the ids (EOT is the largest id)."""
    t = cfg.text
    p = params["text"]
    token_ids = token_ids.long()
    # gather before casting: only B x 77 rows of the table are touched
    x = p["token_embedding"][token_ids].to(dtype)
    x = x + p["pos_embedding"].to(dtype)
    x = transformer(x, p["blocks"], t.heads, causal=True,
                    eps=cfg.layernorm_eps, use_quick_gelu=cfg.quick_gelu)
    x = layer_norm(x, p["ln_final"], cfg.layernorm_eps)
    eot = token_ids.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    emb = _project(x, p["text_projection"])
    return _l2_normalize(emb) if normalize else emb


def clip_forward(params: Params, cfg: CLIPConfig, pixels: torch.Tensor,
                 token_ids: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32):
    """(logits_per_image, logits_per_text) like the torch CLIP model."""
    img = encode_image(params, cfg, pixels, normalize=True, dtype=dtype)
    txt = encode_text(params, cfg, token_ids, normalize=True, dtype=dtype)
    logits = torch.exp(params["logit_scale"].float()) * img @ txt.T
    return logits, logits.T
