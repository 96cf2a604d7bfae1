"""CLIP image towers and causal text tower in PyTorch.

Counterpart of ``clipx/models/clip.py``: the ViT image tower here, the
ModifiedResNet one (RN50 family) in ``models/resnet.py``, picked by the
vision config's tower as clipx does. Same layouts as clipx at the public
functions: pixels (B, H, W, 3) NHWC, already normalized; token ids
(B, context_length); params the nested dict of ``from_jax_params``.
Embeddings come back float32 whatever the compute dtype.

SigLIP (``config.SigLIPConfig``) runs the same blocks with its own
settings: a patch embedding with a bias and no class token or ``ln_pre``,
tanh GELU and the MLP width of the config, then post-LN and the
attention-pooling head (``layers.map_head``, under the span
``tower.map_head``) in place of the class token's projection; its text
tower is bidirectional and read at the last position through a linear
``head``. A patch grid drops the image's remainder rows and columns, as a
"valid" convolution does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from clipx_torch.config import CLIPConfig
from clipx_torch.models.layers import dense, layer_norm, map_head, transformer
from clipx_torch.utils import profiling

Params = Dict[str, Any]


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_patches, patch*patch*3), row-major patches,
    flattened in (ph, pw, channel) order (the patch-kernel layout of
    convert._conv_to_patch_kernel). Rows and columns past the last whole
    patch are dropped (SigLIP's 384 px at patch 14 reads 378)."""
    b, h, w, c = pixels.shape
    gh, gw = h // patch, w // patch
    if (h, w) != (gh * patch, gw * patch):
        pixels = pixels[:, :gh * patch, :gw * patch]
    x = pixels.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _project(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """x @ proj accumulated in f32 from the exactly upcast inputs: the
    f32 result of clipx's ``dot(..., preferred_element_type=f32)``."""
    return torch.matmul(x.float(), proj.float())


def _head(x: torch.Tensor, p) -> torch.Tensor:
    """x @ kernel + bias accumulated in f32 from the exactly upcast
    inputs (SigLIP's text ``head``, as ``_project`` is CLIP's)."""
    return torch.addmm(p["bias"].float(), x.float(), p["kernel"].float())


def _l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def encode_image(params: Params, cfg: CLIPConfig, pixels: torch.Tensor, *,
                 normalize: bool = False, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla", remat: bool = False) -> torch.Tensor:
    """Image embeddings (B, embed_dim) float32. ``normalize=True``
    additionally L2-normalizes, as the indexer stores them. ``attn_impl``
    as in ``layers.mha_block``, ``remat`` as in ``layers.transformer`` (the
    ResNet towers ignore both, as clipx's do)."""
    if getattr(cfg.vision, "tower", "vit") == "resnet":
        from clipx_torch.models import resnet

        return resnet.encode_image(params, cfg, pixels, normalize=normalize,
                                   dtype=dtype)
    v = cfg.vision
    p = params["visual"]
    x = patchify(pixels.to(dtype), v.patch_size)
    pe = p["patch_embed"]
    bias = pe["bias"] if v.patch_bias else None
    if "kernel_q" in pe:  # W8A8 (CLIPX_INT8_PATCH, models.quant)
        from clipx_torch.models.quant import dense_w8a8

        x = dense_w8a8(x, pe["kernel_q"], pe["scale"], bias)
    else:
        x = dense(x, pe["kernel"], bias)
    if v.class_token:
        cls = p["class_embedding"].to(dtype).expand(x.shape[0], 1, v.width)
        x = torch.cat([cls, x], dim=1)
    x = x + p["pos_embedding"].to(dtype)
    if v.ln_pre:
        x = layer_norm(x, p["ln_pre"], cfg.layernorm_eps)
    x = transformer(x, p["blocks"], v.heads, causal=False,
                    eps=cfg.layernorm_eps, activation=cfg.activation,
                    attn_impl=attn_impl, remat=remat)
    if v.pool == "map":
        x = layer_norm(x, p["ln_post"], cfg.layernorm_eps)
        with profiling.span("tower.map_head", x.shape[0]):
            emb = map_head(x, p["map_head"], v.heads, eps=cfg.layernorm_eps,
                           activation=cfg.activation).float()
    else:
        x = layer_norm(x[:, 0, :], p["ln_post"], cfg.layernorm_eps)
        emb = _project(x, p["proj"])
    return _l2_normalize(emb) if normalize else emb


def encode_text(params: Params, cfg: CLIPConfig, token_ids: torch.Tensor, *,
                normalize: bool = False, dtype: torch.dtype = torch.float32,
                attn_impl: str = "xla", remat: bool = False) -> torch.Tensor:
    """Text embeddings (B, embed_dim) float32 from (B, context_length)
    zero-padded token ids. The sequence feature is read at the EOT
    position, the argmax of the ids (EOT is the largest id); SigLIP's
    (``pool == "last"``) at the last position, through its ``head``."""
    t = cfg.text
    p = params["text"]
    token_ids = token_ids.long()
    # gather before casting: only B x 77 rows of the table are touched
    x = p["token_embedding"][token_ids].to(dtype)
    x = x + p["pos_embedding"].to(dtype)
    x = transformer(x, p["blocks"], t.heads, causal=t.causal,
                    eps=cfg.layernorm_eps, activation=cfg.activation,
                    attn_impl=attn_impl, remat=remat)
    x = layer_norm(x, p["ln_final"], cfg.layernorm_eps)
    if t.pool == "last":
        emb = _head(x[:, -1], p["head"])
        return _l2_normalize(emb) if normalize else emb
    eot = token_ids.argmax(dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    emb = _project(x, p["text_projection"])
    return _l2_normalize(emb) if normalize else emb


def clip_forward(params: Params, cfg: CLIPConfig, pixels: torch.Tensor,
                 token_ids: torch.Tensor, *,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla"):
    """(logits_per_image, logits_per_text) like the torch CLIP model
    (SigLIP's add ``logit_bias``). ``attn_impl`` reaches both towers, as
    in clipx."""
    img = encode_image(params, cfg, pixels, normalize=True, dtype=dtype,
                       attn_impl=attn_impl)
    txt = encode_text(params, cfg, token_ids, normalize=True, dtype=dtype,
                      attn_impl=attn_impl)
    logits = torch.exp(params["logit_scale"].float()) * img @ txt.T
    if cfg.logit_bias:
        logits = logits + params["logit_bias"].float()
    return logits, logits.T
