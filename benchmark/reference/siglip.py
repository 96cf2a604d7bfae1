"""SigLIP's forward pass, both towers and the attention-pooling head, in
plain PyTorch and float32, with TF32 off where it runs on a GPU.

It follows the published model: SigLIP (Zhai et al., arXiv:2303.15343) at
the so400m shape (arXiv:2305.13035), as ``google/siglip-so400m-patch14-384``
(``config.json``) gives it and as Hugging Face ``transformers``
(``models/siglip/modeling_siglip.py``) and ``big_vision``
(``big_vision/models/vit.py``, ``pool_type="map"``) compute it:

- image: a stride = kernel = patch "valid" convolution with a bias (the
  rows and columns past the last whole patch are not read), a learned
  position embedding, no class token and no LayerNorm before the blocks;
- blocks: pre-LN, ``x += attn(LN1(x)); x += fc2(gelu_tanh(fc1(LN2(x))))``,
  q, k, v and out with biases, LayerNorm eps from the configuration;
- post-LN, then the pooling head: one learned probe attends over every
  token (multi-head, q, k, v and out with biases), ``h += mlp(LN(h))``,
  and the embedding is ``h[:, 0]`` with no projection;
- text: token and position embeddings, the same blocks without a causal
  mask, the final LayerNorm, the last position, then the ``head`` linear.

Departures, each without effect on the function:

- The parameters are the port's layout (``benchmark/weights_siglip.py``):
  linear layers are ``x @ W + b`` with W stored (in, out), the head's
  packed ``in_proj`` is three matrices, and each tower's blocks are stacked
  along a leading layer axis.
- The patch convolution is written as the same sum: each patch flattened in
  (row, column, channel) order, times the (p*p*3, W) patch matrix, plus the
  bias.
- The tanh GELU is written out as its formula,
  ``0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))``.
- The logits (``exp(logit_scale) t i^T + logit_bias``) are left out: the
  benchmark compares embeddings.
- Pixels arrive as uint8 (B, H, W, 3) at the model's size and are
  normalised here with the configuration's mean and std; the resize to the
  input size (no crop) happens before, on the host, and is not measured.
- For the benchmark's control, ``quant="fp8"`` computes the
  configuration's bf16 policy one precision down (``reference/clip.py``'s
  ``_Precision``); the default is float32 throughout.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.clip import _layer_norm, _normalize, _Precision, no_tf32

_GELU_C = math.sqrt(2.0 / math.pi)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * x * x * x)))


def _attend(q, k, v, heads, st):
    """Multi-head attention of q (B, Sq, W) over k, v (B, S, W), no mask."""
    b, sq, w = q.shape
    d = w // heads

    def split(t):
        return t.reshape(b, -1, heads, d).transpose(1, 2)

    att = (split(q) @ split(k).transpose(-1, -2)) / math.sqrt(d)
    o = st(st(att.softmax(dim=-1)) @ split(v))
    return o.transpose(1, 2).reshape(b, sq, w)


def _mlp(x, m, pr, i=None):
    def g(name):
        return m[name] if i is None else m[name][i]

    h = pr.store(gelu_tanh(pr.linear(x, g("w1"), g("b1"))))
    return pr.linear(h, g("w2"), g("b2"))


def _block(x, p, i, heads, eps, pr: _Precision):
    a = p["attn"]
    st = pr.store
    h = st(_layer_norm(x, p["ln_1"]["scale"][i], p["ln_1"]["bias"][i], eps))
    o = _attend(pr.linear(h, a["wq"][i], a["bq"][i]),
                pr.linear(h, a["wk"][i], a["bk"][i]),
                pr.linear(h, a["wv"][i], a["bv"][i]), heads, st)
    x = st(x + pr.linear(o, a["wo"][i], a["bo"][i]))
    h = st(_layer_norm(x, p["ln_2"]["scale"][i], p["ln_2"]["bias"][i], eps))
    return st(x + _mlp(h, p["mlp"], pr, i))


def _blocks(x, p, heads, eps, pr):
    for i in range(p["ln_1"]["scale"].shape[0]):
        x = _block(x, p, i, heads, eps, pr)
    return x


def map_head(x, p, heads, eps, pr: _Precision) -> torch.Tensor:
    """The attention-pooling head over x (B, S, W): (B, W)."""
    a = p["attn"]
    st = pr.store
    probe = p["probe"].reshape(1, 1, -1).expand(x.shape[0], 1, x.shape[-1])
    o = _attend(pr.linear(probe, a["wq"], a["bq"]),
                pr.linear(x, a["wk"], a["bk"]),
                pr.linear(x, a["wv"], a["bv"]), heads, st)
    h = st(pr.linear(o, a["wo"], a["bo"]))
    h = st(h + _mlp(st(_layer_norm(h, p["ln"]["scale"], p["ln"]["bias"], eps)),
                    p["mlp"], pr))
    return h[:, 0]


def encode_images(params, config: dict, frames: torch.Tensor, *,
                  chunk: int = 16, quant: str = "") -> torch.Tensor:
    """(N, H, W, 3) uint8 frames -> (N, W) f32 L2-normalised embeddings,
    ``chunk`` images at a time, on the frames' device."""
    v, p = config["vision"], params["visual"]
    eps = config["layernorm_eps"]
    dev = frames.device
    mean = torch.tensor(config["image_mean"], device=dev)
    std = torch.tensor(config["image_std"], device=dev)
    ps = v["patch_size"]
    g = v["image_size"] // ps
    pr = _Precision(quant)
    st = pr.store
    out = []
    with no_tf32():
        for i in range(0, frames.shape[0], chunk):
            x = st((frames[i: i + chunk].float() / 255.0 - mean) / std)
            b, c = x.shape[0], x.shape[-1]
            x = x[:, : g * ps, : g * ps]
            x = x.reshape(b, g, ps, g, ps, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, ps * ps * c)
            x = pr.linear(x, p["patch_embed"]["kernel"],
                          p["patch_embed"]["bias"])
            x = st(x + p["pos_embedding"])
            x = _blocks(x, p["blocks"], v["heads"], eps, pr)
            x = st(_layer_norm(x, p["ln_post"]["scale"], p["ln_post"]["bias"],
                               eps))
            out.append(_normalize(map_head(x, p["map_head"], v["heads"], eps,
                                           pr)))
    return torch.cat(out)


def encode_texts(params, config: dict, ids: torch.Tensor, *,
                 chunk: int = 64, quant: str = "") -> torch.Tensor:
    """(N, context_length) token ids -> (N, E) f32 L2-normalised embeddings,
    read at the last position through the ``head`` linear."""
    t, p = config["text"], params["text"]
    eps = config["layernorm_eps"]
    pr = _Precision(quant)
    out = []
    with no_tf32():
        for i in range(0, ids.shape[0], chunk):
            tok = ids[i: i + chunk]
            x = pr.store(p["token_embedding"][tok] + p["pos_embedding"])
            x = _blocks(x, p["blocks"], t["heads"], eps, pr)
            x = _layer_norm(x, p["ln_final"]["scale"], p["ln_final"]["bias"],
                            eps)
            out.append(_normalize(x[:, -1] @ p["head"]["kernel"]
                                  + p["head"]["bias"]))
    return torch.cat(out)
