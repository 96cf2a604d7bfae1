"""OpenAI CLIP's forward pass (github.com/openai/CLIP, ``clip/model.py``),
plain PyTorch in float32, with TF32 off where it runs on a GPU.

Departures from ``clip/model.py``, each without effect on the function:

- The parameters are clipx's layout (``benchmark/weights.py``), the one the
  benchmark makes: linear layers are ``x @ W + b`` with W stored (in, out),
  q, k and v are three matrices rather than one ``in_proj_weight``, and
  each tower's blocks are stacked along a leading layer axis.
- ``conv1`` (stride = kernel = patch, no bias) is written as the same sum:
  each patch flattened in (row, column, channel) order, times the
  (p*p*3, W) patch matrix.
- ``logit_scale`` and the image-text logits are left out: the benchmark
  compares embeddings.
- Pixels arrive as uint8 (B, H, W, 3) at the model's size and are
  normalised here with the configuration's mean and std; OpenAI's
  resize and crop happen before, on the host, and are not measured.
- For the benchmark's control, ``quant="fp8"`` computes the
  configuration's bf16 policy one precision down (``_Precision``); the
  default is float32 throughout.

``tokenize`` is CLIP's tokenizer without its learned merge table, as the
port tokenizes when it finds none (the query driver refuses a run where it
finds one), for the benchmark's prompts of lowercase ASCII words: each word
is its bytes, the last one marked end-of-word, between start- and
end-of-text, zero-padded.
"""

from __future__ import annotations

import contextlib
import math

import torch

SOT, EOT = 49406, 49407


def _byte_ids():
    """CLIP's (GPT-2's) byte -> vocabulary position of its printable
    symbol: printable ASCII and two Latin-1 ranges in order, then every
    other byte."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    rest = [b for b in range(256) if b not in bs]
    return {b: i for i, b in enumerate(bs + rest)}


_BYTE_IDS = _byte_ids()


def tokenize(texts, context_length: int = 77) -> torch.Tensor:
    """(N, context_length) int64 ids of lowercase ASCII prompts."""
    out = torch.zeros((len(texts), context_length), dtype=torch.int64)
    for row, text in enumerate(texts):
        ids = [SOT]
        for word in text.lower().split():
            raw = word.encode("ascii")
            ids += [_BYTE_IDS[b] for b in raw[:-1]]
            ids.append(256 + _BYTE_IDS[raw[-1]])
        ids.append(EOT)
        if len(ids) > context_length:
            raise ValueError(f"prompt too long for {context_length}: {text!r}")
        out[row, : len(ids)] = torch.tensor(ids)
    return out


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 rounding with one scale for the tensor (its max at
    e4m3's largest finite value, 448), back in f32."""
    scale = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


class _Precision:
    """Where the forward rounds. ``""``: nowhere (f32). ``"fp8"``: every
    tensor that the configuration's bf16 policy stores in bf16 (weights,
    pixels, the residual stream, LayerNorm and matmul outputs, attention's
    operands and probabilities) is stored in e4m3 instead, with f32
    accumulation and statistics: the same policy one precision down."""

    def __init__(self, quant: str):
        if quant not in ("", "fp8"):
            raise ValueError(f"unknown precision {quant!r}")
        self.store = _fp8 if quant == "fp8" else _keep

    def linear(self, x, w, b):
        return self.store(self.store(x) @ self.store(w) + b)


def _layer_norm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _block(x, p, i, heads, causal, eps, pr: _Precision):
    a, m = p["attn"], p["mlp"]
    b, s, w = x.shape
    d = w // heads
    st = pr.store
    h = st(_layer_norm(x, p["ln_1"]["scale"][i], p["ln_1"]["bias"][i], eps))

    def split(t):
        return t.reshape(b, s, heads, d).transpose(1, 2)

    q = split(pr.linear(h, a["wq"][i], a["bq"][i]))
    k = split(pr.linear(h, a["wk"][i], a["bk"][i]))
    v = split(pr.linear(h, a["wv"][i], a["bv"][i]))
    att = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        att = att.masked_fill(mask, float("-inf"))
    o = st(st(att.softmax(dim=-1)) @ v).transpose(1, 2).reshape(b, s, w)
    x = st(x + pr.linear(o, a["wo"][i], a["bo"][i]))
    h = st(_layer_norm(x, p["ln_2"]["scale"][i], p["ln_2"]["bias"][i], eps))
    h = pr.linear(h, m["w1"][i], m["b1"][i])
    h = st(h * torch.sigmoid(1.702 * h))  # QuickGELU
    return st(x + pr.linear(h, m["w2"][i], m["b2"][i]))


def _blocks(x, p, heads, causal, eps, pr):
    for i in range(p["ln_1"]["scale"].shape[0]):
        x = _block(x, p, i, heads, causal, eps, pr)
    return x


def _normalize(e):
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def encode_images(params, config: dict, frames: torch.Tensor, *,
                  chunk: int = 32, quant: str = "") -> torch.Tensor:
    """(N, H, W, 3) uint8 frames -> (N, E) f32 L2-normalised embeddings,
    ``chunk`` images at a time, on the frames' device."""
    v, p = config["vision"], params["visual"]
    eps = config["layernorm_eps"]
    dev = frames.device
    mean = torch.tensor(config["image_mean"], device=dev)
    std = torch.tensor(config["image_std"], device=dev)
    ps, w = v["patch_size"], v["width"]
    pr = _Precision(quant)
    st = pr.store
    out = []
    with no_tf32():
        for i in range(0, frames.shape[0], chunk):
            x = st((frames[i: i + chunk].float() / 255.0 - mean) / std)
            b, hh, ww, c = x.shape
            x = x.reshape(b, hh // ps, ps, ww // ps, ps, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, ps * ps * c)
            x = st(x @ st(p["patch_embed"]["kernel"]))
            cls = p["class_embedding"].expand(b, 1, w)
            x = st(torch.cat([cls, x], dim=1) + p["pos_embedding"])
            x = st(_layer_norm(x, p["ln_pre"]["scale"], p["ln_pre"]["bias"],
                               eps))
            x = _blocks(x, p["blocks"], v["heads"], False, eps, pr)
            x = _layer_norm(x[:, 0], p["ln_post"]["scale"],
                            p["ln_post"]["bias"], eps)
            out.append(_normalize(x @ p["proj"]))
    return torch.cat(out)


def encode_texts(params, config: dict, ids: torch.Tensor, *,
                 chunk: int = 256, quant: str = "") -> torch.Tensor:
    """(N, 77) token ids -> (N, E) f32 L2-normalised embeddings, read at
    each row's end-of-text position (its largest id)."""
    t, p = config["text"], params["text"]
    eps = config["layernorm_eps"]
    pr = _Precision(quant)
    out = []
    with no_tf32():
        for i in range(0, ids.shape[0], chunk):
            tok = ids[i: i + chunk]
            x = pr.store(p["token_embedding"][tok] + p["pos_embedding"])
            x = _blocks(x, p["blocks"], t["heads"], True, eps, pr)
            x = _layer_norm(x, p["ln_final"]["scale"], p["ln_final"]["bias"],
                            eps)
            x = x[torch.arange(x.shape[0], device=x.device),
                  tok.argmax(dim=-1)]
            out.append(_normalize(x @ p["text_projection"]))
    return torch.cat(out)
