"""The tensor-parallel forward of the ViT towers (Megatron-style).

clipx has no file for this: there, GSPMD derives the TP forward from the
specs of ``parallel/mesh.py``. The port writes it out. Every function here
runs one dp row of the mesh: it takes one tensor (and one param tree, from
``mesh.shard_params``) a local position of the row's :class:`Group` and
returns one a position. Inside a residual block:

- LayerNorm on the whole width (every position holds the residual stream
  whole), then ``tp_copy`` into the column-parallel q/k/v of this
  position's columns, or mlp.w1;
- attention through the port's plain attention
  (``ops.attention.xla_attention``: no kernel of the port): over the
  position's own heads when the heads divide by the row's size, else over
  the heads that overlap its columns, from q/k/v joined by ``tp_gather``
  (a head may straddle two positions, as clipx's GSPMD allows);
- the row-parallel wo/w2 partial product, ``tp_reduce`` over the row, then
  the replicated bias bo/b2 once, then the residual add.

The embeddings are width-sharded: the patch embedding's product and the
token lookup give each position its columns, which ``gather`` joins before
anything that needs the whole width (the class token, the LayerNorms, the
EOT pooling after ``ln_final``). What follows the last block (``ln_post``
or ``ln_final`` and the projection) runs on every position, so each holds
the row's embeddings.

The plain functions of ``models/layers.py`` (``layer_norm``,
``quick_gelu``, ``dense``) do the arithmetic; ``remat`` recomputes each
block in the backward pass as ``layers.transformer`` does. Every sharded
dim must divide by the row's size (checked by ``mesh.shard_params``); the
heads need not.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from clipx_torch.config import CLIPConfig
from clipx_torch.models.clip import _l2_normalize, _project, patchify
from clipx_torch.models.layers import (_activation, dense, layer_norm,
                                       layer_slice)
from clipx_torch.ops.attention import xla_attention
from clipx_torch.parallel.distributed import (Group, gather, tp_copy,
                                              tp_gather, tp_reduce)

Params = Dict[str, Any]
Tensors = List[torch.Tensor]


def _span(group: Group, heads: int, width: int) -> List[tuple]:
    """Each local position's columns [lo, hi) of the attention width and
    the heads that overlap them, [h0, h1), in the group's local order."""
    n, d = group.size, width // heads
    out = []
    for pos in group.local:
        j = group.positions.index(pos)
        lo, hi = j * width // n, (j + 1) * width // n
        out.append((lo, hi, lo // d, -(-hi // d)))
    return out


def mha_block(xs: Sequence[torch.Tensor], ps: Sequence[Params], heads: int,
              group: Group, *, causal: bool) -> Tensors:
    """Self-attention of one row. xs: the LayerNorm's output (B, S, W), the
    same on every position; ps: each position's attention params (its
    columns of wq/wk/wv and rows of wo). Returns the attention output, bo
    added, on every position. Heads that divide by the row's size give
    each position whole heads; otherwise :func:`_split_heads`."""
    if heads % group.size:
        return _split_heads(xs, ps, heads, group, causal=causal)
    local = heads // group.size
    partials = []
    for h, p in zip(tp_copy(xs, group), ps):
        b, s, _ = h.shape
        wl = p["wq"].shape[-1]
        d = wl // local

        def split(t):
            return t.reshape(b, s, local, d).permute(0, 2, 1, 3)

        q = split(dense(h, p["wq"], p["bq"]))
        k = split(dense(h, p["wk"], p["bk"]))
        v = split(dense(h, p["wv"], p["bv"]))
        o = xla_attention(q, k, v, causal=causal)
        o = o.permute(0, 2, 1, 3).reshape(b, s, wl)
        partials.append(dense(o, p["wo"]))
    return [y + p["bo"].to(y.dtype)
            for y, p in zip(tp_reduce(partials, group), ps)]


def _split_heads(xs: Sequence[torch.Tensor], ps: Sequence[Params],
                 heads: int, group: Group, *, causal: bool) -> Tensors:
    """The attention of a row whose positions split a head (clipx's GSPMD
    runs any tp size that divides the width). Each position computes its
    columns [lo, hi) of q, k and v; ``tp_gather`` joins every position's
    (the whole width: 3 B S W elements a position a layer); each position
    runs attention on the heads that overlap its columns, keeps its
    columns of their output and applies its rows of wo. A head that
    straddles two positions is computed on both; ``tp_gather``'s backward
    sums the row's gradients before each position takes its slice, so
    both shares of that head's gradient reach its columns."""
    qkv = [torch.stack([dense(h, p[w], p[b]) for w, b in
                        (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))])
           for h, p in zip(tp_copy(xs, group), ps)]
    whole = tp_gather(qkv, group, -1)
    width = whole[0].shape[-1]
    d = width // heads
    partials = []
    for t, p, (lo, hi, h0, h1) in zip(whole, ps, _span(group, heads, width)):
        _, b, s, _ = t.shape
        q, k, v = (x[..., h0 * d:h1 * d].reshape(b, s, h1 - h0, d)
                   .permute(0, 2, 1, 3) for x in t.unbind(0))
        o = xla_attention(q, k, v, causal=causal)
        o = o.permute(0, 2, 1, 3).reshape(b, s, (h1 - h0) * d)
        partials.append(dense(o[..., lo - h0 * d:hi - h0 * d], p["wo"]))
    return [y + p["bo"].to(y.dtype)
            for y, p in zip(tp_reduce(partials, group), ps)]


def mlp_block(xs: Sequence[torch.Tensor], ps: Sequence[Params], group: Group,
              use_quick_gelu: bool) -> Tensors:
    """The MLP of one row: column-parallel w1 (+ b1) and the activation on
    this position's hidden columns, the row-parallel w2 partial, the sum
    over the row, then b2."""
    partials = [dense(_activation(dense(h, p["w1"], p["b1"]), use_quick_gelu),
                      p["w2"])
                for h, p in zip(tp_copy(xs, group), ps)]
    return [y + p["b2"].to(y.dtype)
            for y, p in zip(tp_reduce(partials, group), ps)]


def residual_block(xs: Sequence[torch.Tensor], ps: Sequence[Params],
                   heads: int, group: Group, *, causal: bool, eps: float,
                   use_quick_gelu: bool) -> Tensors:
    """Pre-LN transformer block over one row."""
    a = mha_block([layer_norm(x, p["ln_1"], eps) for x, p in zip(xs, ps)],
                  [p["attn"] for p in ps], heads, group, causal=causal)
    xs = [x + y for x, y in zip(xs, a)]
    m = mlp_block([layer_norm(x, p["ln_2"], eps) for x, p in zip(xs, ps)],
                  [p["mlp"] for p in ps], group, use_quick_gelu)
    return [x + y for x, y in zip(xs, m)]


def transformer(xs: Sequence[torch.Tensor], stacked: Sequence[Params],
                heads: int, group: Group, *, causal: bool, eps: float,
                use_quick_gelu: bool, remat: bool = False) -> Tensors:
    """The stacked blocks in order. With ``remat`` (and grad mode on) each
    block keeps only its inputs for the backward pass and runs again
    there (``torch.utils.checkpoint``, non-reentrant), its collectives
    included."""
    layers = next(iter(stacked[0]["ln_1"].values())).shape[0]
    remat = remat and torch.is_grad_enabled()
    xs = list(xs)
    for i in range(layers):
        ps = [layer_slice(st, i) for st in stacked]

        def block(*ins, ps=ps):
            return tuple(residual_block(list(ins), ps, heads, group,
                                        causal=causal, eps=eps,
                                        use_quick_gelu=use_quick_gelu))

        if remat:
            from torch.utils.checkpoint import checkpoint

            xs = list(checkpoint(block, *xs, use_reentrant=False))
        else:
            xs = list(block(*xs))
    return xs


def encode_image(trees: Sequence[Params], cfg: CLIPConfig,
                 pixels: Sequence[torch.Tensor], group: Group, *,
                 normalize: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False) -> Tensors:
    """One row's image embeddings (B, embed_dim) f32 on every position,
    from the row's pixels (B, H, W, 3), normalized, on every position."""
    v = cfg.vision
    xs = [dense(patchify(px.to(dtype), v.patch_size),
                t["visual"]["patch_embed"]["kernel"])
          for px, t in zip(pixels, trees)]
    out = []
    for x, t in zip(gather(xs, group, -1), trees):
        p = t["visual"]
        cls = p["class_embedding"].to(dtype).expand(x.shape[0], 1, v.width)
        x = torch.cat([cls, x], dim=1) + p["pos_embedding"].to(dtype)
        out.append(layer_norm(x, p["ln_pre"], cfg.layernorm_eps))
    out = transformer(out, [t["visual"]["blocks"] for t in trees], v.heads,
                      group, causal=False, eps=cfg.layernorm_eps,
                      use_quick_gelu=cfg.quick_gelu, remat=remat)
    embs = []
    for x, t in zip(out, trees):
        p = t["visual"]
        x = layer_norm(x[:, 0, :], p["ln_post"], cfg.layernorm_eps)
        emb = _project(x, p["proj"])
        embs.append(_l2_normalize(emb) if normalize else emb)
    return embs


def encode_text(trees: Sequence[Params], cfg: CLIPConfig,
                token_ids: Sequence[torch.Tensor], group: Group, *,
                normalize: bool = False, dtype: torch.dtype = torch.float32,
                remat: bool = False) -> Tensors:
    """One row's text embeddings (B, embed_dim) f32 on every position, from
    its (B, context_length) token ids on every position; pooled at the EOT
    position (the argmax of the ids) after ``ln_final`` on the whole
    width."""
    t_cfg = cfg.text
    ids = [i.long() for i in token_ids]
    xs = [t["text"]["token_embedding"][i].to(dtype)
          for i, t in zip(ids, trees)]
    xs = [x + t["text"]["pos_embedding"].to(dtype)
          for x, t in zip(gather(xs, group, -1), trees)]
    xs = transformer(xs, [t["text"]["blocks"] for t in trees], t_cfg.heads,
                     group, causal=True, eps=cfg.layernorm_eps,
                     use_quick_gelu=cfg.quick_gelu, remat=remat)
    embs = []
    for x, i, t in zip(xs, ids, trees):
        p = t["text"]
        x = layer_norm(x, p["ln_final"], cfg.layernorm_eps)
        x = x[torch.arange(x.shape[0], device=x.device), i.argmax(dim=-1)]
        emb = _project(x, p["text_projection"])
        embs.append(_l2_normalize(emb) if normalize else emb)
    return embs
