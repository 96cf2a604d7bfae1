"""ModifiedResNet image tower — the RN50/RN101/RN50x* CLIP models (PyTorch).

Counterpart of ``clipx/models/resnet.py``, with its functions under the
same names. OpenAI's published architecture: a 3-conv anti-aliased stem,
bottlenecks that downsample with avgpool(stride) before the conv ("blur
pool"), and a single-query attention pool that produces the joint-space
embedding.

Layouts. Pixels arrive NHWC, as clipx takes them; the tower runs on the
NCHW view of that memory (``permute(0, 3, 1, 2)``), which is PyTorch's
channels_last format, so cuDNN's NHWC convolutions read and write it
without a copy. The param tree keeps clipx's layout: HWIO conv kernels
(``(L, kh, kw, I, O)`` in a stage's stacked ``rest``), folded-BN
``scale``/``bias``, each stage's ``first`` and ``rest``.
``convert.from_jax_params`` stores each kernel with its memory in (O, kh, kw,
I) order, so ``conv2d``'s ``permute(3, 2, 0, 1)`` is an OIHW kernel in
channels_last memory: converted once per weight, never per call.

Numerics, as clipx: convolutions accumulate in f32; the BN affine and the
residual add run in f32 before the cast back to the compute dtype;
``avg_pool`` divides in f32. A stage's ``rest`` runs as a Python loop over
its leading axis (clipx uses ``lax.scan``). cuDNN's bf16 convolution
returns bf16, one rounding more than clipx (which applies BN to the f32
result); in f32 the two agree. The attention pool is plain matmul and
softmax, as clipx leaves it to XLA: no kernel of the port's serves this
tower.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from clipx_torch.config import CLIPConfig
from clipx_torch.models.layers import dense, layer_slice

Params = Dict[str, Any]

_BN_EPS = 1e-5  # torch BatchNorm2d default, baked into the folded affine


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """Conv of an NCHW (channels_last) activation with an HWIO kernel;
    returns f32 (f32 accumulation; on the card cuDNN rounds its bf16
    output once before the upcast)."""
    return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                    padding=padding).float()


def _bn(x32: torch.Tensor, p: Params) -> torch.Tensor:
    """Folded-BN affine on an f32 activation (channels on dim 1)."""
    return (x32 * p["scale"].float()[:, None, None]
            + p["bias"].float()[:, None, None])


def _conv_bn(x: torch.Tensor, w: torch.Tensor, bn: Params, *,
             stride: int = 1, padding: int = 0,
             relu: bool = True) -> torch.Tensor:
    y = _bn(conv2d(x, w, stride=stride, padding=padding), bn)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k average pool (torch AvgPool2d(k)), in f32."""
    if k == 1:
        return x
    return F.avg_pool2d(x.float(), k).to(x.dtype)


# ---------------------------------------------------------------------------
# bottleneck blocks
# ---------------------------------------------------------------------------

def _bottleneck(x: torch.Tensor, p: Params, *, stride: int,
                downsample: bool) -> torch.Tensor:
    """conv1x1-bn-relu, conv3x3-bn-relu, avgpool(stride), conv1x1-bn,
    residual add, relu. The shortcut of a stage-opening block is
    avgpool(stride) -> conv1x1 -> bn."""
    out = _conv_bn(x, p["conv1"], p["bn1"])
    out = _conv_bn(out, p["conv2"], p["bn2"], padding=1)
    out = avg_pool(out, stride)
    out = _bn(conv2d(out, p["conv3"]), p["bn3"])  # f32, relu after the add
    if downsample:
        idt = _bn(conv2d(avg_pool(x, stride), p["down_conv"]), p["down_bn"])
    else:
        idt = x.float()
    return torch.relu(out + idt).to(x.dtype)


def _stage(x: torch.Tensor, p: Params, *, stride: int) -> torch.Tensor:
    x = _bottleneck(x, p["first"], stride=stride, downsample=True)
    if "rest" in p:
        for i in range(p["rest"]["conv1"].shape[0]):
            x = _bottleneck(x, layer_slice(p["rest"], i), stride=1,
                            downsample=False)
    return x


# ---------------------------------------------------------------------------
# attention pool
# ---------------------------------------------------------------------------

def _attention_pool(x: torch.Tensor, p: Params, heads: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, out_dim): the mean token queries all spatial
    tokens (and itself) through one multi-head attention, then c_proj
    maps into the joint space. Scores, softmax and the weighted sum are
    f32 (clipx's ``preferred_element_type=f32`` einsums)."""
    b, c, h, w = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = (x.float() + p["pos_embedding"].float()).to(x.dtype)
    d = c // heads
    q = dense(x[:, :1], p["wq"], p["bq"]).reshape(b, 1, heads, d)
    k = dense(x, p["wk"], p["bk"]).reshape(b, -1, heads, d)
    v = dense(x, p["wv"], p["bv"]).reshape(b, -1, heads, d)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B, heads, S, d)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        d ** -0.5)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)
    out = out.transpose(1, 2).reshape(b, 1, c)[:, 0]
    return dense(out, p["wc"], p["bc"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def encode_image(params: Params, cfg: CLIPConfig, pixels: torch.Tensor, *,
                 normalize: bool = False, dtype: torch.dtype = torch.float32,
                 **_unused) -> torch.Tensor:
    """ResNet-tower image embeddings (B, embed_dim) float32 from (B, H, W,
    3) pixels preprocessed exactly like the ViT path. ``normalize=True``
    L2-normalizes. Extra kwargs (``attn_impl``) are accepted for
    signature parity with the ViT tower and ignored."""
    p = params["visual"]
    x = pixels.to(dtype).permute(0, 3, 1, 2)       # NCHW view, channels_last
    s = p["stem"]
    x = _conv_bn(x, s["conv1"], s["bn1"], stride=2, padding=1)
    x = _conv_bn(x, s["conv2"], s["bn2"], padding=1)
    x = _conv_bn(x, s["conv3"], s["bn3"], padding=1)
    x = avg_pool(x, 2)
    for i in range(4):
        x = _stage(x, p[f"stage{i + 1}"], stride=1 if i == 0 else 2)
    emb = _attention_pool(x, p["attnpool"], cfg.vision.heads).float()
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb


# ---------------------------------------------------------------------------
# init (numpy's generator) and the BN fold
# ---------------------------------------------------------------------------

def _init_bn(c: int) -> Params:
    return {"scale": np.ones((c,), np.float32),
            "bias": np.zeros((c,), np.float32)}


def _init_conv(rng: np.random.Generator, kh: int, kw: int, cin: int,
               cout: int) -> np.ndarray:
    fan_in = kh * kw * cin
    return (rng.standard_normal((kh, kw, cin, cout), dtype=np.float32)
            * np.float32(fan_in ** -0.5))


def _init_block(rng: np.random.Generator, cin: int, planes: int,
                downsample: bool) -> Params:
    p = {
        "conv1": _init_conv(rng, 1, 1, cin, planes),
        "bn1": _init_bn(planes),
        "conv2": _init_conv(rng, 3, 3, planes, planes),
        "bn2": _init_bn(planes),
        "conv3": _init_conv(rng, 1, 1, planes, planes * 4),
        "bn3": _init_bn(planes * 4),
    }
    if downsample:
        p["down_conv"] = _init_conv(rng, 1, 1, cin, planes * 4)
        p["down_bn"] = _init_bn(planes * 4)
    return p


def _stack_blocks(blocks) -> Params:
    return {k: _stack_blocks([b[k] for b in blocks])
            if isinstance(blocks[0][k], dict)
            else np.stack([b[k] for b in blocks], axis=0)
            for k in blocks[0]}


def init_visual(cfg: CLIPConfig, rng: np.random.Generator) -> Params:
    """Seeded numpy params with the shapes and stds of
    ``clipx.models.resnet.init_visual`` (numpy's generator, not
    ``jax.random``, so the numbers differ from clipx's for one seed)."""
    v = cfg.vision
    w = v.width

    def nrm(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    out: Params = {"stem": {
        "conv1": _init_conv(rng, 3, 3, 3, w // 2), "bn1": _init_bn(w // 2),
        "conv2": _init_conv(rng, 3, 3, w // 2, w // 2),
        "bn2": _init_bn(w // 2),
        "conv3": _init_conv(rng, 3, 3, w // 2, w), "bn3": _init_bn(w),
    }}
    cin = w
    for i, n_blocks in enumerate(v.layers):
        planes = w * (2 ** i)
        stage: Params = {"first": _init_block(rng, cin, planes, True)}
        if n_blocks > 1:
            stage["rest"] = _stack_blocks(
                [_init_block(rng, planes * 4, planes, False)
                 for _ in range(n_blocks - 1)])
        out[f"stage{i + 1}"] = stage
        cin = planes * 4
    c = v.pool_dim
    out["attnpool"] = {
        "pos_embedding": nrm((v.grid * v.grid + 1, c), c ** -0.5),
        "wq": nrm((c, c), c ** -0.5), "bq": np.zeros((c,), np.float32),
        "wk": nrm((c, c), c ** -0.5), "bk": np.zeros((c,), np.float32),
        "wv": nrm((c, c), c ** -0.5), "bv": np.zeros((c,), np.float32),
        "wc": nrm((c, v.embed_dim), c ** -0.5),
        "bc": np.zeros((v.embed_dim,), np.float32),
    }
    return out


def fold_bn(gamma: np.ndarray, beta: np.ndarray, mean: np.ndarray,
            var: np.ndarray, eps: float = _BN_EPS) -> Params:
    """Inference BatchNorm -> per-channel affine (host-side, float32)."""
    scale = gamma / np.sqrt(var + eps)
    return {"scale": np.asarray(scale, np.float32),
            "bias": np.asarray(beta - mean * scale, np.float32)}
