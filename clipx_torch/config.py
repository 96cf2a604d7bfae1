"""Model/engine configuration (the port's own copy of ``clipx.config``).

The reference hardcodes CLIP "ViT-B/32" (reference:build-index.py:18,
reference:query-index.py:21) and a 512-d shared embedding space. We keep
those as named presets and add ViT-L/14@336 as the high-resolution stress
configuration (BASELINE.json config 3).

SigLIP so400m/14@384 (Zhai et al., arXiv:2303.15343; the so400m shape of
arXiv:2305.13035; ``google/siglip-so400m-patch14-384``'s config.json) is
the other ViT family: no class token and no ``ln_pre``, a patch embedding
with a bias, an MLP of 4304 rather than 4 x width, tanh GELU, LayerNorm eps
1e-6, an attention-pooling ("MAP") head in place of the class token's
projection, and a bidirectional text tower read at its last position through
a linear head. Its settings are the fields of ``SigLIPVisionConfig``,
``SigLIPTextConfig`` and ``SigLIPConfig``; the OpenAI CLIP classes carry the
same names as class attributes holding OpenAI CLIP's values, so the model
code reads one name for both and the CLIP configs keep exactly their fields.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    # output dim of the learned projection into the shared space
    embed_dim: int = 512

    tower = "vit"  # class attribute, not a field — used for dispatch
    # OpenAI CLIP's ViT (SigLIPVisionConfig makes these fields): a class
    # token, ln_pre, a patch embedding without a bias, the class token's
    # feature projected by ``proj``
    class_token = True
    ln_pre = True
    patch_bias = False
    pool = "cls"  # or "map": the attention-pooling head

    @property
    def mlp_dim(self) -> int:
        return 4 * self.width

    @property
    def grid(self) -> int:
        # a "valid" patch convolution: a remainder of rows and columns
        # (384 = 27 * 14 + 6) is never read
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        # class token (where there is one) + patch tokens
        return self.grid * self.grid + int(self.class_token)


@dataclasses.dataclass(frozen=True)
class SigLIPVisionConfig(VisionConfig):
    """SigLIP's image tower: ``embed_dim`` is the width (the MAP head's
    output is the embedding, with no projection)."""

    mlp_dim: int = 4304
    class_token: bool = False
    ln_pre: bool = False
    patch_bias: bool = True
    pool: str = "map"


@dataclasses.dataclass(frozen=True)
class ResNetVisionConfig:
    """OpenAI CLIP's ModifiedResNet image tower (the RN50/RN101/RN50x*
    checkpoints ``clip.load`` accepts alongside the ViTs). Differences
    from a torchvision ResNet, preserved here: 3-conv anti-aliased stem,
    avgpool(stride)-then-conv "blur" downsampling inside bottlenecks,
    and a single-query attention pool instead of global average pool."""

    image_size: int = 224
    # bottleneck counts of the four stages
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    # stem output channels; stage i runs at width * 2**i (expansion 4x)
    width: int = 64
    embed_dim: int = 1024

    tower = "resnet"

    @property
    def heads(self) -> int:
        # attention-pool heads, matching the torch construction
        return self.width * 32 // 64

    @property
    def pool_dim(self) -> int:
        # channels entering the attention pool (stage-4 output)
        return self.width * 32

    @property
    def grid(self) -> int:
        # total stride 32: stem /4, stages 2-4 /2 each
        return self.image_size // 32


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512

    # OpenAI CLIP's text tower (SigLIPTextConfig makes these fields):
    # causal, read at the end-of-text token (the ids' argmax) and projected
    # by ``text_projection``
    causal = True
    pool = "eot"  # or "last": the last position, through a linear head

    @property
    def mlp_dim(self) -> int:
        return 4 * self.width


@dataclasses.dataclass(frozen=True)
class SigLIPTextConfig(TextConfig):
    mlp_dim: int = 4304
    causal: bool = False
    pool: str = "last"


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    vision: VisionConfig
    text: TextConfig
    # QuickGELU (x * sigmoid(1.702 x)) is what OpenAI CLIP uses; keep it
    # switchable for HF checkpoints trained with exact GELU.
    quick_gelu: bool = True
    layernorm_eps: float = 1e-5
    # preprocessing constants — must match OpenAI CLIP bit-for-bit for
    # embedding parity (SURVEY.md section 2b D1p)
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    # OpenAI CLIP's (SigLIPConfig makes these fields): the shorter side
    # resized to the input size, then a centre crop; no logit bias; the
    # text tower reads CLIP's BPE ids
    center_crop = True
    logit_bias = False
    tokenizer = "clip_bpe"

    @property
    def embed_dim(self) -> int:
        return self.vision.embed_dim

    @property
    def activation(self) -> str:
        """The MLP's activation: ``quick_gelu``, ``gelu`` (exact, erf) or
        ``gelu_tanh``."""
        return "quick_gelu" if self.quick_gelu else "gelu"


@dataclasses.dataclass(frozen=True)
class SigLIPConfig(CLIPConfig):
    """SigLIP: tanh GELU, a resize to the input size with no crop, mean and
    std 0.5, eps 1e-6, the logits' learned bias, a SentencePiece vocabulary
    of 32,000 (whose model the port does not ship: its text tower runs from
    token ids)."""

    quick_gelu: bool = False
    layernorm_eps: float = 1e-6
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    activation: str = "gelu_tanh"
    center_crop: bool = False
    logit_bias: bool = True
    tokenizer: str = "sentencepiece"


def vit_b32() -> CLIPConfig:
    """CLIP ViT-B/32 — the reference's model (reference:build-index.py:18)."""
    return CLIPConfig(
        name="ViT-B/32",
        vision=VisionConfig(image_size=224, patch_size=32, width=768,
                            layers=12, heads=12, embed_dim=512),
        text=TextConfig(width=512, layers=12, heads=8, embed_dim=512),
    )


def vit_b16() -> CLIPConfig:
    return CLIPConfig(
        name="ViT-B/16",
        vision=VisionConfig(image_size=224, patch_size=16, width=768,
                            layers=12, heads=12, embed_dim=512),
        text=TextConfig(width=512, layers=12, heads=8, embed_dim=512),
    )


def vit_l14() -> CLIPConfig:
    return CLIPConfig(
        name="ViT-L/14",
        vision=VisionConfig(image_size=224, patch_size=14, width=1024,
                            layers=24, heads=16, embed_dim=768),
        text=TextConfig(width=768, layers=12, heads=12, embed_dim=768),
    )


def vit_l14_336() -> CLIPConfig:
    """ViT-L/14@336 — the long-sequence (577 tokens) stress config."""
    return CLIPConfig(
        name="ViT-L/14@336px",
        vision=VisionConfig(image_size=336, patch_size=14, width=1024,
                            layers=24, heads=16, embed_dim=768),
        text=TextConfig(width=768, layers=12, heads=12, embed_dim=768),
    )


def siglip_so400m_384() -> SigLIPConfig:
    """SigLIP so400m/14@384 (``google/siglip-so400m-patch14-384``): 27 + 27
    blocks of width 1152, 16 heads (head dim 72), MLP 4304, 729 patch
    tokens, the MAP head; 1152-d embeddings."""
    return SigLIPConfig(
        name="SigLIP-so400m/14@384",
        vision=SigLIPVisionConfig(image_size=384, patch_size=14, width=1152,
                                  layers=27, heads=16, embed_dim=1152,
                                  mlp_dim=4304),
        text=SigLIPTextConfig(context_length=64, vocab_size=32000,
                              width=1152, layers=27, heads=16,
                              embed_dim=1152, mlp_dim=4304),
    )


def _rn(name: str, layers, width: int, image: int, embed: int,
        t_width: int) -> CLIPConfig:
    """The five ResNet checkpoints OpenAI CLIP ships (``clip.load``'s
    model list next to the ViTs the reference uses). Text-tower heads
    follow the torch rule transformer_width // 64."""
    return CLIPConfig(
        name=name,
        vision=ResNetVisionConfig(image_size=image, layers=tuple(layers),
                                  width=width, embed_dim=embed),
        text=TextConfig(width=t_width, layers=12, heads=t_width // 64,
                        embed_dim=embed),
    )


def rn50() -> CLIPConfig:
    return _rn("RN50", (3, 4, 6, 3), 64, 224, 1024, 512)


def rn101() -> CLIPConfig:
    return _rn("RN101", (3, 4, 23, 3), 64, 224, 512, 512)


def rn50x4() -> CLIPConfig:
    return _rn("RN50x4", (4, 6, 10, 6), 80, 288, 640, 640)


def rn50x16() -> CLIPConfig:
    return _rn("RN50x16", (6, 8, 18, 8), 96, 384, 768, 768)


def rn50x64() -> CLIPConfig:
    return _rn("RN50x64", (3, 15, 36, 10), 128, 448, 1024, 1024)


def tiny_test() -> CLIPConfig:
    """Minimal config for fast CPU unit tests (not a real model)."""
    return CLIPConfig(
        name="tiny-test",
        vision=VisionConfig(image_size=32, patch_size=16, width=64,
                            layers=2, heads=2, embed_dim=32),
        text=TextConfig(context_length=77, vocab_size=49408, width=32,
                        layers=2, heads=2, embed_dim=32),
    )


def tiny_rn_test() -> CLIPConfig:
    """Minimal ResNet-tower config for fast CPU unit tests."""
    return CLIPConfig(
        name="tiny-rn-test",
        vision=ResNetVisionConfig(image_size=32, layers=(1, 1, 1, 1),
                                  width=8, embed_dim=32),
        text=TextConfig(context_length=77, vocab_size=49408, width=32,
                        layers=2, heads=2, embed_dim=32),
    )


PRESETS = {
    "ViT-B/32": vit_b32,
    "ViT-B/16": vit_b16,
    "ViT-L/14": vit_l14,
    "ViT-L/14@336px": vit_l14_336,
    "SigLIP-so400m/14@384": siglip_so400m_384,
    "RN50": rn50,
    "RN101": rn101,
    "RN50x4": rn50x4,
    "RN50x16": rn50x16,
    "RN50x64": rn50x64,
    "tiny-test": tiny_test,
    "tiny-rn-test": tiny_rn_test,
}


def get_config(name: str) -> CLIPConfig:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown model preset {name!r}; "
                         f"available: {sorted(PRESETS)}") from None
