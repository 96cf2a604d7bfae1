"""Model/engine configuration (the port's own copy of ``clipx.config``).

The reference hardcodes CLIP "ViT-B/32" (reference:build-index.py:18,
reference:query-index.py:21) and a 512-d shared embedding space. We keep
those as named presets and add ViT-L/14@336 as the high-resolution stress
configuration (BASELINE.json config 3).
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

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        # CLS token + patch tokens
        return self.grid * self.grid + 1


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

    @property
    def embed_dim(self) -> int:
        return self.vision.embed_dim


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
