"""The encoder service: batch-bucketed CLIP inference on one device.

Counterpart of ``clipx/runtime/encoder.py``. Image batches are padded up to
a small set of bucket sizes (1, 8, 32, 128, 256) and text batches to
(1, 4, 16, 64), as in clipx, so both packages run the same shapes (and the
ViT attention takes the same kernels: even buckets ``fused_attn_block``,
bucket 1 ``packed_sdpa``). On CUDA every matrix param is stored in bf16 and
the towers compute in bf16 with f32 accumulation; 1-D params (LayerNorm,
biases, the class embedding) stay f32. On the CPU everything is f32.
Embeddings come back float32 and L2-normalized.

``encode_images_async`` enqueues one batch (pinned host buffer ->
non-blocking H2D copy -> encode -> non-blocking D2H copy into pinned host
memory, then a CUDA event) and returns at once; ``finalize`` waits on the
event. That takes the place of JAX's asynchronous dispatch in the
indexer's pipeline: the host decodes the next batch while the GPU encodes.

Not ported yet: the dp mesh, int8 compute (``CLIPX_COMPUTE=int8``), the
fused device-side resample (``--preprocess device``) and the ResNet
towers. The XLA compile cache has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from clipx_torch import config as config_lib
from clipx_torch.config import CLIPConfig
from clipx_torch.models import clip as model_lib
from clipx_torch.models import convert
from clipx_torch.ops.preprocess import normalize_batch
from clipx_torch.runtime.device import resolve_device
from clipx_torch.text.tokenizer import ClipTokenizer

_DEFAULT_BUCKETS = (1, 8, 32, 128, 256)
_TEXT_BUCKETS = (1, 4, 16, 64)


def _pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


class Encoder:
    """Holds (config, params on the device) and encodes images and texts."""

    def __init__(self, cfg: CLIPConfig, params, *, device=None,
                 batch_buckets: Sequence[int] = _DEFAULT_BUCKETS,
                 tokenizer: Optional[ClipTokenizer] = None):
        if getattr(cfg.vision, "tower", "vit") != "vit":
            raise NotImplementedError("the ResNet towers are not ported to "
                                      "clipx_torch yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if self.device.type == "cuda"
                      else torch.float32)
        self.tokenizer = tokenizer or ClipTokenizer()
        self.buckets = tuple(sorted(batch_buckets))
        self.params = convert.from_jax_params(params, cfg, self.device,
                                              self.dtype)
        # the layout fused_attn_block consumes, built once: [wq | wk | wv]
        # per layer; wq/wk/wv become views into it (no second copy)
        attn = self.params["visual"]["blocks"]["attn"]
        w = attn["wq"].shape[-1]
        attn["wqkv"] = torch.cat([attn["wq"], attn["wk"], attn["wv"]], -1)
        attn["bqkv"] = torch.cat([attn["bq"], attn["bk"], attn["bv"]], -1)
        for i, name in enumerate(("wq", "wk", "wv")):
            attn[name] = attn["wqkv"][..., i * w:(i + 1) * w]

    # -- construction ---------------------------------------------------------
    @classmethod
    def create(cls, model: str = "ViT-B/32",
               checkpoint: Optional[str] = None, seed: int = 0,
               **kw) -> "Encoder":
        """Build from a preset name and an optional checkpoint: an .npz
        from ``save_params`` (either package's), or a torch .pt state dict
        (OpenAI or HuggingFace layout). Without one, seeded random weights
        (``convert.init_params``; numpy's generator, not clipx's)."""
        cfg = config_lib.get_config(model)
        if checkpoint is None:
            params = convert.init_params(cfg, seed)
        elif checkpoint.endswith(".npz"):
            params = convert.load_params(checkpoint)
        else:
            params = convert.load_torch_checkpoint(checkpoint, cfg)
        return cls(cfg, params, **kw)

    # -- API ------------------------------------------------------------------
    @property
    def image_size(self) -> int:
        return self.cfg.vision.image_size

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim

    def _images(self, batch: torch.Tensor) -> torch.Tensor:
        pixels = normalize_batch(batch, dtype=self.dtype)
        return model_lib.encode_image(self.params, self.cfg, pixels,
                                      normalize=True, dtype=self.dtype)

    def encode_images(self, batch_uint8: np.ndarray) -> np.ndarray:
        """(B, S, S, 3) uint8 -> (B, embed_dim) float32, L2-normalized.
        Pads to the nearest batch bucket; oversized batches are chunked."""
        batch_uint8 = np.ascontiguousarray(batch_uint8, dtype=np.uint8)
        cap = self.buckets[-1]
        if batch_uint8.shape[0] > cap:
            return np.concatenate([
                self.encode_images(batch_uint8[i: i + cap])
                for i in range(0, batch_uint8.shape[0], cap)], axis=0)
        return self.finalize(self.encode_images_async(batch_uint8))

    def encode_images_async(self, batch_uint8: np.ndarray):
        """Enqueue one batch without waiting; returns a handle for
        :meth:`finalize`. Holding two or more handles in flight overlaps
        the GPU's encode with the host's decode and writeback."""
        batch_uint8 = np.ascontiguousarray(batch_uint8, dtype=np.uint8)
        n = batch_uint8.shape[0]
        if n > self.buckets[-1]:
            raise ValueError(f"async batch exceeds bucket cap "
                             f"{self.buckets[-1]}")
        if batch_uint8.shape[1:3] != (self.image_size, self.image_size):
            raise NotImplementedError(
                f"batches must be {self.image_size}x{self.image_size} (the "
                "on-device resample of larger canvases is not ported yet)")
        host = torch.from_numpy(_pad_rows(batch_uint8,
                                          _pick_bucket(n, self.buckets)))
        cuda = self.device.type == "cuda"
        if cuda:
            host = host.pin_memory()
        with torch.inference_mode():
            out = self._images(host.to(self.device, non_blocking=cuda))
            result = torch.empty(out.shape, dtype=torch.float32,
                                 pin_memory=cuda)
            result.copy_(out, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        # the pinned input stays referenced until the copy has run
        return (result, event, n, host)

    @staticmethod
    def finalize(handle) -> np.ndarray:
        """Wait for an encode_images_async handle; host (n, D) float32."""
        result, event, n, _ = handle
        if event is not None:
            event.synchronize()
        return result[:n].numpy().copy()

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        """Pre-normalized float pixels (B, H, W, 3) or (H, W, 3)."""
        pixels = np.asarray(pixels, dtype=np.float32)
        if pixels.ndim == 3:
            pixels = pixels[None]
        with torch.inference_mode():
            out = model_lib.encode_image(
                self.params, self.cfg,
                torch.from_numpy(pixels).to(self.device, self.dtype),
                normalize=True, dtype=self.dtype)
            return out.float().cpu().numpy()

    def encode_texts(self, texts) -> np.ndarray:
        """str or list[str] -> (N, embed_dim) float32, L2-normalized. Token
        rows pad to the text buckets; padding rows (all-zero ids) are
        sliced away."""
        if isinstance(texts, str):
            texts = [texts]
        ids = self.tokenizer(texts,
                             context_length=self.cfg.text.context_length)
        cap = _TEXT_BUCKETS[-1]
        return np.concatenate([
            self._encode_text_bucketed(ids[i: i + cap])
            for i in range(0, ids.shape[0], cap)], axis=0)

    def _encode_text_bucketed(self, ids: np.ndarray) -> np.ndarray:
        n = ids.shape[0]
        ids = _pad_rows(ids, _pick_bucket(n, _TEXT_BUCKETS))
        with torch.inference_mode():
            out = model_lib.encode_text(
                self.params, self.cfg, torch.from_numpy(ids).to(self.device),
                normalize=True, dtype=self.dtype)
            return out[:n].float().cpu().numpy()

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once (builds the CUDA kernels, warms the
        allocator and cuBLAS) so the first real batch is not slow."""
        s = self.image_size
        for b in (buckets or self.buckets):
            self.encode_images(np.zeros((b, s, s, 3), np.uint8))
        self.encode_texts(["warmup"])
