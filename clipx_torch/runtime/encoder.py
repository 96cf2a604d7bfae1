"""The encoder service: batch-bucketed CLIP inference on one device.

Counterpart of ``clipx/runtime/encoder.py``. Image batches are padded up to
a small set of bucket sizes (1, 8, 32, 128, 256) and text batches to
(1, 4, 16, 64), as in clipx, so both packages run the same shapes (and the
ViT attention takes the same kernels: at S <= 64 even buckets
``fused_attn_block`` and bucket 1 ``packed_sdpa``; the long towers
ViT-B/16, ViT-L/14 and ViT-L/14@336px ``fused_sdpa_long`` in every bucket).
``attn_impl="pallas"`` sends the image tower through ``flash_attention``
instead; the text tower always takes ``"xla"``, as in clipx. On CUDA
every matrix param is stored in bf16 and the towers compute in bf16 with
f32 accumulation; 1-D params (LayerNorm, biases, the class embedding) stay
f32. On the CPU everything is f32. Embeddings come back float32 and
L2-normalized.

``compute_quant="int8"`` (or ``CLIPX_COMPUTE=int8``) runs the image
tower's MLP in W8A8 (``models.quant``; ``fused_mlp_w8a8`` under
``CLIPX_FUSED_MLP_INT8=on``), and with ``CLIPX_INT8_ATTN=on`` /
``CLIPX_INT8_PATCH=on`` its attention projections and patch embedding too.
The weights are quantized from the f32 source params, before the bf16
cast, as clipx does; the text tower is never quantized.

``encode_images_async`` enqueues one batch (pinned host buffer ->
non-blocking H2D copy -> encode -> non-blocking D2H copy into pinned host
memory, then a CUDA event) and returns at once; ``finalize`` waits on the
event. That takes the place of JAX's asynchronous dispatch in the
indexer's pipeline: the host decodes the next batch while the GPU encodes.

A batch whose side is not the model's input size is a square decode
canvas (``build_index --preprocess device``): ``device_resize_normalize``
resamples it on the device into the same tower. The ResNet towers (RN50
... RN50x64, ``models/resnet.py``) take the same buckets and canvas path;
``--compute int8`` is refused for them, as clipx refuses it.

``mesh=`` (a ``parallel.mesh.Mesh`` with one ``"dp"`` axis) is clipx's
data-parallel encode: the buckets round up to multiples of 2 * dp, so each
position's share is even and the batch-pair attention kernel applies to
it; each share is copied to its device and encoded there with that
device's replica of the params (one a distinct device; a device listed
twice encodes two shares), and the embeddings come back in row order. The
shares are queued one after another with no host synchronisation, so
several GPUs overlap. Text and ``encode_pixels`` run on the first device.

``mesh=`` with ``"dp"`` and ``"tp"`` axes and ``tp="tp"`` is clipx's dp x
tp encode: the params are TP-sharded (``mesh.shard_params``), each dp
row's share is copied to the row's tp positions and encoded by the
tensor-parallel forward of ``parallel/tensor.py``, and the embeddings come
back in row order; the text tower and ``encode_pixels`` run TP on the first
dp row. As in clipx, ``tp`` forces ``attn_impl="plain"`` (every requested
value, ``"pallas"`` included: the kernels consume full-width weight
blocks), and refuses the ResNet towers and ``CLIPX_COMPUTE=int8``. The XLA
compile cache has no counterpart.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from clipx_torch import config as config_lib
from clipx_torch.config import CLIPConfig
from clipx_torch.models import clip as model_lib
from clipx_torch.models import convert
from clipx_torch.models.layers import ATTN_IMPLS
from clipx_torch.ops.preprocess import (device_resize_normalize,
                                        normalize_batch, require_square)
from clipx_torch.parallel import mesh as mesh_lib
from clipx_torch.parallel import tensor as tensor_lib
from clipx_torch.parallel.distributed import Group
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
                 attn_impl: str = "auto",
                 batch_buckets: Sequence[int] = _DEFAULT_BUCKETS,
                 tokenizer: Optional[ClipTokenizer] = None,
                 compute_quant: Optional[str] = None,
                 mesh: Optional[mesh_lib.Mesh] = None, tp=None):
        vit = getattr(cfg.vision, "tower", "vit") == "vit"
        if tp is not None and not vit:
            raise ValueError(
                "tensor parallelism is not defined for the ResNet towers "
                "(no TP sharding rules for convs; RN50 fits one chip "
                "comfortably) — use a dp-only mesh")
        if mesh is not None:
            if "dp" not in mesh.axis_names:
                raise ValueError("encoder mesh must have a 'dp' axis")
            axes = {"dp", tp} if tp in mesh.axis_names else {"dp"}
            if set(mesh.axis_names) != axes or mesh.multi_process:
                raise ValueError("an encoder mesh is one 'dp' axis (and the "
                                 "'tp' axis named by tp=) in one process, "
                                 f"got {mesh}")
            device = mesh.devices[0]
            # every bucket splits evenly over dp, into even shares
            grain = 2 * mesh.shape["dp"]
            batch_buckets = {max(grain, -(-b // grain) * grain)
                             for b in batch_buckets}
        self.mesh = mesh
        quant = (compute_quant if compute_quant is not None
                 else os.environ.get("CLIPX_COMPUTE", ""))
        if quant not in ("", "bf16", "int8"):
            raise ValueError(f"unknown compute mode {quant!r} "
                             "(CLIPX_COMPUTE: bf16 or int8)")
        self.compute_quant = quant if quant == "int8" else None
        if self.compute_quant and not vit:
            raise ValueError("CLIPX_COMPUTE=int8 is implemented for "
                             "the ViT towers (the RN family fits its "
                             "budget in bf16)")
        if self.compute_quant and tp is not None:
            raise ValueError("CLIPX_COMPUTE=int8 with tensor "
                             "parallelism is not supported (no TP "
                             "sharding rules for the quantized MLP)")
        if tp is not None:
            # the kernels consume full-width weight blocks: a TP shard
            # takes plain attention, an explicit "pallas" included
            attn_impl = "plain"
        if attn_impl == "auto":
            # "xla" lets mha_block pick the fused kernels per shape;
            # "pallas" forces the (B, H, S, D) flash_attention kernel
            attn_impl = "xla"
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r} (auto or one "
                             f"of {ATTN_IMPLS})")
        self.attn_impl = attn_impl
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = (torch.bfloat16 if self.device.type == "cuda"
                      else torch.float32)
        self.tokenizer = tokenizer or ClipTokenizer()
        self.buckets = tuple(sorted(batch_buckets))
        if self.compute_quant:
            params = self._quantized(params)
        self._rows = None
        if mesh is not None and tp in mesh.axis_names:
            # one tree a distinct (device, tp column); one group a dp row
            self.params = mesh_lib.shard_params(params, mesh, tp,
                                                dtype=self.dtype)
            self._rows = [Group(mesh, r) for r in mesh.groups(tp)]
        else:
            self.params = self._placed(params, self.device)
            # one replica a distinct device of the dp mesh
            self._params_on = {self.device: self.params}
            if mesh is not None:
                self._params_on = mesh_lib.replicas(
                    mesh, lambda dev: self._placed(params, dev),
                    self._params_on)

    def _placed(self, params, device):
        """The param tree on ``device`` in the compute dtype, with the
        layout fused_attn_block, packed_sdpa_qkv and fused_sdpa_long_qkv
        consume built once: [wq | wk | wv] a layer, wq/wk/wv views into it
        (no second copy). W8A8 attention has no wq/wk/wv and does not use
        it, nor do the ResNet towers."""
        tree = convert.from_jax_params(params, self.cfg, device, self.dtype)
        vit = getattr(self.cfg.vision, "tower", "vit") == "vit"
        attn = tree["visual"]["blocks"]["attn"] if vit else {}
        if vit and "wq_q" not in attn:
            w = attn["wq"].shape[-1]
            attn["wqkv"] = torch.cat([attn["wq"], attn["wk"], attn["wv"]], -1)
            attn["bqkv"] = torch.cat([attn["bq"], attn["bk"], attn["bv"]], -1)
            for i, name in enumerate(("wq", "wk", "wv")):
                attn[name] = attn["wqkv"][..., i * w:(i + 1) * w]
        return tree

    def _quantized(self, params):
        """The param tree with the image tower's MLP (and, under
        CLIPX_INT8_ATTN / CLIPX_INT8_PATCH, its attention projections and
        patch embedding) in int8, quantized on the device from the f32
        source params (quantizing bf16 copies would give other codes)."""
        from clipx_torch.models import quant as quant_lib

        def f32(tree):
            return {k: f32(v) if isinstance(v, dict) else torch.from_numpy(
                np.array(v, np.float32)).to(self.device)
                for k, v in tree.items()}

        visual = dict(params["visual"])
        blocks = dict(visual["blocks"])
        blocks["mlp"] = quant_lib.quantize_mlp_stack(f32(blocks["mlp"]))
        if os.environ.get("CLIPX_INT8_ATTN", "off") == "on":
            blocks["attn"] = quant_lib.quantize_attn_stack(f32(blocks["attn"]))
        if os.environ.get("CLIPX_INT8_PATCH", "off") == "on":
            visual["patch_embed"] = quant_lib.quantize_patch_embed(
                f32(visual["patch_embed"]))
        visual["blocks"] = blocks
        return dict(params, visual=visual)

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

    def _pixels(self, batch: torch.Tensor) -> torch.Tensor:
        # batches at the model input size go straight to encode; other
        # square canvases are resampled on the device first
        if batch.shape[1] == self.image_size:
            return normalize_batch(batch, dtype=self.dtype)
        return device_resize_normalize(batch, self.image_size,
                                       dtype=self.dtype)

    def _images(self, batch: torch.Tensor, params) -> torch.Tensor:
        return model_lib.encode_image(params, self.cfg, self._pixels(batch),
                                      normalize=True, dtype=self.dtype,
                                      attn_impl=self.attn_impl)

    def _on_row(self, row: Group, host: torch.Tensor):
        """``host`` on each of the row's positions (one copy a device) and
        the row's trees, for the tensor-parallel forward."""
        cuda = self.device.type == "cuda"
        copies = {}
        for dev in row.devices:
            if dev not in copies:
                copies[dev] = host.to(dev, non_blocking=cuda)
        return ([copies[dev] for dev in row.devices],
                [self.params.trees[p] for p in row.local])

    def _tp_images(self, row: Group, host: torch.Tensor) -> torch.Tensor:
        """One dp row's share encoded over its tp positions; the embeddings
        of its first position."""
        batches, trees = self._on_row(row, host)
        pixels = {id(b): self._pixels(b) for b in batches}
        return tensor_lib.encode_image(
            trees, self.cfg, [pixels[id(b)] for b in batches], row,
            normalize=True, dtype=self.dtype)[0]

    def encode_images(self, batch_uint8: np.ndarray) -> np.ndarray:
        """(B, S, S, 3) uint8 -> (B, embed_dim) float32, L2-normalized.
        S is the model's input size or any square canvas side. Pads to the
        nearest batch bucket; oversized batches are chunked."""
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
        require_square(*batch_uint8.shape[1:3])
        rows = _pick_bucket(n, self.buckets)
        host = torch.from_numpy(_pad_rows(batch_uint8, rows))
        cuda = self.device.type == "cuda"
        if cuda:
            host = host.pin_memory()
        if self.mesh is None:
            shares = [(slice(0, rows), self.device)]
        elif self._rows is not None:  # one even share a dp row
            shares = list(zip(mesh_lib.split_batch(rows, self.mesh),
                              self._rows))
        else:  # one even share a dp position, each on its device
            shares = list(zip(mesh_lib.split_batch(rows, self.mesh),
                              self.mesh.devices))
        result = torch.empty((rows, self.embed_dim), dtype=torch.float32,
                             pin_memory=cuda)
        events = []
        with torch.inference_mode():
            for rows_of, where in shares:
                if isinstance(where, Group):
                    out = self._tp_images(where, host[rows_of])
                    dev = where.devices[0]
                else:
                    dev = where
                    out = self._images(host[rows_of].to(
                        dev, non_blocking=cuda), self._params_on[dev])
                result[rows_of].copy_(out, non_blocking=cuda)
                if cuda:
                    events.append(torch.cuda.Event())
                    events[-1].record(torch.cuda.current_stream(dev))
        # the pinned input stays referenced until the copies have run
        return (result, events, n, host)

    @staticmethod
    def finalize(handle) -> np.ndarray:
        """Wait for an encode_images_async handle; host (n, D) float32."""
        result, events, n, _ = handle
        for event in events:
            event.synchronize()
        return result[:n].numpy().copy()

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        """Pre-normalized float pixels (B, H, W, 3) or (H, W, 3)."""
        pixels = np.asarray(pixels, dtype=np.float32)
        if pixels.ndim == 3:
            pixels = pixels[None]
        with torch.inference_mode():
            if self._rows is not None:
                batches, trees = self._on_row(self._rows[0],
                                              torch.from_numpy(pixels))
                out = tensor_lib.encode_image(
                    trees, self.cfg, batches, self._rows[0], normalize=True,
                    dtype=self.dtype)[0]
            else:
                out = model_lib.encode_image(
                    self.params, self.cfg,
                    torch.from_numpy(pixels).to(self.device, self.dtype),
                    normalize=True, dtype=self.dtype,
                    attn_impl=self.attn_impl)
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
            if self._rows is not None:
                batches, trees = self._on_row(self._rows[0],
                                              torch.from_numpy(ids))
                out = tensor_lib.encode_text(
                    trees, self.cfg, batches, self._rows[0], normalize=True,
                    dtype=self.dtype)[0]
            else:
                # the 77-token text tower always takes "xla", as in clipx
                out = model_lib.encode_text(
                    self.params, self.cfg,
                    torch.from_numpy(ids).to(self.device), normalize=True,
                    dtype=self.dtype, attn_impl="xla")
            return out[:n].float().cpu().numpy()

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once (builds the CUDA kernels, warms the
        allocator and cuBLAS) so the first real batch is not slow."""
        s = self.image_size
        for b in (buckets or self.buckets):
            self.encode_images(np.zeros((b, s, s, 3), np.uint8))
        self.encode_texts(["warmup"])
