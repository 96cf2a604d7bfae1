"""``python -m clipx_torch.cli.train DATA/ ...`` — contrastive fine-tuning.

Counterpart of ``clipx/cli/train.py``, with its flags (plus ``--device
{cuda,cpu}``, default ``cuda``) and its stdout line for line (apart from the
img/s figure): train or fine-tune CLIP on a folder of ``name.jpg`` +
``name.txt`` caption pairs with the step of ``clipx_torch/train.py``,
periodic checkpoints and ``--resume``.

    python -m clipx_torch.cli.train data/ --model ViT-B/32 --steps 1000 \\
        --checkpoint-dir ckpts/

Data contract: for every image (the indexer's extensions) a sidecar
``.txt`` holds the caption; images without one are skipped and counted.

The mesh is clipx's: ``--tp`` positions a dp row (default 1) and ``--dp``
rows (default: every visible device of ``--device``'s type over tp),
lowered until the batch splits evenly; a mesh of more than one position
trains with ``train.make_sharded_train_step``, one position with the
single-device step. Asking for more positions than there are devices (on
one GPU, ``--tp 2``) exits with clipx's size message. Checkpoints are the
port's own ``.npz`` (``ckpt_dir/latest``, gathered whole from a sharded
state); clipx's orbax ``latest`` directory is refused, not read or
overwritten. The final params go to ``ckpt_dir/params.npz`` in clipx's
layout, so clipx's ``Encoder`` and CLIs load them, as the port's do.
SIGTERM and Ctrl-C stop between steps and save, so ``--resume`` continues
the run.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from clipx_torch import config as config_lib
from clipx_torch import train as train_lib
from clipx_torch.data.pipeline import IMAGE_EXTENSIONS, iter_decoded
from clipx_torch.models import convert
from clipx_torch.ops.preprocess import normalize_host
from clipx_torch.parallel import mesh as mesh_lib
from clipx_torch.runtime.device import DEVICES, resolve_device
from clipx_torch.text.tokenizer import ClipTokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="clipx-train")
    p.add_argument("data_dir")
    p.add_argument("--model", default="ViT-B/32")
    p.add_argument("--init-checkpoint", default=None,
                   help=".npz params to start from (else random init)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--weight-decay", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --checkpoint-dir")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel axis size (0 = all devices / tp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel axis size")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize blocks to trade FLOPs for memory")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where the model trains (default cuda; cpu must be "
                        "asked for)")
    return p


def find_pairs(data_dir: str) -> List[Tuple[str, str]]:
    pairs = []
    skipped = 0
    for fn in sorted(os.listdir(data_dir)):
        base, ext = os.path.splitext(fn)
        if ext.lower() not in IMAGE_EXTENSIONS:
            continue
        txt = os.path.join(data_dir, base + ".txt")
        if os.path.exists(txt):
            pairs.append((os.path.join(data_dir, fn), txt))
        else:
            skipped += 1
    if skipped:
        print(f"({skipped} images without captions skipped)")
    return pairs


class PairLoader:
    """Cycles (pixels, token_ids) batches from caption pairs: clipx's
    ``RandomState(seed)`` picks, one pooled decode sweep per batch for the
    cache misses, a cache of ``_CACHE_CAP`` decoded images that never
    evicts a pick of the current sweep, and ``None`` cached for an
    undecodable file (resampled, never retried)."""

    def __init__(self, pairs, image_size: int, context_length: int,
                 batch_size: int, seed: int, decode_workers: int = 4):
        self.pairs = pairs
        self.image_size = image_size
        self.batch_size = batch_size
        self.tok = ClipTokenizer()
        self.context_length = context_length
        self.rng = np.random.RandomState(seed)
        self.decode_workers = decode_workers
        self._cache = {}

    _CACHE_CAP = 8192  # decoded images kept in RAM (~150 KB each at 224px)

    def _fill_cache(self, paths) -> None:
        missing = list(dict.fromkeys(
            p for p in paths if p not in self._cache))
        if not missing:
            return
        # evicting a live pick would read as "undecodable" in next_batch
        # and silently resample a good image
        live = set(paths)
        for item in iter_decoded(missing, self.image_size,
                                 workers=self.decode_workers):
            if len(self._cache) >= self._CACHE_CAP:
                victim = next((p for p in self._cache if p not in live),
                              None)
                if victim is not None:
                    self._cache.pop(victim)
            self._cache[item.path] = item.array  # None on failure

    def next_batch(self):
        pixels, captions = [], []
        while len(pixels) < self.batch_size:
            want = self.batch_size - len(pixels)
            picks = [self.pairs[self.rng.randint(len(self.pairs))]
                     for _ in range(want)]
            self._fill_cache([p for p, _ in picks])
            for img_path, txt_path in picks:
                arr = self._cache.get(img_path)
                if arr is None:
                    continue  # undecodable file: resampled next loop
                with open(txt_path, encoding="utf-8",
                          errors="replace") as f:
                    captions.append(f.read().strip())
                pixels.append(arr)
        ids = self.tok(captions, context_length=self.context_length)
        return normalize_host(np.stack(pixels)), ids


def _to_device(pixels: np.ndarray, ids: np.ndarray, device):
    """The batch on ``device``. On CUDA the copies come from pinned memory
    and do not block: they queue behind the step that is running, and the
    host goes on to decode and tokenize the next batch (as clipx's
    ``jax.device_put`` lets it)."""
    pixels, ids = torch.from_numpy(pixels), torch.from_numpy(ids)
    if device.type == "cuda":
        pixels, ids = pixels.pin_memory(), ids.pin_memory()
    return (pixels.to(device, non_blocking=True),
            ids.to(device, non_blocking=True))


def _mesh(args, device) -> mesh_lib.Mesh:
    """clipx's mesh resolution over the visible devices of ``device``'s
    type: tp = max(--tp, 1), dp = --dp or devices // tp, lowered until the
    batch splits evenly over it. Too few devices exit with clipx's size
    message."""
    devices = mesh_lib.visible_devices(device)
    tp = max(args.tp, 1)
    dp = args.dp or max(len(devices) // tp, 1)
    while dp > 1 and args.batch_size % dp != 0:
        dp -= 1  # batch must shard evenly over dp
    try:
        return mesh_lib.make_mesh({"dp": dp, "tp": tp},
                                  devices[: dp * tp])
    except ValueError as exc:
        raise SystemExit(f"error: {exc}") from None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv if argv is not None
                                     else sys.argv[1:])
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc}") from None

    cfg = config_lib.get_config(args.model)
    pairs = find_pairs(args.data_dir)
    if not pairs:
        print(f"no (image, caption) pairs found in {args.data_dir!r}")
        return 1
    print(f"{len(pairs)} caption pairs; model {cfg.name}")
    mesh = _mesh(args, device)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    print(f"mesh: dp={dp} tp={tp} on {dp * tp} device(s)")
    sharded = mesh.size > 1

    ckpt_path = (os.path.join(args.checkpoint_dir, "latest")
                 if args.checkpoint_dir else None)
    if ckpt_path and os.path.isdir(ckpt_path):
        # clipx's orbax directory: the port neither reads nor overwrites it
        print(f"error: {ckpt_path} is clipx's orbax checkpoint directory "
              "(JAX), which clipx_torch cannot read or replace; resume it "
              "with python -m clipx.cli.train, or give the port another "
              "--checkpoint-dir")
        return 1
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)

    tx = train_lib.make_optimizer(args.lr, args.weight_decay,
                                  args.warmup_steps, args.steps)
    init = None
    if args.init_checkpoint:
        init = convert.load_params(args.init_checkpoint)
        if not ClipTokenizer().has_learned_merges:
            # real weights + byte-fallback token ids would fine-tune the
            # text tower against embedding rows the captions don't map to
            print(
                "WARNING: --init-checkpoint given but the BPE merge "
                "table (bpe_simple_vocab_16e6.txt.gz) was not found — "
                "caption token ids will not match the pretrained text "
                "embeddings and fine-tuning will corrupt the text "
                "tower. Point $CLIPX_BPE_PATH at the merge file or "
                "place it next to clipx_torch/text/tokenizer.py.",
                flush=True)
    # a sharded run starts from a whole state on the host and slices it
    state, tx = train_lib.create_train_state(
        cfg, args.seed, tx, device="cpu" if sharded else device,
        params=init)
    if sharded:
        step_fn, shard_state, split_batch = (
            train_lib.make_sharded_train_step(cfg, tx, mesh,
                                              remat=args.remat))
        state = shard_state(state)
    else:
        step_fn = train_lib.make_train_step(cfg, tx, remat=args.remat)

    if args.resume and ckpt_path and os.path.exists(ckpt_path):
        try:
            if sharded:
                state = shard_state(train_lib.restore_train_state(
                    ckpt_path, train_lib.unshard_state(state)))
            else:
                state = train_lib.restore_train_state(ckpt_path, state)
        except train_lib.CheckpointFormatError as exc:
            print(f"error: {exc}")
            return 1
        print(f"resumed from {ckpt_path} at step {state.step}")

    loader = PairLoader(pairs, cfg.vision.image_size,
                        cfg.text.context_length, args.batch_size, args.seed)
    t0 = time.perf_counter()
    # SIGTERM (what a supervisor sends to stop a long run) and Ctrl-C both
    # stop BETWEEN steps and fall through to the final checkpoint save, so
    # --resume picks up where the run left off
    stop = {"sig": None}
    prev_term = None
    try:
        prev_term = signal.signal(
            signal.SIGTERM, lambda *_: stop.__setitem__("sig", "SIGTERM"))
    except ValueError:  # not the main thread (library caller)
        pass
    try:
        try:
            for step in range(state.step, args.steps):
                if stop["sig"]:
                    break
                batch = loader.next_batch()
                batch = (split_batch(*batch) if sharded
                         else _to_device(*batch, device))
                state, metrics = step_fn(state, *batch)
                if ((step + 1) % args.log_every == 0
                        or step + 1 == args.steps):
                    loss = float(metrics["loss"])
                    acc = float(metrics["accuracy"])
                    rate = (args.batch_size * args.log_every
                            / (time.perf_counter() - t0))
                    t0 = time.perf_counter()
                    print(f"step {step + 1}/{args.steps} "
                          f"loss {loss:.4f} acc {acc:.3f} "
                          f"({rate:,.0f} img/s)", flush=True)
                if (ckpt_path and ((step + 1) % args.checkpoint_every == 0
                                   or step + 1 == args.steps)):
                    train_lib.save_train_state(ckpt_path, state)
                    print(f"checkpoint -> {ckpt_path}")
        except KeyboardInterrupt:
            stop["sig"] = "interrupt"
        # the saves stay inside the handler's scope: a repeated SIGTERM
        # sets the (already set) flag instead of killing a half-written
        # save
        if stop["sig"]:
            print(f"{stop['sig']}: stopping after step {state.step}")
            if ckpt_path:
                train_lib.save_train_state(ckpt_path, state)
                print(f"checkpoint -> {ckpt_path}")
        if args.checkpoint_dir:
            out = os.path.join(args.checkpoint_dir, "params.npz")
            train_lib.save_params(out, state.params)
            print(f"final params -> {out}")
        return 0
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


if __name__ == "__main__":
    raise SystemExit(main())
