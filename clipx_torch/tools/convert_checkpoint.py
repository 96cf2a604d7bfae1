"""One-time torch -> params ``.npz`` checkpoint conversion.

    python -m clipx_torch.tools.convert_checkpoint ~/.cache/clip/ViT-B-32.pt \\
        --out vit_b32.npz [--model NAME]
    CLIPX_CHECKPOINT=vit_b32.npz python -m clipx_torch.cli.build_index photos/

Counterpart of the root ``tools/convert_checkpoint.py``, with its flags,
its stdout lines and its ``--model`` error, on the port's
``models/convert.py`` alone. Accepts OpenAI CLIP archives (TorchScript or
a plain state dict) and HuggingFace CLIPModel state dicts; detects the
layout and infers the architecture from OpenAI-format files. The ``.npz``
is clipx's layout, which both packages load.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint", help="torch .pt/.bin state dict")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--model", default=None,
                    help="clipx preset name; inferred from OpenAI-format "
                         "checkpoints when omitted")
    args = ap.parse_args(argv)

    import torch

    from clipx_torch import config as config_lib
    from clipx_torch.models import convert

    try:
        obj = torch.load(args.checkpoint, map_location="cpu",
                         weights_only=False)
    except Exception:
        # OpenAI ships TorchScript archives; fall back to jit.load
        obj = torch.jit.load(args.checkpoint, map_location="cpu")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    sd = dict(obj)

    fmt = convert.detect_format(sd)
    if args.model is not None:
        cfg = config_lib.get_config(args.model)
    elif fmt == "openai":
        cfg = convert.config_from_openai_state_dict(sd)
    else:
        ap.error("--model is required for HuggingFace-format checkpoints")
    if getattr(cfg.vision, "tower", "vit") == "resnet":
        vis = (f"resnet {cfg.vision.layers} width {cfg.vision.width} "
               f"@ {cfg.vision.image_size}px")
    else:
        vis = (f"vit {cfg.vision.layers}x{cfg.vision.width} patch "
               f"{cfg.vision.patch_size} @ {cfg.vision.image_size}px")
    print(f"layout: {fmt}; architecture: vision {vis}, text "
          f"{cfg.text.layers}x{cfg.text.width}, embed {cfg.embed_dim}")
    convert.save_params(args.out, convert.from_state_dict(sd, cfg))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
