"""Arm and run the real-weight parity gate of the port.

    python -m clipx_torch.tools.parity_check [--device cuda|cpu]

Counterpart of the root ``tools/parity_check.py`` (``make parity``). The gate
holds the port's encoders to OpenAI CLIP's own embeddings at cosine >= 0.999
(``tests/test_torch_real_weight_parity.py``). It needs three artifacts that
the repository does not hold: the BPE merge table, a converted checkpoint
(``$CLIPX_CHECKPOINT``) and the golden file (``$CLIPX_GOLDEN``, by default
``tests/golden/clip_golden.npz``, written by ``tools/make_golden.py``). The
tool prints the ones still missing and exits 0, or, once all three exist,
runs the gate under pytest on ``--device`` (default ``cuda``: the card's
bf16 through the hand-written kernels; ``cpu``: f32) and exits with
pytest's code.

The gate's pieces are plain functions with explicit paths, which the tests
and ``chip_smoke.py`` call as well: ``missing_artifacts``,
``golden_cosines`` with ``golden_failures``, and ``tree_mismatch``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np

from clipx_torch import config as config_lib
from clipx_torch.models import convert
from clipx_torch.runtime.device import DEVICES
from clipx_torch.text.tokenizer import ClipTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GATE = os.path.join("tests", "test_torch_real_weight_parity.py")
DEFAULT_GOLDEN = os.path.join(ROOT, "tests", "golden", "clip_golden.npz")
# clipx's threshold (tests/test_real_weight_parity.py), for both devices
GOLDEN_COS_MIN = 0.999


def golden_path() -> str:
    return os.environ.get("CLIPX_GOLDEN", DEFAULT_GOLDEN)


def missing_artifacts(checkpoint: Optional[str], golden: str,
                      tokenizer: ClipTokenizer) -> List[str]:
    """One line for each artifact the gate still lacks: the merge table
    (``tokenizer`` has no learned merges), the checkpoint (``checkpoint``
    unset or absent) and the golden file. Empty once the gate is armed."""
    missing = []
    if not tokenizer.has_learned_merges:
        missing.append(
            "- BPE merge table: put bpe_simple_vocab_16e6.txt.gz next to "
            "clipx_torch/text/tokenizer.py or set $CLIPX_BPE_PATH (the "
            "file ships with the OpenAI CLIP package)")
    if not (checkpoint and os.path.exists(checkpoint)):
        missing.append(
            "- converted checkpoint: python -m "
            "clipx_torch.tools.convert_checkpoint ViT-B-32.pt --out "
            "vit_b32.npz, then export CLIPX_CHECKPOINT=vit_b32.npz")
    if not os.path.exists(golden):
        missing.append(
            "- golden fixture: run tools/make_golden.py on a host with "
            "the torch CLIP package -> tests/golden/clip_golden.npz")
    return missing


def golden_model(golden: str) -> str:
    """The preset the golden file was made with (ViT-B/32 if it does not
    say, as clipx's gate assumes)."""
    with np.load(golden) as data:
        return str(data["model"]) if "model" in data.files else "ViT-B/32"


def _row_cos(ours: np.ndarray, ref) -> np.ndarray:
    # both sides are L2-normalized rows
    return np.sum(ours * np.asarray(ref, np.float32), axis=1)


def golden_cosines(encoder, golden: str) -> Dict[str, np.ndarray]:
    """Per-row cosines of ``encoder``'s embeddings against the golden
    file's (``tools/make_golden.py``'s keys): ``text`` for its prompts,
    ``image`` for its images encoded as one batch and ``image_single`` for
    each image encoded alone (the batch-1 bucket, which takes another
    attention kernel on the card)."""
    with np.load(golden) as data:
        texts = [str(t) for t in data["texts"]]
        text_ref, image_ref = data["text_emb"], data["image_emb"]
        images = np.asarray(data["images_uint8"], np.uint8)
    text = encoder.encode_texts(texts)
    image = encoder.encode_images(images)
    single = np.concatenate([encoder.encode_images(images[i: i + 1])
                             for i in range(images.shape[0])])
    return {"text": _row_cos(text, text_ref),
            "image": _row_cos(image, image_ref),
            "image_single": _row_cos(single, image_ref)}


def golden_failures(cosines: Dict[str, np.ndarray],
                    threshold: float = GOLDEN_COS_MIN) -> List[str]:
    """One message for each kind of cosine whose minimum is under
    ``threshold``, naming that minimum."""
    return [f"{kind.replace('_', ' ')} cosine {cos.min():.5f} < {threshold}"
            for kind, cos in cosines.items() if not cos.min() >= threshold]


def tree_mismatch(checkpoint: str, model: str) -> dict:
    """How the ``.npz`` tree at ``checkpoint`` differs from ``model``'s
    preset tree (``convert.init_params``), by clipx's ``.npz`` key names:
    ``missing`` and ``extra`` keys, and ``shapes``, {key: (the file's shape,
    the preset's)}. Only the kinds that occur are present, so a sound
    checkpoint gives ``{}``."""
    want = {k: v.shape for k, v in convert._flatten(
        convert.init_params(config_lib.get_config(model))).items()}
    with np.load(checkpoint) as flat:
        got = {k: flat[k].shape for k in flat.files}
    out = {"missing": sorted(set(want) - set(got)),
           "extra": sorted(set(got) - set(want)),
           "shapes": {k: (got[k], want[k]) for k in sorted(want)
                      if k in got and got[k] != want[k]}}
    return {kind: v for kind, v in out.items() if v}


def pytest_argv(device: str) -> List[str]:
    """The gate under pytest, its golden case on ``device`` alone. No
    conftest: the repository's imports JAX, which the card's machine does
    not have."""
    return [sys.executable, "-m", "pytest", GATE, "-v", "--noconftest",
            "-p", "no:cacheprovider", "-k", f"not golden or {device}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="arm and run the real-weight parity gate")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where the gate's golden case runs (default cuda)")
    args = ap.parse_args(argv)
    missing = missing_artifacts(os.environ.get("CLIPX_CHECKPOINT"),
                                golden_path(), ClipTokenizer())
    if missing:
        print("parity gate NOT armed; missing artifacts:")
        print("\n".join(missing))
        print("(re-run `python -m clipx_torch.tools.parity_check` once "
              "they exist)")
        return 0
    from clipx_torch.cli.common import check_device

    check_device(args)
    print("all artifacts present — running the gate", flush=True)
    return subprocess.call(pytest_argv(args.device), cwd=ROOT)


if __name__ == "__main__":
    sys.exit(main())
