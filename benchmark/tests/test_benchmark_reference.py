"""The plain reference against the port on the CPU at a tiny size, where
both compute in f32: the towers, the tokenizer, the seeded tree the port
takes, the codes file the port boots from, and the PQ top-k."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import corpus, weights
from benchmark.drivers.encode_stream import program_config
from benchmark.reference import clip as ref_clip
from benchmark.reference import pq as ref_pq
from benchmark.tests.conftest import TINY

SEEDS = [1, 2 ** 31 + 5]


def _encoder(seed):
    from clipx_torch.runtime.encoder import Encoder

    params = weights.make_params(TINY, seed, "cpu")
    return Encoder(program_config(TINY), params, device="cpu"), params


@pytest.mark.parametrize("seed", SEEDS)
def test_image_tower_matches_the_port(seed):
    enc, params = _encoder(seed)
    frames = corpus.frames(seed, 6, TINY["vision"]["image_size"], "cpu")
    got = enc.encode_images(frames.numpy())
    want = ref_clip.encode_images(params, TINY, frames, chunk=4).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_text_tower_and_tokenizer_match_the_port(seed):
    enc, params = _encoder(seed)
    prompts = corpus.prompts(seed, 9, [3, 9], [3, 7])
    ids = ref_clip.tokenize(prompts)
    np.testing.assert_array_equal(ids.numpy(), enc.tokenizer(prompts))
    got = enc.encode_texts(prompts)
    want = ref_clip.encode_texts(params, TINY, ids).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_seeded_tree_has_the_ports_layout():
    from clipx_torch.models import convert

    ours = weights.make_params(TINY, 3, "cpu")
    theirs = convert.init_params(program_config(TINY), 0)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(ours) == shapes(theirs)


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_moves_the_embeddings(seed):
    params = weights.make_params(TINY, seed, "cpu")
    frames = corpus.frames(seed, 4, TINY["vision"]["image_size"], "cpu")
    f32 = ref_clip.encode_images(params, TINY, frames)
    low = ref_clip.encode_images(params, TINY, frames, quant="fp8")
    gap = torch.linalg.vector_norm(low - f32, dim=1).max()
    assert 1e-2 < gap < 1.0
    with pytest.raises(ValueError):
        ref_clip.encode_images(params, TINY, frames, quant="int4")


def test_codes_file_boots_the_port_and_pq_topk_matches(tmp_path):
    from clipx_torch.search import codes_io
    from clipx_torch.search.engine import VectorIndex

    rows, dim, dsub, k = 8192, 32, 2, 10
    codes, centroids, rotation = corpus.pq_library(11, rows, dim, dsub, "cpu")
    index = str(tmp_path / "images.index")
    corpus.write_codes_file(index + ".codes", codes.numpy(),
                            centroids.numpy(), rotation.numpy(), dsub)
    for verify in ("sample", "full"):
        codes_io_env = {"CLIPX_CODES_VERIFY": verify}
        with pytest.MonkeyPatch.context() as mp:
            for key, val in codes_io_env.items():
                mp.setenv(key, val)
            payload = codes_io.load_codes(index, "pq", rotated=True,
                                          orphan=True)
        assert payload is not None, verify
    assert payload["ntotal"] == rows and payload["dsub"] == dsub
    np.testing.assert_array_equal(np.asarray(payload["codes"]),
                                  codes.numpy())
    idx = VectorIndex.from_codes(payload, device="cpu")
    queries = torch.randn(5, dim, generator=torch.Generator().manual_seed(1))
    queries /= queries.norm(dim=1, keepdim=True)
    d_got, i_got = idx.search(queries.numpy(), k)
    q_rot = ref_pq.rotate(queries, rotation)
    d_ref, i_ref = ref_pq.top_k(codes, centroids, q_rot, k, block=3000)
    np.testing.assert_allclose(d_got, d_ref.numpy(), atol=1e-6)
    s_got = ref_pq.row_scores(codes, centroids, q_rot,
                              torch.from_numpy(i_got))
    np.testing.assert_allclose(d_got, s_got.numpy(), atol=1e-6)
    # decoding is the port's reconstruction, in rotated space
    from clipx_torch.search.pq import PQCodebook

    np.testing.assert_allclose(
        ref_pq.decode(codes[:7], centroids).numpy(),
        PQCodebook(centroids.numpy()).decode(codes[:7].numpy()), atol=0)


def test_ranking_gap_is_tie_blind_and_catches_faults():
    from benchmark.checks import FAIL, ranking_gap

    d_ref = np.array([[3.0, 2.0, 2.0, 1.0]])
    s = {0: 3.0, 1: 2.0, 2: 2.0, 3: 1.0, 4: 0.5}
    ids = np.array([[0, 2, 1, 3]])            # a tie swapped: no cost
    scores = np.array([[s[i] for i in ids[0]]])
    assert ranking_gap(scores, ids, d_ref, scores, 5) == 0.0
    ids = np.array([[0, 1, 2, 4]])            # a row missed
    scores = np.array([[s[i] for i in ids[0]]])
    assert ranking_gap(scores, ids, d_ref, scores, 5) == 0.5
    ids = np.array([[0, 1, 1, 3]])            # a row twice
    assert ranking_gap(d_ref, ids, d_ref, d_ref, 5) == FAIL
    ids = np.array([[0, 1, 2, 5]])            # out of range
    assert ranking_gap(d_ref, ids, d_ref, d_ref, 5) == FAIL
