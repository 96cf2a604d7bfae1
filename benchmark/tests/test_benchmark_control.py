"""The check that decides ``correct`` at a tiny size on the CPU: the
control (the reference one precision down, ``benchmark.control``) reads
above the limits of the cells, and a run whose timed path alters an answer
where it is produced comes out not correct."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import ROOT

# each tiny cell and the cell whose committed limits it is held to
CELLS = {"tiny-index": "index-b32", "tiny-query-pq": "query-b32-pq"}


def _run(root, workload, seed=2 ** 31 + 3):
    out, _ = harness.run_cell(workload, seed, 0.4, False,
                              device=torch.device("cpu"),
                              started=time.perf_counter(), root=root)
    return out


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 11])
def test_control_fails_every_limit(tiny_root, workload, seed):
    limits = harness.load_json(ROOT, "benchmark", "limits",
                               CELLS[workload] + ".json")
    got = control.readings(workload, seed, torch.device("cpu"), queries=48,
                           root=tiny_root)
    assert set(limits) <= set(got)
    for name, limit in limits.items():
        assert got[name] > limit, (name, got[name], limit)


def test_program_int8_path_runs_as_a_control(tiny_root):
    got = control.readings("tiny-index", 5, torch.device("cpu"),
                           program_int8=True, seconds=0.3, root=tiny_root)
    assert got["program_int8"] > 1e-3


def _alter_row(monkeypatch):
    from clipx_torch.runtime.encoder import Encoder

    real = Encoder.finalize

    def finalize(handle):
        emb = real(handle)
        emb[1] = emb[0]
        return emb

    monkeypatch.setattr(Encoder, "finalize", staticmethod(finalize))


def _alter_id(monkeypatch):
    from clipx_torch.search.engine import VectorIndex

    real = VectorIndex.search

    def search(self, queries, k):
        d, i = real(self, queries, k)
        i = i.copy()
        i[0, 0] = (i[0, 0] + 1) % self.ntotal
        return d, i

    monkeypatch.setattr(VectorIndex, "search", search)


def _alter_text(monkeypatch):
    from clipx_torch.runtime.encoder import Encoder

    real = Encoder.encode_texts

    def encode_texts(self, texts):
        e = real(self, texts)
        e[0] = np.roll(e[0], 1)
        return e

    monkeypatch.setattr(Encoder, "encode_texts", encode_texts)


@pytest.mark.parametrize("workload, fault, number", [
    ("tiny-index", _alter_row, "emb_gap"),
    ("tiny-query-pq", _alter_id, "score_gap"),
    ("tiny-query-pq", _alter_text, "text_gap")])
def test_an_altered_answer_is_not_correct(tiny_root, monkeypatch, workload,
                                          fault, number):
    assert _run(tiny_root, workload)["correct"] is True
    fault(monkeypatch)
    out = _run(tiny_root, workload)
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"]
