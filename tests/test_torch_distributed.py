"""The port's multi-process runs: two real processes, one global mesh over
a loopback gloo process group (``clipx_torch.parallel.distributed``). The
counterpart of ``tests/test_distributed.py``: cross-process
initialization, a corpus-sharded search spanning both processes' shards (4
CPU shards each), and the dp x tp train step whose gradients couple the
processes (``tests/_torch_dist_worker.py``: dp 4 x tp 2 with 4 positions a
process, dp 1 x tp 2 with tp across the processes, and the ResNet tower),
each held to the same steps in one process within
``tests/test_torch_train.py``'s ``STEP_ATOL``.
"""

import os
import socket
import subprocess
import sys

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_dist_worker.py")
from test_torch_train import STEP_ATOL

# per process: a worker imports torch and the port, joins the group,
# searches and trains in several seconds
_TIMEOUT = 45


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair():
    """One attempt: spawn both workers on a fresh port, return
    (procs, outs)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), str(port), repr(STEP_ATOL)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise
        outs.append(out)
    return procs, outs


def test_two_process_sharded_search():
    procs, outs = _run_pair()
    if any(p.returncode != 0 for p in procs) and any(
            "gloo" in out.lower() and "preamble" in out.lower()
            for out in outs):
        # tests/test_distributed.py's rule: gloo's loopback rendezvous can
        # abort on a transport preamble under heavy host contention; retry
        # ONLY that signature, so a real collective bug stays visible
        procs, outs = _run_pair()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    results = [line for out in outs for line in out.splitlines()
               if line.startswith("RESULT ")]
    assert len(results) == 2, outs
    # the merged candidates are gathered to every process: one answer; the
    # losses are the global batch's, and the trees' digests gathered
    assert results[0] == results[1], results
    assert "dp4xtp2" in results[0] and "dp1xtp2" in results[0], results
