"""Worker for the two-process sharded search test (run as __main__).

Each process holds 4 CPU shards of one 8-shard ``"shard"`` mesh; the
port's ``parallel.distributed`` joins the two over gloo on a loopback
port, the same shape a two-host deployment has. One search spans both
processes' shards. Prints one RESULT line the test compares across
processes.
"""

import os
import sys


def main() -> int:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from clipx_torch.parallel import distributed
    from clipx_torch.parallel import mesh as mesh_lib
    from clipx_torch.parallel.mips import ShardedVectorIndex

    distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid, device="cpu")
    try:
        assert distributed.is_multi_process()
        assert distributed.process_local_batch(8) == 4
        devices, ranks = distributed.global_devices(
            [torch.device("cpu")] * 4)
        mesh = mesh_lib.make_mesh({"shard": 8}, devices, ranks)
        assert mesh.local_positions() == list(range(4 * pid, 4 * pid + 4))

        rng = np.random.RandomState(0)
        corpus = rng.randn(300, 64).astype(np.float32)
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
        idx = ShardedVectorIndex(corpus, mesh)
        D, I = idx.search(corpus[:2], k=1)
        assert (I[:, 0] == [0, 1]).all(), I
        # the whole result equals one process's 8-shard search of the rows
        D, I = idx.search(corpus[:3], k=5)
        one = ShardedVectorIndex(corpus, mesh_lib.make_mesh(
            {"shard": 8}, [torch.device("cpu")] * 8))
        Dl, Il = one.search(corpus[:3], k=5)
        assert np.array_equal(I, Il) and np.array_equal(D, Dl), (I, Il)
        print(f"RESULT top1=self ids={I.tolist()}", flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
