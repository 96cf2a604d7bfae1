"""Worker for the two-process test (run as __main__): the sharded search
and the dp x tp train step over one mesh spanning two processes.

The port's ``parallel.distributed`` joins the two processes over gloo on a
loopback port, the same shape a two-host deployment has. First one search
spans an 8-shard ``"shard"`` mesh, 4 CPU shards a process. Then two steps
of ``make_sharded_train_step``: tiny-test on dp 4 x tp 2 with 4 positions
a process (each process feeds its ``process_local_batch`` rows), tiny-test
on dp 1 x tp 2 with one position a process (tp crosses the processes; each
feeds the whole batch, its one dp row's), and tiny-rn-test on dp 4 x tp 2
(replicated params). Each run's gathered params must equal those of the
same steps over 8 positions in one process within the ``STEP_ATOL`` the
test passes (the gradient is that of one loss: an all-gather whose
backward summed over the processes would double it), and replicated
leaves must be equal bit for bit across the tp columns. Prints one RESULT
line, the losses and each tree's digest included, that the test compares
across processes.
"""

import os
import sys


def _digests(sharded, flags):
    """sha256 of every tree (by tp column) and of the replicated leaves,
    over both processes: each tp column's trees, and every tree's
    replicated leaves, must be equal bit for bit wherever they lie."""
    import hashlib

    import torch.distributed as dist

    from clipx_torch import train as ttrain

    def sha(arrays):
        return hashlib.sha256(b"".join(a.tobytes() for a in arrays)
                              ).hexdigest()[:16]

    mine = []
    for pos, tree in sharded.placements():
        leaves = [t.detach().numpy() for t in ttrain.tree_leaves(tree)]
        mine.append((sharded.column(pos), sha(leaves),
                     sha([a for a, f in zip(leaves, flags) if not f])))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    columns, replicated = {}, set()
    for j, tree_sha, rep_sha in (t for theirs in everyone for t in theirs):
        assert columns.setdefault(j, tree_sha) == tree_sha, (j, everyone)
        replicated.add(rep_sha)
    assert len(replicated) == 1, everyone
    return {"columns": dict(sorted(columns.items())),
            "replicated": replicated.pop()}


def _train(model, axes, devices, ranks, local_rows, atol):
    """Two steps over the mesh (this process's rows of each global batch),
    checked against the same steps over 8 positions in this process."""
    import numpy as np
    import torch

    from clipx_torch import config as tcfg
    from clipx_torch import train as ttrain
    from clipx_torch.models import convert
    from clipx_torch.parallel import mesh as mesh_lib

    cfg = tcfg.get_config(model)
    tree = convert.init_params(cfg, 0)
    rng = np.random.RandomState(0)
    size = cfg.vision.image_size
    batches = []
    for _ in range(2):
        pixels = rng.randn(8, size, size, 3).astype(np.float32)
        ids = np.zeros((8, cfg.text.context_length), np.int32)
        ids[:, 0] = rng.randint(1, 1000, 8)
        ids[:, 1] = cfg.text.vocab_size - 1
        batches.append((pixels, ids))
    runs = []
    for mesh in (mesh_lib.make_mesh(axes, devices, ranks),
                 mesh_lib.make_mesh({"dp": 4, "tp": 2},
                                    [torch.device("cpu")] * 8)):
        tx = ttrain.make_optimizer(1e-3, 0.02, 1, 10)
        state, _ = ttrain.create_train_state(cfg, tx=tx, device="cpu",
                                             params=tree)
        step, shard_state, split = ttrain.make_sharded_train_step(
            cfg, tx, mesh)
        state = shard_state(state)
        losses = []
        for pixels, ids in batches:
            rows = local_rows if mesh.process_group else slice(None)
            state, m = step(state, *split(pixels[rows], ids[rows]))
            losses.append(float(m["loss"]))
        runs.append((state, losses))
    (state, losses), (ref, ref_losses) = runs
    first = state.params.placements()[0][1]
    flags = ttrain._sharded_flags(first, state.params.specs,
                                  state.params.tp)
    ours = convert._flatten(state.params.gather())
    want = convert._flatten(ref.params.gather())
    worst = max(float(np.abs(ours[k] - want[k]).max()) for k in want)
    assert worst <= atol, (model, axes, worst)
    assert np.allclose(losses, ref_losses, rtol=1e-5), (losses, ref_losses)
    return {"losses": [f"{x:.6f}" for x in losses],
            "trees": _digests(state.params, flags)}


def main() -> int:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    atol = float(sys.argv[3])
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

        # -- the dp x tp train step over the global mesh ---------------------
        local = distributed.process_local_batch(8)
        rows = slice(pid * local, (pid + 1) * local)
        train = {
            "dp4xtp2": _train("tiny-test", {"dp": 4, "tp": 2}, devices,
                              ranks, rows, atol),
            "rn_dp4xtp2": _train("tiny-rn-test", {"dp": 4, "tp": 2},
                                 devices, ranks, rows, atol)}
        one, one_ranks = distributed.global_devices([torch.device("cpu")])
        train["dp1xtp2"] = _train("tiny-test", {"dp": 1, "tp": 2}, one,
                                  one_ranks, slice(None), atol)
        print(f"RESULT top1=self ids={I.tolist()} train={train}", flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
