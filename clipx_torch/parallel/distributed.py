"""Multi-process initialization: one mesh over several processes.

Counterpart of ``clipx/parallel/distributed.py``. Past one process, every
process runs the same program: :func:`initialize` joins them into one
``torch.distributed`` process group over a ``tcp://`` rendezvous (nothing
on a machine tells a program of its cluster, so the address, the process
count and the rank are given), and :func:`global_devices` lists every
process's devices in rank order, which ``mesh.make_mesh`` builds a global
mesh from. A sharded search then gathers each process's candidates with
``all_gather`` over the group (``parallel/mips.py``).

The backend follows the device: NCCL for CUDA, gloo for the CPU. NCCL
allows one rank a GPU, so several ranks on one card are not possible:
multi-process runs go over gloo on the CPU, or one NCCL rank a card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> None:
    """Idempotent ``init_process_group``: ``coordinator_address`` is
    ``host:port`` (or a ``tcp://`` URL) of process 0, ``device`` the type
    the processes compute on (``cuda``: NCCL on that GPU, ``cpu``: gloo).
    With no arguments the rendezvous comes from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them)."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    kw = {}
    if coordinator_address is not None:
        url = coordinator_address
        if not url.startswith("tcp://"):
            url = f"tcp://{url}"
        kw = dict(init_method=url, world_size=num_processes,
                  rank=process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)


def shutdown() -> None:
    """Leave the process group (the counterpart of ``jax.distributed.
    shutdown``); initialize may run again afterwards."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multi_process() -> bool:
    return process_count() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_local_batch(global_batch: int) -> int:
    """Rows this process contributes to a dp-sharded global batch."""
    count = process_count()
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{count} processes")
    return global_batch // count


def global_devices(local: Optional[List[torch.device]] = None
                   ) -> Tuple[List[torch.device], Optional[List[int]]]:
    """(devices, ranks) of a global mesh: every process's ``local`` devices
    (default: its visible devices of the initialized type) in rank order,
    each beside the rank that holds it. Without a process group: (local,
    None)."""
    from clipx_torch.parallel.mesh import visible_devices

    if local is None:
        gloo = dist.is_initialized() and dist.get_backend() == "gloo"
        local = visible_devices("cpu" if gloo else "cuda")
    if not dist.is_initialized():
        return list(local), None
    everyone = [None] * process_count()
    dist.all_gather_object(everyone, [str(d) for d in local])
    devices, ranks = [], []
    for rank, names in enumerate(everyone):
        devices += [torch.device(n) for n in names]
        ranks += [rank] * len(names)
    return devices, ranks


def all_gather_cols(t: torch.Tensor) -> torch.Tensor:
    """Every process's (Q, c) tensor side by side in rank order, (Q, c *
    processes), over the process group (NCCL: ``t`` on this rank's GPU;
    gloo: on the CPU)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=1)
