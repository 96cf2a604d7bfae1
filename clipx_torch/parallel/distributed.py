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

The tensor-parallel step and encode (``parallel/tensor.py``, ``train.py``)
meet in the collectives at the end of this module, each over a
:class:`Group` (a tp row or a dp column of the mesh) and each
autograd-aware: ``tp_copy`` (identity forward, sum over the group
backward: Megatron's *f*), ``tp_reduce`` (sum forward, identity backward:
*g*), ``gather`` (concatenation along a dim forward, this position's slice
backward: the embeddings' width and the dp gather of the global
negatives). Each takes one tensor a local position of the group and
returns one a local position. Within one process a collective is copies
between the group's devices and adds in mesh order; across processes the
local result is then combined over the group's process group
(``all_reduce``, ``all_gather``), so every position gets the same bits.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# collectives of the tensor-parallel step
# ---------------------------------------------------------------------------

class Group:
    """Positions of a mesh that meet in a collective: ``positions`` every
    one in mesh order, ``local`` this process's, ``devices`` theirs, and
    ``pg`` the process group joining their processes (None: no process
    group takes part, see ``Mesh.subgroup``)."""

    def __init__(self, mesh, positions: Sequence[int]):
        self.positions = list(positions)
        self.local = [p for p in self.positions if mesh.ranks[p] == mesh.rank]
        self.devices = [mesh.devices[p] for p in self.local]
        self.pg = mesh.subgroup(self.positions)

    @property
    def size(self) -> int:
        return len(self.positions)


def _everyone(group: Group, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every position's tensor of the group, in mesh order, on the first
    local device (the other processes' through ``all_gather``; each
    process must hold as many of the group's positions)."""
    dev = xs[0].device
    here = [x.to(dev) for x in xs]
    if group.pg is None:
        return here
    local = torch.stack(here)
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group.pg))]
    dist.all_gather(parts, local.contiguous(), group=group.pg)
    return [t for part in parts for t in part.unbind(0)]


def _sum(group: Group, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over the group of one tensor a position, accumulated in f32
    in mesh order (this process's positions, then over the process group),
    on the first local device in xs' dtype."""
    dev = xs[0].device
    acc = xs[0].to(torch.float32, copy=True)
    for x in xs[1:]:
        acc += x.to(dev, torch.float32)
    if group.pg is not None:
        dist.all_reduce(acc, group=group.pg)
    return acc.to(xs[0].dtype)


def _spread(t: torch.Tensor, devices) -> List[torch.Tensor]:
    """One copy of ``t`` a device (``t`` itself for the first, where it
    lies), so that no two outputs share memory."""
    return [t if i == 0 and d == t.device else t.to(d, copy=True)
            for i, d in enumerate(devices)]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        total = _sum(ctx.group, grads)
        return (None, *_spread(total, [g.device for g in grads]))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        return tuple(_spread(_sum(group, xs), [x.device for x in xs]))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, *xs):
        parts = _everyone(group, xs)
        ctx.dim = dim
        ctx.bounds = []
        start = 0
        for pos, part in zip(group.positions, parts):
            if pos in group.local:
                ctx.bounds.append((start, part.shape[dim]))
            start += part.shape[dim]
        return tuple(_spread(torch.cat(parts, dim=dim),
                             [x.device for x in xs]))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(g.narrow(ctx.dim, start, size).contiguous()
                              for g, (start, size) in zip(grads,
                                                          ctx.bounds)))


def tp_copy(xs: Sequence[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """Identity forward; backward, each position gets the sum of the
    group's gradients (Megatron's *f*: in front of a column-parallel
    layer, whose input every position holds whole)."""
    return list(_Copy.apply(group, *xs))


def tp_reduce(xs: Sequence[torch.Tensor], group: Group) -> List[torch.Tensor]:
    """The sum of the group's partial results, on every position; backward
    the identity (Megatron's *g*: behind a row-parallel layer)."""
    return list(_Reduce.apply(group, *xs))


def gather(xs: Sequence[torch.Tensor], group: Group, dim: int
           ) -> List[torch.Tensor]:
    """Every position's tensor concatenated along ``dim`` in mesh order, on
    every position; backward, each position's slice of its own gradient
    (no sum: every position computes the same downstream values, so each
    already holds the whole gradient)."""
    return list(_Gather.apply(group, dim, *xs))
