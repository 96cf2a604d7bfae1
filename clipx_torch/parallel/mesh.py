"""Device meshes: named axes over a list of ``torch.device``s.

Counterpart of ``clipx/parallel/mesh.py``. clipx is single-controller: one
process sees every device and ``shard_map`` runs a per-shard body on each.
The port keeps that model. A :class:`Mesh` lists its devices in mesh order
(row-major over the axes); each shard's tensors live on its device, and the
per-shard work is plain code that queues each shard's kernels on that
device's current stream, with no host synchronisation between shards, so
several GPUs overlap.

- **dp** — data parallelism over the batch: the encoder splits a batch into
  one even share a ``"dp"`` position (``runtime/encoder.py``) and replicates
  its params once a *distinct* device (:func:`replicas`).
- **shard** — corpus-row sharding for search (``parallel/mips.py``,
  ``search/ivf.py::ShardedIVFIndex``).
- **tp** — tensor parallelism is not ported yet (:data:`TP_NOT_PORTED`).

A device may appear in a mesh more than once. That is the port's
counterpart of the virtual CPU devices clipx's tests run on: a mesh of four
shards on the CPU, or on one card, runs the sharded code paths where only
one device exists. It is an argument of :func:`make_mesh`; the CLIs build
their meshes from the visible devices only.

Across processes (``parallel/distributed.py``) a mesh also records the rank
that holds each position; a process holds only its own positions' tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from clipx_torch.runtime.device import resolve_device

TP_NOT_PORTED = ("tensor parallelism (a 'tp' mesh axis) is not yet ported to "
                 "clipx_torch (it comes with slice 14 of the port, ROADMAP.md "
                 "queue A item 8; use the clipx package for it)")


def visible_devices(kind="cuda") -> List[torch.device]:
    """Every visible device of ``kind`` (a device or its type): each GPU, or
    the one CPU. Raises when CUDA is asked for and no GPU is visible."""
    kind = resolve_device(kind).type
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Named axes over devices. ``devices[i]`` is position i's device as its
    own process sees it, ``ranks[i]`` that process; ``rank`` is this
    process's. Positions are rank-major, so a gather of each process's local
    positions in rank order is a gather in mesh order. A mesh built with
    ``ranks`` spans the process group (``process_group``): its searches
    gather over it, even when the group has one process."""

    def __init__(self, axes: Dict[str, int], devices: Sequence[torch.device],
                 ranks: Optional[Sequence[int]] = None, rank: int = 0):
        self.axes = dict(axes)
        self.devices = [torch.device(d) for d in devices]
        self.process_group = ranks is not None
        self.ranks = list(ranks) if ranks is not None else [rank] * len(
            self.devices)
        self.rank = rank
        if self.ranks != sorted(self.ranks):
            raise ValueError("mesh positions must be rank-major")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"a mesh holds one device type, got {kinds}")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multi_process(self) -> bool:
        """More than one process holds positions of this mesh."""
        return len(set(self.ranks)) > 1

    def local_positions(self) -> List[int]:
        """The positions this process holds, in mesh order."""
        return [i for i, r in enumerate(self.ranks) if r == self.rank]

    def __repr__(self) -> str:
        return f"Mesh({self.axes}, {[str(d) for d in self.devices]})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh from axis sizes, e.g. {"shard": 4}. Defaults to every
    visible GPU (every process's, once ``distributed.initialize`` ran) on
    one "dp" axis. Axis sizes must multiply to the device count; a device
    may be listed more than once."""
    from clipx_torch.parallel import distributed

    rank = 0
    if devices is None:
        devices, ranks = distributed.global_devices()
    if ranks is not None:
        rank = distributed.process_index()
    devices = list(devices)
    if axes is None:
        axes = {"dp": len(devices)}
    if axes.get("tp", 1) > 1:
        raise ValueError(TP_NOT_PORTED)
    sizes = tuple(axes.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(f"mesh {axes} needs {np.prod(sizes)} devices, "
                         f"have {len(devices)}")
    return Mesh(axes, devices, ranks, rank)


def split_batch(n: int, mesh: Mesh) -> List[slice]:
    """Row slices of an n-row batch, one a ``"dp"`` position, in mesh
    order. n must split evenly (the encoder's buckets are multiples of
    2 * dp)."""
    parts = mesh.shape["dp"]
    if n % parts:
        raise ValueError(f"batch {n} does not split over {parts} 'dp' "
                         "positions")
    step = n // parts
    return [slice(i * step, (i + 1) * step) for i in range(parts)]


def replicas(mesh: Mesh, place, have: Optional[dict] = None) -> dict:
    """One param tree a distinct device of ``mesh`` (clipx's
    ``shard_params`` with ``tp=None``: every leaf replicated): ``have``'s
    trees, and ``place(device)`` for each device they lack. A repeated
    device shares one copy."""
    out = dict(have or {})
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = place(dev)
    return out
