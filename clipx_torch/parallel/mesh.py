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
- **tp** — Megatron-style tensor parallelism inside the ViT towers
  (``parallel/tensor.py``): :func:`param_specs` column-shards wq/wk/wv,
  mlp.w1, their biases and the embeddings' width, row-shards wo and mlp.w2,
  and replicates the rest; :func:`shard_params` gives each position its
  contiguous slice. The port slices whole heads, so heads, width and MLP
  width must divide by the tp size where a spec shards them (clipx's GSPMD
  may split a head).
- **shard** — corpus-row sharding for search (``parallel/mips.py``,
  ``search/ivf.py::ShardedIVFIndex``).

Positions are row-major over the axes in the order given, as clipx's
``np.asarray(devices).reshape(sizes)``: in ``{"dp": 4, "tp": 2}`` position
``2 * i + j`` is dp row i, tp column j.

A device may appear in a mesh more than once. That is the port's
counterpart of the virtual CPU devices clipx's tests run on: a mesh of four
shards on the CPU, or on one card, runs the sharded code paths where only
one device exists. It is an argument of :func:`make_mesh`; the CLIs build
their meshes from the visible devices only.

Across processes (``parallel/distributed.py``) a mesh also records the rank
that holds each position; a process holds only its own positions' tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clipx_torch.runtime.device import resolve_device

Spec = Tuple[Optional[str], ...]


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
        self._subgroups: Dict[tuple, Any] = {}
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

    def coord(self, pos: int, axis: str) -> int:
        """Position ``pos``'s index along ``axis`` (0 if the mesh lacks
        it)."""
        if axis not in self.axes:
            return 0
        return int(np.unravel_index(pos, tuple(self.axes.values()))[
            self.axis_names.index(axis)])

    def groups(self, axis: str) -> List[List[int]]:
        """The positions that differ only along ``axis``, one list for each
        value of the other axes, in mesh order: for ``"tp"`` the tp rows,
        for ``"dp"`` the dp columns. A mesh without ``axis`` gives one
        position a group."""
        grid = np.arange(self.size).reshape(tuple(self.axes.values()))
        if axis not in self.axes:
            return [[int(p)] for p in grid.reshape(-1)]
        grid = np.moveaxis(grid, self.axis_names.index(axis), -1)
        return [list(map(int, row))
                for row in grid.reshape(-1, self.axes[axis])]

    def subgroup(self, positions: Sequence[int]):
        """The ``torch.distributed`` group that joins the processes holding
        ``positions``, or None when they need none: a mesh built without
        ranks, or positions that all lie in this process while other
        processes exist. A mesh over a one-process group answers the world
        group, so its collectives run through the process group too. Every
        process must ask for the same groups in the same order (new groups
        are made collectively), as building one step or encoder on every
        process does."""
        if not self.process_group:
            return None
        import torch.distributed as dist

        ranks = sorted({self.ranks[p] for p in positions})
        if ranks == list(range(dist.get_world_size())):
            return dist.group.WORLD
        if len(ranks) == 1:
            return None
        if tuple(ranks) not in self._subgroups:
            self._subgroups[tuple(ranks)] = dist.new_group(ranks)
        return self._subgroups[tuple(ranks)]

    def __repr__(self) -> str:
        return f"Mesh({self.axes}, {[str(d) for d in self.devices]})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh from axis sizes, e.g. {"dp": 4, "tp": 2} or {"shard":
    4}. Defaults to every visible GPU (every process's, once
    ``distributed.initialize`` ran) on one "dp" axis. Axis sizes must
    multiply to the device count; a device may be listed more than
    once."""
    from clipx_torch.parallel import distributed

    rank = 0
    if devices is None:
        devices, ranks = distributed.global_devices()
    if ranks is not None:
        rank = distributed.process_index()
    devices = list(devices)
    if axes is None:
        axes = {"dp": len(devices)}
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


# ---------------------------------------------------------------------------
# tensor-parallel layout
# ---------------------------------------------------------------------------

def _block_specs(tp: Optional[str]) -> Dict:
    """Specs for one stacked block tree (leading axis = layer), clipx's
    ``_block_specs``: column-parallel wq/wk/wv (out dim = heads) and mlp.w1
    with their biases, row-parallel wo and mlp.w2 (their input dim is
    sharded, the product needs a sum over tp), their biases replicated."""
    col = (None, None, tp)   # (L, in, out) -> shard out
    row = (None, tp, None)   # (L, in, out) -> shard in
    bcol = (None, tp)
    rep2 = (None, None)
    return {
        "ln_1": {"scale": rep2, "bias": rep2},
        "attn": {"wq": col, "wk": col, "wv": col, "wo": row,
                 "bq": bcol, "bk": bcol, "bv": bcol, "bo": rep2},
        "ln_2": {"scale": rep2, "bias": rep2},
        "mlp": {"w1": col, "b1": bcol, "w2": row, "b2": rep2},
    }


def param_specs(tp: Optional[str] = "tp") -> Dict:
    """The spec tree of the ViT param layout (clipx's ``param_specs``: the
    same tree and entries, each a tuple naming the mesh axis that shards
    that dim, or None). ``tp=None`` replicates every leaf."""
    rep1, rep2 = (None,), (None, None)
    return {
        "visual": {
            "patch_embed": {"kernel": (None, tp)},
            "class_embedding": rep1,
            "pos_embedding": rep2,
            "ln_pre": {"scale": rep1, "bias": rep1},
            "blocks": _block_specs(tp),
            "ln_post": {"scale": rep1, "bias": rep1},
            "proj": rep2,
        },
        "text": {
            "token_embedding": (None, tp),
            "pos_embedding": rep2,
            "blocks": _block_specs(tp),
            "ln_final": {"scale": rep1, "bias": rep1},
            "text_projection": rep2,
        },
        "logit_scale": (),
    }


def _split_dim(spec: Spec, tp: str) -> Optional[int]:
    return spec.index(tp) if tp in spec else None


def _check_split(host: Dict, specs: Dict, tp: str, n: int, path: str,
                 cfg) -> None:
    """Raise a ValueError naming the leaf when a sharded dim does not
    divide by ``n``, or (with ``cfg``) a tower's heads do not: the port
    gives each tp position whole heads."""
    for key, val in host.items():
        name = f"{path}/{key}" if path else key
        if key not in specs:
            raise ValueError(f"{name}: no tensor-parallel rule for this "
                             "leaf")
        if isinstance(val, dict):
            _check_split(val, specs[key], tp, n, name, cfg)
            continue
        dim = _split_dim(specs[key], tp)
        if dim is None:
            continue
        if np.shape(val)[dim] % n:
            raise ValueError(f"{name}: dim {dim} of size "
                             f"{np.shape(val)[dim]} does not split over "
                             f"tp={n}")
        tower = name.split("/")[0]
        if cfg is not None and "/attn/" in name:
            heads = (cfg.vision if tower == "visual" else cfg.text).heads
            if heads % n:
                raise ValueError(
                    f"{name}: {heads} heads do not split over tp={n} (the "
                    "port gives each tp position whole heads)")


def _host_tree(tree: Dict) -> Dict:
    """Every leaf as a CPU tensor in its logical layout: a tensor's own
    memory where it has it, a numpy array's where it is writable."""
    return {key: (_host_tree(val) if isinstance(val, dict)
                  else val.detach().cpu() if isinstance(val, torch.Tensor)
                  else torch.from_numpy(np.require(val, requirements="W")))
            for key, val in tree.items()}


def _slice_tree(host: Dict, specs: Optional[Dict], tp: Optional[str],
                j: int, n: int) -> Dict:
    """Tp column j's contiguous slice of every sharded leaf and every
    replicated leaf whole, each a copy of its own (so that no two
    placements on one device share memory)."""
    out = {}
    for key, val in host.items():
        spec = specs[key] if specs is not None else None
        if isinstance(val, dict):
            out[key] = _slice_tree(val, spec, tp, j, n)
            continue
        dim = _split_dim(spec, tp) if spec is not None else None
        if dim is not None:
            size = val.shape[dim] // n
            val = val.narrow(dim, j * size, size)
        out[key] = val.clone(memory_format=torch.contiguous_format)
    return out


def _join_tree(parts: List[Dict], specs: Optional[Dict], tp: Optional[str]
               ) -> Dict:
    """The inverse of ``_slice_tree``: each sharded leaf concatenated over
    the tp columns, each replicated leaf column 0's, all f32 copies."""
    out = {}
    for key, val in parts[0].items():
        spec = specs[key] if specs is not None else None
        if isinstance(val, dict):
            out[key] = _join_tree([p[key] for p in parts], spec, tp)
            continue
        dim = _split_dim(spec, tp) if spec is not None else None
        out[key] = (val.to(torch.float32, memory_format=torch.contiguous_format,
                           copy=True) if dim is None else
                    torch.cat([p[key].float() for p in parts], dim=dim))
    return out


class Sharded:
    """A param tree over a mesh (what :func:`shard_params` returns):
    ``trees[pos]`` is position pos's tree for this process's positions
    (None for another process's). Positions on one device with the same tp
    column share one tree, so a repeated device holds one copy a column.
    ``specs`` is the spec tree (None: every leaf replicated) over axis
    ``tp``."""

    def __init__(self, mesh: Mesh, tp: Optional[str], specs: Optional[Dict],
                 trees: List[Optional[Dict]]):
        self.mesh, self.tp, self.specs, self.trees = mesh, tp, specs, trees

    @property
    def tp_size(self) -> int:
        return self.mesh.axes[self.tp] if self.tp else 1

    def column(self, pos: int) -> int:
        """Position pos's tp column (0 when replicated)."""
        return self.mesh.coord(pos, self.tp) if self.tp else 0

    def placements(self) -> List[Tuple[int, Dict]]:
        """(first position, tree) of each distinct tree, in mesh order."""
        seen, out = set(), []
        for pos in self.mesh.local_positions():
            if id(self.trees[pos]) not in seen:
                seen.add(id(self.trees[pos]))
                out.append((pos, self.trees[pos]))
        return out

    def gather(self) -> Dict:
        """Every leaf whole, as the port's f32 tensors on the CPU (the
        layout of ``convert.from_jax_params``): each tp slice from the
        first position that holds it. Over several processes every process
        must call it, and every one gets the whole tree."""
        from clipx_torch.models import convert

        first: Dict[int, int] = {}
        for pos in range(self.mesh.size):
            first.setdefault(self.column(pos), pos)
        mine = {j: _host_tree(self.trees[pos])
                for j, pos in first.items()
                if self.mesh.ranks[pos] == self.mesh.rank}
        if self.mesh.multi_process:
            import torch.distributed as dist

            everyone = [None] * dist.get_world_size()
            dist.all_gather_object(everyone, mine)
            for theirs in everyone:
                mine.update(theirs)
        full = _join_tree([mine[j] for j in range(self.tp_size)], self.specs,
                          self.tp)
        return convert.from_jax_params(full, device="cpu",
                                       dtype=torch.float32)


def shard_params(params: Any, mesh: Mesh, tp: Optional[str] = "tp", *,
                 dtype: torch.dtype = torch.float32, cfg=None) -> Sharded:
    """Place a param tree (clipx's numpy tree, or the port's tensors) onto
    ``mesh`` with the TP specs: each tp column's contiguous slice of every
    sharded leaf, once per distinct (device, column), converted as
    ``convert.from_jax_params`` does (matrices in ``dtype``). With
    ``tp=None`` (or a mesh without that axis) every leaf is replicated,
    once per distinct device, which works for any tree (the ResNet towers
    take this path). A sharded dim, or with ``cfg`` a tower's heads, that
    does not divide by the tp size raises a ValueError naming the leaf."""
    from clipx_torch.models import convert

    if tp is not None and tp not in mesh.axis_names:
        tp = None
    host = _host_tree(params)
    specs = param_specs(tp) if tp is not None else None
    n = mesh.axes[tp] if tp else 1
    if specs is not None:
        _check_split(host, specs, tp, n, "", cfg)
    out = Sharded(mesh, tp, specs, [None] * mesh.size)
    placed: Dict[tuple, Dict] = {}
    for pos in mesh.local_positions():
        key = (mesh.devices[pos], out.column(pos))
        if key not in placed:
            placed[key] = convert.from_jax_params(
                _slice_tree(host, specs, tp, key[1], n), device=key[0],
                dtype=dtype)
        out.trees[pos] = placed[key]
    return out
