"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

A :class:`Mesh` is a named ``(data, model, ...)`` grid of ranks, one
process each, built on ``torch.distributed.device_mesh.init_device_mesh``.
It carries what the sharded optimizer and SNR paths need in place of JAX's
``shard_map``: each rank's coordinates, the collectives over any subset of
the mesh axes (``lax.psum`` / ``lax.pmean`` become :meth:`Mesh.psum` /
:meth:`Mesh.pmean`, an ``all_reduce`` over that subset's group), and the
cut of a global tensor into this rank's shard by a PartitionSpec and the
gather back (:meth:`Mesh.shard`, :meth:`Mesh.gather`).

Transport. With one GPU per rank, rank r uses ``cuda:r`` and NCCL. Where
ranks outnumber the GPUs (several ranks on one card, as ``chip_smoke.py``
runs a ``(2, 2)`` mesh on one H100), NCCL refuses two ranks on one device,
so the ranks use gloo, whose all_reduce and all_gather take the CUDA
tensors themselves (PyTorch 2.11); the tensors and every kernel stay on
the GPU. :meth:`transport_note` says which transport a mesh uses. On the
CPU every collective is gloo's own.

Every process group gets a timeout, so a rank that raises ends the run
instead of leaving the others blocked in a collective.

The production meshes stay functions, and the TPU's hardware constants are
not carried over.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..sharding.shardspec import PartitionSpec, even_spec, global_shape, spec_entries

DEFAULT_TIMEOUT = datetime.timedelta(minutes=3)


class Mesh:
    """This rank's view of a named mesh of ranks. ``shape`` maps axis name
    to size (what :mod:`repro_torch.sharding.shardspec` reads);
    ``coords`` this rank's index along each axis; ``device`` its tensors'
    device. Build it with :func:`make_mesh`."""

    def __init__(self, device_mesh, device: torch.device, backend: str,
                 timeout: datetime.timedelta = DEFAULT_TIMEOUT):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in device_mesh.mesh.shape)))
        self.size = math.prod(self.shape.values())
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = dict(zip(self.axis_names, (int(c) for c in device_mesh.get_coordinate())))
        self._groups: Dict[frozenset, Tuple[Optional[dist.ProcessGroup], List[int]]] = {}
        # One group per axis subset, created in the same order on every rank
        # (new_group is collective): single axes take the device mesh's own
        # groups, the full set the world group, larger proper subsets new ones.
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                key = frozenset(axes)
                members = self._members(axes, self.coords)
                if n == len(self.axis_names):
                    self._groups[key] = (None, members)
                elif n == 1:
                    self._groups[key] = (device_mesh.get_group(axes[0]), members)
                else:
                    mine = None
                    others = [a for a in self.axis_names if a not in axes]
                    for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                        ranks = self._members(axes, dict(zip(others, fixed)))
                        grp = dist.new_group(ranks=ranks, timeout=timeout)
                        if ranks == members:
                            mine = grp
                    self._groups[key] = (mine, members)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, {self.backend} on {self.device})"

    # -- geometry -----------------------------------------------------------

    def coords_of(self, rank: int) -> Dict[str, int]:
        """Coordinates of ``rank`` (row-major, the device mesh's layout)."""
        out, rest = {}, rank
        for a in reversed(self.axis_names):
            out[a] = rest % self.shape[a]
            rest //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _members(self, axes: Sequence[str], fixed: Dict[str, int]) -> List[int]:
        """Ranks that agree with ``fixed`` on every axis outside ``axes``."""
        out = []
        for r in range(self.size):
            c = self.coords_of(r)
            if all(c[a] == fixed[a] for a in self.axis_names if a not in axes):
                out.append(r)
        return out

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def _group(self, axes: Sequence[str]):
        return self._groups[frozenset(axes)]

    def _block(self, shape: Sequence[int], spec, coords: Dict[str, int]):
        """(dim, start, length) of the shard at ``coords`` of a global
        ``shape`` under an even ``spec``; the axes of a tuple entry split
        the dim with the first one most significant."""
        out = []
        for d, (s, axes) in enumerate(zip(shape, spec_entries(spec, len(shape)))):
            if not axes:
                continue
            n = math.prod(self.shape[a] for a in axes)
            idx = 0
            for a in axes:
                idx = idx * self.shape[a] + coords[a]
            out.append((d, idx * (s // n), s // n))
        return out

    # -- collectives ----------------------------------------------------------

    def psum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axes`` (``lax.psum``), as a new
        tensor; every rank of the group gets the same bits."""
        if not axes:
            return x
        group, _ = self._group(axes)
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    def pmean(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Mean of ``x`` over the ranks of ``axes`` (``lax.pmean``)."""
        if not axes:
            return x
        return self.psum(x, axes) / self.axis_size(axes)

    def all_gather(self, x: torch.Tensor, axes: Sequence[str]) -> List[torch.Tensor]:
        """``x`` of every rank of ``axes``' group, in the group's rank
        order, on ``x``'s device."""
        group, members = self._group(axes)
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in members]
        dist.all_gather(parts, src, group=group)
        return parts

    def barrier(self) -> None:
        dist.barrier()

    def transport_note(self) -> str:
        """One line saying how this mesh's collectives move data."""
        where = f"{self.size} ranks on {self.device} over {self.backend}"
        if self.backend == "gloo" and self.device.type == "cuda":
            return f"mesh {self.shape}: {where}; all_reduce and all_gather on the device tensors"
        return f"mesh {self.shape}: {where}"

    # -- shards -----------------------------------------------------------------

    def shard(self, full: torch.Tensor, spec: Optional[PartitionSpec]) -> torch.Tensor:
        """This rank's shard of a global tensor (a contiguous copy where the
        spec splits it): the entries of ``spec`` that do not divide
        ``full``'s shape replicate, as in :func:`even_spec`."""
        spec = even_spec(tuple(full.shape), spec, self)
        out = full
        for d, start, length in self._block(tuple(full.shape), spec, self.coords):
            out = out.narrow(d, start, length)
        return out.contiguous() if out is not full else full

    def gather(self, local: torch.Tensor, spec: Optional[PartitionSpec]) -> torch.Tensor:
        """The global tensor from every rank's shard under an even ``spec``
        (one all_gather over the axes the spec uses; none for a replicated
        leaf)."""
        axes = tuple(a for e in spec_entries(spec, local.ndim) for a in e)
        if not axes:
            return local
        shape = global_shape(tuple(local.shape), spec, self)
        _, members = self._group(axes)
        out = torch.empty(shape, dtype=local.dtype, device=local.device)
        for r, part in zip(members, self.all_gather(local, axes)):
            view = out
            for d, start, length in self._block(shape, spec, self.coords_of(r)):
                view = view.narrow(d, start, length)
            view.copy_(part)
        return out


class NamedSharding:
    """A spec on a mesh: how one leaf is laid out over the ranks
    (``jax.sharding.NamedSharding``). Not a tuple, so state walkers take it
    as a leaf."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"NamedSharding({self.spec!r})"

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        return self.mesh.shard(full, self.spec)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return self.mesh.gather(local, self.spec)


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None, backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A named mesh of ``prod(shape)`` ranks; every rank calls this with the
    same arguments. Runs on CUDA unless ``device`` names the CPU (raises
    without a GPU otherwise).

    The process group is initialised here unless it already is: rank and
    world size from the arguments or the launcher's ``RANK`` /
    ``WORLD_SIZE`` environment (torchrun), the rendezvous from
    ``init_method`` (``env://`` by default). On CUDA, rank r uses GPU
    ``LOCAL_RANK % device_count``; the backend defaults to NCCL when every
    rank has its own GPU and to gloo when ranks share one, or run on the
    CPU."""
    device = resolve_device(device)
    n = math.prod(int(s) for s in shape)
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
        world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if world_size != n:
        raise ValueError(f"make_mesh: mesh {tuple(shape)} needs {n} ranks, the job has {world_size}")
    shared = False
    if device.type == "cuda":
        n_gpu = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local_rank % n_gpu)
        torch.cuda.set_device(device)
        shared = world_size > n_gpu
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        backend = backend or ("nccl" if device.type == "cuda" and not shared else "gloo")
        if world_size == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                    world_size=world_size, timeout=timeout)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, tuple(int(s) for s in shape), mesh_dim_names=tuple(axes))
    return Mesh(dm, device, backend, timeout)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> Mesh:
    """Single pod (data=16, model=16), or 2 pods as (pod=2, data=16,
    model=16): 'pod' is pure data parallelism, 'data' the FSDP axis,
    'model' the TP/EP axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, **kw)
