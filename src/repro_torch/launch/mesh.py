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
CPU every collective is gloo's own. A dry run (``repro_torch.launch.dryrun``)
builds a production-sized mesh in one process over PyTorch's ``fake``
backend (:func:`fake_world`), with ``meta`` tensors: its collectives move
no data, and :meth:`Mesh.collective_stats` counts them as on the card.

Every process group gets a timeout, so a rank that raises ends the run
instead of leaving the others blocked in a collective.

Collectives with a backward. The forward's tensor-, sequence- and
expert-parallel regions and the GPipe schedule move activations through
:func:`all_gather`, :func:`psum_scatter`, :func:`psum` and :func:`ppermute`
(``lax.all_gather(..., tiled=True)``, ``lax.psum_scatter(..., tiled=True)``,
``lax.psum``, ``lax.ppermute``), each a ``torch.autograd.Function`` whose
backward is its transpose: all-gather and reduce-scatter each other's,
psum its own, a permutation its inverse. Under that rule the gradients of
``sum over ranks of each rank's loss`` come out on the ranks that own the
weights they belong to. The reduce-scatter is an all-reduce and a cut
(gloo on a card, where it runs here, has no reduce-scatter of device
tensors), and the permutation an all-gather over its axis from which each
rank takes its source's block (gloo's point-to-point calls take no device
tensors). :meth:`Mesh.collective_stats` counts every call of these four,
with its bytes; with ``mesh.timed = True`` each call also synchronizes the
device before and after itself and adds its wall time (off by default: it
serializes the host with the card).

The production meshes stay functions. The TPU's hardware constants are
not carried over: the card's below are one NVIDIA H100's, for the dry
run's roofline and fit.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..sharding.shardspec import PartitionSpec, even_spec, global_shape, spec_entries

DEFAULT_TIMEOUT = datetime.timedelta(minutes=3)

# One NVIDIA H100 SXM, as ``nvidia-smi --query-gpu=name,power.limit`` names
# the card the port runs on: "NVIDIA H100 80GB HBM3, 700.00 W". The rates
# are NVIDIA's data sheet at that power limit (dense, without sparsity); a
# card set below it runs slower. The memory is what
# ``torch.cuda.get_device_properties(0).total_memory`` reports on it.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12                # B/s
HBM_PER_GPU = 85_017_493_504    # B (79.18 GiB)
LINK_BW = 450e9                 # B/s each way over NVLink 4 (900 GB/s both ways)


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
        self.timed = False
        self._stats: Dict[str, List[float]] = {}
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

    def pmax(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Elementwise max of ``x`` over the ranks of ``axes``
        (``lax.pmax``), as a new tensor. No backward: the optimizer
        statistics that take it are not differentiated."""
        if not axes:
            return x
        group, _ = self._group(axes)
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
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

    def group_index(self, axes: Sequence[str]) -> int:
        """This rank's position in ``axes``' group (row-major over the axes,
        the first most significant), the block a tiled collective gives it."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def collective_stats(self, reset: bool = False) -> Dict[str, Dict[str, float]]:
        """``{kind: {'calls', 'bytes', 'seconds'}}`` of the differentiable
        collectives since the last reset (``seconds`` only while
        ``timed``), forward and backward calls alike."""
        out = {k: dict(calls=v[0], bytes=v[1], seconds=v[2]) for k, v in self._stats.items()}
        if reset:
            self._stats = {}
        return out

    def _record(self, kind: str, nbytes: int, fn):
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        row = self._stats.setdefault(kind, [0, 0, 0.0])
        row[0] += 1
        row[1] += nbytes
        if self.timed:
            row[2] += time.perf_counter() - t0
        return out

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


def _axes(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _gather_cat(mesh: Mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    return mesh._record("all_gather", x.numel() * x.element_size() * mesh.axis_size(axes),
                        lambda: torch.cat(mesh.all_gather(x, axes), dim=dim))


def _sum_cut(mesh: Mesh, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does not split over {axes} ({n})")
    blk = x.shape[dim] // n
    return mesh._record("psum_scatter", x.numel() * x.element_size(),
                        lambda: mesh.psum(x, axes).narrow(dim, mesh.group_index(axes) * blk, blk).contiguous())


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather_cat(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _sum_cut(ctx.mesh, g.contiguous(), ctx.axes, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _sum_cut(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(ctx.mesh, g.contiguous(), ctx.axes, ctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._record("psum", x.numel() * x.element_size(), lambda: mesh.psum(x, axes))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return mesh._record("psum", g.numel() * g.element_size(), lambda: mesh.psum(g, ctx.axes)), None, None


def _permute(mesh: Mesh, x: torch.Tensor, axis: str, source: Dict[int, int]) -> torch.Tensor:
    """``x`` of the rank at index ``source[i]`` along ``axis`` for this rank
    at index i, zeros where i has no source."""
    parts = mesh._record("ppermute", x.numel() * x.element_size() * mesh.shape[axis],
                         lambda: mesh.all_gather(x, (axis,)))
    src = source.get(mesh.axis_index(axis))
    return torch.zeros_like(x) if src is None else parts[src]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(mesh, x.contiguous(), axis, {d: s for s, d in perm})

    @staticmethod
    def backward(ctx, g):
        return _permute(ctx.mesh, g.contiguous(), ctx.axis, {s: d for s, d in ctx.perm}), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the blocks of every
    rank of ``axis``' group (a name or a tuple of names), concatenated along
    ``dim`` in group order. Its backward is :func:`psum_scatter`."""
    return _AllGather.apply(x.contiguous(), mesh, _axes(axis), dim)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis, dim: int) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``: the
    sum over ``axis``' group, of which this rank keeps its block along
    ``dim``; the sum is in ``x``'s dtype. Its backward is
    :func:`all_gather`."""
    return _PsumScatter.apply(x.contiguous(), mesh, _axes(axis), dim)


def psum(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """``lax.psum(x, axis)`` with a backward (itself)."""
    return _Psum.apply(x.contiguous(), mesh, _axes(axis))


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)``: the rank at index ``d`` along
    ``axis`` receives ``x`` of the rank at ``s`` for each ``(s, d)`` in
    ``perm``, and zeros if it is no destination. Its backward sends the
    gradients along the inverse permutation."""
    return _PPermute.apply(x, mesh, axis, tuple((int(s), int(d)) for s, d in perm))


def axis_index(mesh: Mesh, axis: str) -> int:
    """``lax.axis_index(axis)``."""
    return mesh.axis_index(axis)


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

    # a dry run's mesh holds meta tensors; its device mesh is a CPU one
    kind = "cpu" if device.type == "meta" else device.type
    dm = init_device_mesh(kind, tuple(int(s) for s in shape), mesh_dim_names=tuple(axes))
    return Mesh(dm, device, backend, timeout)


def fake_world(world_size: int) -> None:
    """Initialise this process's default group as rank 0 of a
    ``world_size``-rank world on PyTorch's ``fake`` backend, whose
    collectives return at once and move no data: with ``device="meta"``,
    :func:`make_mesh` then builds a production-sized mesh in one process
    for a dry run (``repro_torch.launch.dryrun``), which runs the step on
    tensors that hold no data. One process holds one default group, so
    each dry run takes a process of its own."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, **kw) -> Mesh:
    """Single pod (data=16, model=16), or 2 pods as (pod=2, data=16,
    model=16): 'pod' is pure data parallelism, 'data' the FSDP axis,
    'model' the TP/EP axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, **kw)
