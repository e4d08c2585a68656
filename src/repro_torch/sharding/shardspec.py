"""Local-shard geometry: (PartitionSpec, mesh) -> per-leaf shard facts
(port of ``repro/sharding/shardspec.py``).

The sharded optimizer and SNR paths run each rank's work on its local shard
of every leaf, so every per-leaf decision (canonical plan, kernel pick) is
made from the local shard shape, and any reduction whose dims are split
across ranks needs a cross-rank sum. This module derives those facts from a
leaf's :class:`PartitionSpec` plus the mesh axis sizes and classifies each
leaf into one of three regimes:

  * ``'local'`` — no reduced dim is sharded: the reduction line is whole on
    every rank, so the unsharded kernels run unchanged on the shard;
  * ``'psum'`` — at least one reduced dim is sharded: each rank computes
    partial sums over its slice of the line, an all-reduce over the owning
    mesh axes completes them, then the O(kept) finalisation runs;
  * ``'jnp'`` — the local canonical plan would transpose (an interleaved K
    after sharding): the leaf runs the plain math on its shard (named after
    the JAX package's regime).

Only geometry lives here; the collectives are in ``repro_torch.launch.mesh``
and the dispatch in ``repro_torch.optim.fused`` and ``repro_torch.core.snr``.
Everything is plain Python over static shapes, and :class:`SpecMesh` is a
device-free mesh stand-in, so plans can be derived for meshes larger than
the running job. ``plan_sharded_leaf`` gates on the port's
:func:`repro_torch.kernels.ops.leaf_plan`, which has no VMEM fit gate (a
CUDA kernel never holds a whole line on chip): plans equal the JAX
package's wherever that gate passes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

Dims = Tuple[int, ...]


class PartitionSpec(tuple):
    """One entry per leading dim: ``None`` (replicated), a mesh-axis name,
    or a tuple of names (the dim split over several axes, the first the
    most significant). Missing trailing entries are replicated. The port's
    counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class SpecMesh:
    """Device-free mesh stand-in: just ``shape`` + ``axis_names``, which is
    all spec and plan derivation reads."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpecMesh({self.shape})"


def mesh_is_trivial(mesh: Any) -> bool:
    """A mesh whose every axis has size 1 shards nothing."""
    return all(int(s) == 1 for s in dict(mesh.shape).values())


def spec_entries(spec: Optional[P], ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """Normalize a PartitionSpec to one tuple of mesh-axis names per dim
    (``None`` -> ``()``, ``'x'`` -> ``('x',)``), padded/truncated to ndim."""
    entries = list(spec) if spec is not None else []
    entries = entries[:ndim] + [None] * (ndim - len(entries))
    out: List[Tuple[str, ...]] = []
    for e in entries:
        if e is None:
            out.append(())
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    return tuple(out)


def dim_shards(shape: Sequence[int], spec: Optional[P], mesh: Any) -> Tuple[int, ...]:
    """Per-dim shard counts, replicating any dim the spec cannot split
    evenly (a non-dividing entry means the spec came from another shape)."""
    sizes = dict(mesh.shape)
    out = []
    for s, axes in zip(shape, spec_entries(spec, len(shape))):
        f = math.prod(int(sizes.get(a, 1)) for a in axes)
        out.append(f if f > 1 and s % f == 0 else 1)
    return tuple(out)


def even_spec(shape: Sequence[int], spec: Optional[P], mesh: Any) -> P:
    """``spec`` with the entries that do not divide ``shape`` evenly dropped:
    the spec :func:`dim_shards` actually assumed."""
    factors = dim_shards(shape, spec, mesh)
    out = []
    for f, axes in zip(factors, spec_entries(spec, len(shape))):
        if f == 1 or not axes:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return P(*out)


def masked_spec(shape: Sequence[int], spec: Optional[P], mesh: Any, dims: Dims) -> P:
    """Spec for a reduced moment stored with size-1 ``dims``: the evened
    param spec with the reduced-dim entries dropped."""
    dset = {d % len(shape) for d in dims}
    entries = list(even_spec(shape, spec, mesh))
    entries += [None] * (len(shape) - len(entries))
    return P(*[None if i in dset else e for i, e in enumerate(entries)])


def local_shape(shape: Sequence[int], spec: Optional[P], mesh: Any) -> Tuple[int, ...]:
    """Per-rank shard shape under the evened spec."""
    return tuple(s // f for s, f in zip(shape, dim_shards(shape, spec, mesh)))


def global_shape(shard_shape: Sequence[int], spec: Optional[P], mesh: Any) -> Tuple[int, ...]:
    """Inverse of :func:`local_shape` for an even spec (each entry's axes
    divide their dim): the global shape a local shard belongs to."""
    sizes = dict(mesh.shape)
    return tuple(int(s) * math.prod(int(sizes.get(a, 1)) for a in axes)
                 for s, axes in zip(shard_shape, spec_entries(spec, len(shard_shape))))


def owning_axes(shape: Sequence[int], spec: Optional[P], mesh: Any, dims: Dims) -> Tuple[str, ...]:
    """Mesh axes that actually shard any of ``dims`` (the all-reduce axes
    for a reduction over those dims). Empty when the dims are whole on
    every rank."""
    factors = dim_shards(shape, spec, mesh)
    entries = spec_entries(spec, len(shape))
    dset = {d % len(shape) for d in dims}
    out: List[str] = []
    for i in sorted(dset):
        if factors[i] > 1:
            out.extend(a for a in entries[i] if a not in out)
    return tuple(out)


class ShardLeafPlan(NamedTuple):
    """Per-leaf sharding regime and the specs to run it under.

    ``regime`` is 'local' | 'psum' | 'jnp' (dense K = () leaves are always
    'local'). ``spec`` / ``red_spec`` are the evened full-leaf and
    reduced-moment specs; ``psum_axes`` the mesh axes owning sharded
    reduced dims ('psum' only); ``red_total`` the global reduction extent.

    Psum extras: ``finalize`` ('kernel' | 'jnp') records whether the local
    canonical plan is servable by the partial-stats/finalize kernel pair,
    with that plan in ``cn``; ``owner`` the owner placement of the reduced
    moment, ``((mesh_axis, dim), ...)``, and ``nu_spec`` its storage spec —
    each rank stores only its owner slice of v', and the all-reduce that
    completes the line sums also delivers the full v' to every rank (empty /
    ``red_spec`` when no kept dim divides). ``kept_axes`` are the mesh axes
    sharding kept dims (the averaging axes of the from-update SNR)."""

    regime: str
    spec: P
    red_spec: P
    psum_axes: Tuple[str, ...]
    local_shape: Tuple[int, ...]
    red_total: int
    finalize: str = "kernel"
    owner: Tuple[Tuple[str, int], ...] = ()
    nu_spec: Optional[P] = None
    kept_axes: Tuple[str, ...] = ()
    cn: Optional[Any] = None    # local CanonND, set iff finalize == 'kernel'


def owner_factor(pl: ShardLeafPlan, mesh: Any) -> int:
    """Dedupe factor the owner placement achieves for the stored reduced
    moment (1 = fully replicated across the psum group)."""
    sizes = dict(mesh.shape)
    return math.prod(int(sizes.get(a, 1)) for a, _ in pl.owner)


def psum_kernel_eligible(pl: ShardLeafPlan, use_first_moment: bool = True) -> bool:
    """Whether a psum-regime leaf runs the partial-stats/finalize kernels
    (vs the plain math on its shard): the local canonical plan must be
    servable and the caller must carry a first moment. One predicate for the
    per-leaf dispatch and the grouped dispatch, so they never disagree."""
    return bool(use_first_moment and pl.finalize == "kernel" and pl.cn is not None)


def owner_placement(red_shape: Sequence[int], red_spec: P, psum_axes: Sequence[str],
                    mesh: Any) -> Tuple[Tuple[Tuple[str, int], ...], P]:
    """Greedy owner placement for a psum leaf's reduced moment: each psum
    axis goes onto a kept dim whose local extent it divides evenly (largest
    first), so each rank stores a 1/A slice. All or nothing: if any psum
    axis finds no dim, the moment stays replicated — a partial placement
    would make the ranks along an unplaced axis each add the same ``b2 * v``
    copy into the all-reduce. Returns ``(placement, nu_spec)``."""
    sizes = dict(mesh.shape)
    entries = [list(e) for e in spec_entries(red_spec, len(red_shape))]
    local = [s // math.prod(int(sizes.get(a, 1)) for a in e) for s, e in zip(red_shape, entries)]
    placement: List[Tuple[str, int]] = []
    for a in psum_axes:
        f = int(sizes.get(a, 1))
        if f <= 1:
            continue
        for i in sorted(range(len(red_shape)), key=lambda j: -local[j]):
            if local[i] > 1 and local[i] % f == 0:
                entries[i].append(a)
                local[i] //= f
                placement.append((a, i))
                break
        else:
            return (), red_spec
    nu_spec = P(*[None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries])
    return tuple(placement), nu_spec


def plan_sharded_leaf(shape: Sequence[int], dtype: Any, dims: Dims, spec: Optional[P],
                      mesh: Any) -> ShardLeafPlan:
    """Classify one leaf's sharding regime and derive its specs. The JAX
    signature's ``n_bufs`` sizes its VMEM gate; the port's gate
    (``kernels.tiling.strip_fits``, consulted by ``leaf_plan``) charges
    nothing for it."""
    from ..kernels.ops import leaf_plan

    shape = tuple(int(s) for s in shape)
    dims = tuple(dims)
    spec_e = even_spec(shape, spec, mesh)
    lshape = local_shape(shape, spec, mesh)
    if not dims:
        return ShardLeafPlan("local", spec_e, spec_e, (), lshape, 1)
    dset = {d % len(shape) for d in dims}
    red_spec = masked_spec(shape, spec, mesh, dims)
    red_total = math.prod(shape[i] for i in sorted(dset))
    psum_axes = owning_axes(shape, spec, mesh, dims)
    kept = tuple(i for i in range(len(shape)) if i not in dset)
    kept_axes = owning_axes(shape, spec, mesh, kept)
    if psum_axes:
        red_shape = tuple(1 if i in dset else s for i, s in enumerate(shape))
        owner, nu_spec = owner_placement(red_shape, red_spec, psum_axes, mesh)
        lplan = leaf_plan(lshape, dtype, dims, allow_transpose=False)
        finalize = "kernel" if lplan.route == "slim" else "jnp"
        return ShardLeafPlan("psum", spec_e, red_spec, psum_axes, lshape, red_total, finalize=finalize,
                             owner=owner, nu_spec=nu_spec, kept_axes=kept_axes, cn=lplan.cn)
    plan = leaf_plan(lshape, dtype, dims, allow_transpose=False)
    regime = "local" if plan.route in ("dense", "slim") else "jnp"
    return ShardLeafPlan(regime, spec_e, red_spec, (), lshape, red_total, kept_axes=kept_axes)


def plan_sharded_tree(shapes: Sequence[Tuple[int, ...]], dtypes: Sequence[Any], dims_leaves: Sequence[Dims],
                      spec_leaves: Sequence[Optional[P]], mesh: Any) -> List[ShardLeafPlan]:
    """:func:`plan_sharded_leaf` over aligned leaf lists."""
    return [plan_sharded_leaf(s, dt, tuple(d), sp, mesh)
            for s, dt, d, sp in zip(shapes, dtypes, dims_leaves, spec_leaves)]


def regime_counts(plans: Sequence[ShardLeafPlan], *, degraded: int = 0) -> Dict[str, int]:
    """{'local', 'psum', 'psum_jnp', 'jnp', 'degraded'} counts over a planned
    tree. 'psum' counts only kernel-resident psum leaves; 'psum_jnp' the
    psum leaves whose local plan the kernel pair cannot serve; 'degraded'
    the runtime count of leaves an injected kernel fault sent to the plain
    math (``repro_torch.optim.fused.kernel_degraded_leaves()``)."""
    out = {"local": 0, "psum": 0, "psum_jnp": 0, "jnp": 0, "degraded": int(degraded)}
    for pl in plans:
        if pl.regime == "psum" and pl.finalize != "kernel":
            out["psum_jnp"] += 1
        else:
            out[pl.regime] += 1
    return out


def sharded_pair(mesh: Any, param_specs: Any, what: str):
    """Validate the (mesh, param_specs) pair the sharded fused backend needs:
    both -> sharded path, neither -> plain path, exactly one -> warn and run
    unsharded."""
    import warnings

    if (mesh is None) != (param_specs is None):
        missing = "param_specs" if param_specs is None else "mesh"
        warnings.warn(f"{what}: got only one of mesh/param_specs ({missing} is None); the fused backend will "
                      f"run UNSHARDED. Pass both to enable the sharded path.", stacklevel=3)
        return None, None
    return mesh, param_specs


def normalize_spec_leaves(param_specs: Any, names: Sequence[str], what: str) -> List[Optional[P]]:
    """Per-leaf spec list aligned with ``names`` (the flat tree's keys, in
    order) from a ``{name: spec}`` dict or an aligned sequence. A spec dict
    whose keys differ from the tree's raises: a mismatched tree would pair
    specs with the wrong leaves."""
    names = list(names)
    if param_specs is None:
        return [None] * len(names)
    if isinstance(param_specs, Mapping):
        if set(param_specs) != set(names):
            raise ValueError(f"{what}: param_specs keys {sorted(param_specs)} do not mirror the tree being "
                             f"updated ({sorted(names)}); build the specs with "
                             f"repro_torch.sharding.logical.param_specs from the same parameters")
        return [param_specs[k] for k in names]
    if isinstance(param_specs, (list, tuple)) and not isinstance(param_specs, P) \
            and len(param_specs) == len(names):
        return list(param_specs)
    raise ValueError(f"{what}: param_specs must be a {{name: spec}} dict or a leaf-aligned list")


def spec_dtype(x: Any) -> Any:
    """dtype of a tensor leaf (f32 fallback)."""
    return getattr(x, "dtype", torch.float32)
