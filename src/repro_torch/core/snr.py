"""Layer-wise SNR of Adam's second moments (port of ``repro/core/snr.py``,
paper Eq. 3-4; ``measure_tree_snr`` also consumes the from-update SNR a
SlimAdam measure step publishes, and measures sharded moments on a mesh).

For a second-moment tensor V and compression dims K:

    SNR_K(V) = E_{K'}[ (E_K[V])^2 / Var_K[V] ]

``SNR_K >~ 1`` means the entries along K are well represented by their mean.
:class:`SNRTracker` accumulates the paper's time-averaged SNR (Eq. 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..optim.base import resolve_backend
from .labels import ParamMeta, flatten_with_names

_VAR_EPS = 1e-30  # guards 0/0 for exactly-constant slices; SNR -> huge (compressible)


def snr_along_dims(v: torch.Tensor, dims: Tuple[int, ...], *, per_remaining_dim: Optional[int] = None,
                   backend: str = "jnp", mesh=None, spec=None) -> torch.Tensor:
    """SNR_K for positional reduction dims: a 0-d tensor, or with
    ``per_remaining_dim`` a vector over that kept dim.

    ``backend='fused'`` (or 'auto' on CUDA) computes the per-line ratios of
    both forms through the one-pass centered-stats kernel on the canonical
    view: a single read of V, plus one re-layout copy where K is interleaved
    with kept dims. Unlike the JAX package, every candidate takes the
    kernel: no line is too long and no view is refused for its transpose.

    ``mesh`` + ``spec``: ``v`` is this rank's shard of a moment laid out by
    ``spec`` over ``mesh`` (a ``repro_torch.launch.mesh.Mesh``), and the
    scalar is the global moment's, equal on every rank: lines whole on the
    shard are measured locally and their ratios averaged across the ranks
    that split the kept dims; lines split across ranks take per-shard
    partial centered stats (B9 on the fused backend), rebase them to a
    common shift, and sum them across the owning ranks before the ratio
    (:func:`_psum_line_snr`)."""
    if not dims:
        raise ValueError("K must be non-empty for SNR; K=None means 'no compression'")
    if mesh is not None and spec is not None:
        from ..sharding.shardspec import mesh_is_trivial

        if not mesh_is_trivial(mesh):
            if per_remaining_dim is not None:
                raise ValueError("per-remaining-dim SNR curves are single-device only; pass mesh=None for "
                                 "per-depth reporting")
            return _sharded_snr(v, tuple(dims), spec, mesh, backend)
    if not all(-v.ndim <= d < v.ndim for d in dims):
        raise ValueError(f"reduction dims {dims} out of range for shape {tuple(v.shape)}")
    dims = tuple(d % v.ndim for d in dims)
    kept = [d for d in range(v.ndim) if d not in dims]
    if resolve_backend(backend, v.device) == "fused":
        from ..kernels.ops import canon_apply, canon_nd, snr_op

        cn = canon_nd(tuple(v.shape), dims)
        ratio = snr_op(canon_apply(v.float(), cn).contiguous(), axis=cn.axis).reshape([v.shape[d] for d in kept])
    else:
        v = v.float()
        mean = torch.mean(v, dim=dims, keepdim=True)
        var = torch.mean(torch.square(v - mean), dim=dims, keepdim=True)
        ratio = (torch.square(mean) / (var + _VAR_EPS)).squeeze(dims)
    if per_remaining_dim is None:
        return torch.mean(ratio)
    if per_remaining_dim not in kept:
        raise ValueError(f"dim {per_remaining_dim} was reduced by K={dims}")
    axis_after = kept.index(per_remaining_dim)
    other = tuple(i for i in range(ratio.ndim) if i != axis_after)
    return torch.mean(ratio, dim=other) if other else ratio


def _psum_line_snr(v_loc: torch.Tensor, dims: Tuple[int, ...], axes: Tuple[str, ...], red_total: int,
                   backend: str, mesh) -> torch.Tensor:
    """Per-rank body for reduction lines split across ``axes``: partial
    centered stats of the shard's slices (B9, ``snr_partial_op``, on the
    fused backend; the plain math otherwise), rebased to the mean of the
    shards' shifts and summed across ``axes``, then each line's ratio.
    Returns the mean ratio over this rank's lines."""
    from ..kernels.ref import rebase_centered_stats, snr_from_centered_stats, snr_stats_centered_partial_ref

    v32 = v_loc.float()
    dset = tuple(sorted({d % v32.ndim for d in dims}))
    n_loc = 1
    for d in dset:
        n_loc *= v32.shape[d]
    if resolve_backend(backend, v32.device) == "fused":
        from ..kernels.ops import canon_apply, canon_nd, snr_partial_op

        cn = canon_nd(tuple(v32.shape), dset)
        s1, s1c, s2c, first = snr_partial_op(canon_apply(v32, cn).contiguous(), axis=cn.axis)
    else:
        s1, s1c, s2c, first = snr_stats_centered_partial_ref(v32, dset)
    # variance is shift-invariant but the sums are not: one common shift first
    shift = mesh.pmean(first, axes)
    s1c, s2c = rebase_centered_stats(s1c, s2c, first, shift, n_loc)
    ratio = snr_from_centered_stats(mesh.psum(s1, axes), mesh.psum(s1c, axes), mesh.psum(s2c, axes), red_total,
                                    eps=_VAR_EPS)
    return torch.mean(ratio)


def _sharded_snr(v_loc: torch.Tensor, dims: Tuple[int, ...], spec, mesh, backend: str) -> torch.Tensor:
    """Scalar SNR_K of the moment whose shard on this rank is ``v_loc``
    (see :func:`snr_along_dims`). Every rank of the mesh gets the value."""
    from ..sharding.shardspec import global_shape, owning_axes

    ndim = v_loc.ndim
    if any(not -ndim <= d < ndim for d in dims) or len({d % ndim for d in dims}) != len(dims):
        raise ValueError(f"bad reduction dims {dims} for shape {tuple(v_loc.shape)}")
    dset = tuple(sorted({d % ndim for d in dims}))
    kept = tuple(i for i in range(ndim) if i not in dset)
    shape = global_shape(tuple(v_loc.shape), spec, mesh)
    red_axes = owning_axes(shape, spec, mesh, dset)
    kept_axes = owning_axes(shape, spec, mesh, kept)
    if red_axes:
        s = _psum_line_snr(v_loc, dset, red_axes, math.prod(shape[d] for d in dset), backend, mesh)
    else:
        s = snr_along_dims(v_loc, dset, backend=backend)
    # each rank holds an equal share of the kept lines: the global ratio
    # mean is the mean of the per-rank means
    return mesh.pmean(s, kept_axes) if kept_axes else s


def measure_leaf_snr(v: torch.Tensor, meta: ParamMeta, *, backend: str = "jnp", mesh=None,
                     spec=None) -> Dict[str, torch.Tensor]:
    """Scalar SNR per candidate K ('fan_in'/'fan_out'/'both') for one tensor."""
    return {label: snr_along_dims(v, meta.dims_of(axes), backend=backend, mesh=mesh, spec=spec)
            for label, axes in meta.candidate_ks().items()}


def measure_leaf_snr_per_layer(v: torch.Tensor, meta: ParamMeta) -> Dict[str, torch.Tensor]:
    """Per-depth SNR vectors for stacked tensors (axis 'layers'): one value
    per layer for each candidate K; other tensors as :func:`measure_leaf_snr`."""
    if "layers" not in meta.axes:
        return measure_leaf_snr(v, meta)
    layer_dim = meta.axes.index("layers")
    return {label: snr_along_dims(v, meta.dims_of(axes), per_remaining_dim=layer_dim)
            for label, axes in meta.candidate_ks().items()}


def measure_tree_snr(nu: Mapping[str, torch.Tensor], meta: Mapping[str, ParamMeta], *,
                     backend: str = "jnp", mesh=None, param_specs: Optional[Mapping[str, Any]] = None,
                     from_update: Optional[Mapping[str, Optional[torch.Tensor]]] = None,
                     update_dims: Optional[Mapping[str, Tuple[int, ...]]] = None
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{param_name: {K_label: snr}} over a second-moment dict; vector-like
    leaves give an empty dict (the paper never compresses them).

    ``mesh`` + ``param_specs``: ``nu`` holds this rank's shards, each laid
    out by its spec in ``param_specs`` (``{name: PartitionSpec}``, the
    moments' storage specs: the parameter specs for Adam), and every value
    is the global moment's, equal on every rank.

    ``from_update`` + ``update_dims`` consume SNR scalars that rode the
    optimizer's update pass (``scale_by_slim_adam(emit_snr=True)`` publishes
    them on ``state.snr``; ``update_dims`` is the optimizer's per-leaf
    reduction dims): for each leaf, the candidate K whose dims equal the
    leaf's update K takes the ridden value with no read of nu, and only the
    other candidates are measured from nu."""
    ridden: Dict[str, Tuple[torch.Tensor, Tuple[int, ...]]] = {}
    if from_update is not None:
        if update_dims is None:
            raise ValueError("measure_tree_snr: from_update needs update_dims (the optimizer's per-leaf "
                             "reduction dims)")
        ridden = {name: (s, tuple(update_dims[name])) for name, s in from_update.items()
                  if s is not None and name in update_dims}
    if mesh is not None or param_specs is not None:
        from ..sharding.shardspec import normalize_spec_leaves, sharded_pair

        mesh, param_specs = sharded_pair(mesh, param_specs, "measure_tree_snr")
    meta_by_name = dict(flatten_with_names(meta))
    named = flatten_with_names(nu)
    specs = dict(zip([n for n, _ in named], normalize_spec_leaves(param_specs, [n for n, _ in named],
                                                                  "measure_tree_snr"))) if mesh is not None else {}
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, v in named:
        m = meta_by_name[name]
        kw = dict(backend=backend, mesh=mesh, spec=specs.get(name))
        if name not in ridden:
            out[name] = measure_leaf_snr(v, m, **kw)
            continue
        s_val, s_dims = ridden[name]
        key = sorted(d % v.ndim for d in s_dims)
        out[name] = {label: s_val if sorted(d % v.ndim for d in m.dims_of(axes)) == key
                     else snr_along_dims(v, m.dims_of(axes), **kw)
                     for label, axes in m.candidate_ks().items()}
    return out


@dataclasses.dataclass
class SNRTracker:
    """Accumulates time-averaged SNR (paper Eq. 4) plus full trajectories.
    The paper measures every 100 steps for the first 1000, then every 1000."""

    sums: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    count: int = 0
    trajectory: Dict[str, Dict[str, list]] = dataclasses.field(default_factory=dict)
    steps: list = dataclasses.field(default_factory=list)

    @staticmethod
    def should_measure(step: int, early_every: int = 100, late_every: int = 1000,
                       early_until: int = 1000) -> bool:
        if step <= early_until:
            return step % early_every == 0
        return step % late_every == 0

    def update(self, snr_by_param: Mapping[str, Mapping[str, torch.Tensor]], step: int) -> None:
        """Record one measurement (reads every value to the host)."""
        self.count += 1
        self.steps.append(int(step))
        for pname, by_k in snr_by_param.items():
            psum = self.sums.setdefault(pname, {})
            ptraj = self.trajectory.setdefault(pname, {})
            for k, v in by_k.items():
                val = float(v)
                psum[k] = psum.get(k, 0.0) + val
                ptraj.setdefault(k, []).append(val)

    def averaged(self) -> Dict[str, Dict[str, float]]:
        """E_t[SNR_K] per parameter per candidate K."""
        if self.count == 0:
            return {}
        return {p: {k: s / self.count for k, s in by_k.items()} for p, by_k in self.sums.items()}


def compression_ratio(meta: ParamMeta, shape: Sequence[int], k_axes: Optional[Tuple[str, ...]]) -> float:
    """Stored-elements fraction for a given compression choice (1.0 = Adam)."""
    if not k_axes:
        return 1.0
    dims = set(meta.dims_of(k_axes))
    kept = total = 1
    for i, s in enumerate(shape):
        total *= s
        if i not in dims:
            kept *= s
    return kept / total
