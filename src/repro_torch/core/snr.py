"""Layer-wise SNR of Adam's second moments (port of ``repro/core/snr.py``,
paper Eq. 3-4, single device; ``measure_tree_snr`` also consumes the
from-update SNR a SlimAdam measure step publishes).

For a second-moment tensor V and compression dims K:

    SNR_K(V) = E_{K'}[ (E_K[V])^2 / Var_K[V] ]

``SNR_K >~ 1`` means the entries along K are well represented by their mean.
:class:`SNRTracker` accumulates the paper's time-averaged SNR (Eq. 4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..optim.base import resolve_backend
from .labels import ParamMeta, flatten_with_names

_VAR_EPS = 1e-30  # guards 0/0 for exactly-constant slices; SNR -> huge (compressible)


def snr_along_dims(v: torch.Tensor, dims: Tuple[int, ...], *, per_remaining_dim: Optional[int] = None,
                   backend: str = "jnp") -> torch.Tensor:
    """SNR_K for positional reduction dims: a 0-d tensor, or with
    ``per_remaining_dim`` a vector over that kept dim.

    ``backend='fused'`` (or 'auto' on CUDA) computes the per-line ratios of
    both forms through the one-pass centered-stats kernel on the canonical
    view: a single read of V, plus one re-layout copy where K is interleaved
    with kept dims. Unlike the JAX package, every candidate takes the
    kernel: no line is too long and no view is refused for its transpose."""
    if not dims:
        raise ValueError("K must be non-empty for SNR; K=None means 'no compression'")
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


def measure_leaf_snr(v: torch.Tensor, meta: ParamMeta, *, backend: str = "jnp") -> Dict[str, torch.Tensor]:
    """Scalar SNR per candidate K ('fan_in'/'fan_out'/'both') for one tensor."""
    return {label: snr_along_dims(v, meta.dims_of(axes), backend=backend)
            for label, axes in meta.candidate_ks().items()}


def measure_tree_snr(nu: Mapping[str, torch.Tensor], meta: Mapping[str, ParamMeta], *,
                     backend: str = "jnp", from_update: Optional[Mapping[str, Optional[torch.Tensor]]] = None,
                     update_dims: Optional[Mapping[str, Tuple[int, ...]]] = None
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{param_name: {K_label: snr}} over a second-moment dict; vector-like
    leaves give an empty dict (the paper never compresses them).

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
    meta_by_name = dict(flatten_with_names(meta))
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, v in flatten_with_names(nu):
        m = meta_by_name[name]
        if name not in ridden:
            out[name] = measure_leaf_snr(v, m, backend=backend)
            continue
        s_val, s_dims = ridden[name]
        key = sorted(d % v.ndim for d in s_dims)
        out[name] = {label: s_val if sorted(d % v.ndim for d in m.dims_of(axes)) == key
                     else snr_along_dims(v, m.dims_of(axes), backend=backend)
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
