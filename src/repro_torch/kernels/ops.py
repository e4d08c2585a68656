"""Canonical layouts and the per-leaf dispatch plan (port of the shape logic
in ``repro/kernels/ops.py``), plus ``snr_op`` and ``snr_partial_op`` and the
parameter-writing entry points ``fused_adam_op``, ``slim_update_op`` and
``slim_update_nd`` (``ops.py:272-335``).

The slim and SNR kernels work on one batched canonical form ``(B, R, C)``
with the reduction along C (``axis=1``, minor: rows are lines) or along R
(``axis=0``, major: columns are lines). :func:`canon_nd` maps any leaf shape
and reduction-dims subset onto that form by a pure reshape whenever memory
order allows (trailing K -> minor, leading K -> major, kept/K/kept ->
batched major); only a genuinely interleaved K transposes.

:func:`leaf_plan` consults the port's fit gate, ``tiling.strip_fits``, where
the JAX one consults the TPU's VMEM gate (``repro/kernels/tiling.py``). The
CUDA kernels hold no reduction line on chip, so the port's gate admits
every line: a leaf whose line outruns VMEM, which JAX sends to plain jnp,
goes to the slim kernel here. Routes may differ from the reference there,
results may not (``tests/test_torch_analysis.py`` lists those leaves).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .ref import snr_from_centered_stats
from .snr_stats import snr_stats_centered_batched, snr_stats_centered_partial_batched
from .tiling import strip_fits


class CanonND(NamedTuple):
    """Plan for the batched ``(B, R, C)`` view of an n-D reduction."""

    perm: Tuple[int, ...]       # permutation applied before the reshape
    inv: Tuple[int, ...]        # inverse permutation
    batch: int                  # kept-prefix batch extent (1 = plain 2-D)
    rows: int
    cols: int
    axis: int                   # per-batch reduction axis: 1 minor | 0 major
    reshape_only: bool


def canon_nd(shape: Tuple[int, ...], dims: Tuple[int, ...]) -> CanonND:
    """Plan a batched canonical view of ``shape`` for reduction dims ``dims``
    (any non-empty subset of axes), preferring a transpose-free plan."""
    ndim = len(shape)
    if not dims:
        raise ValueError("canon_nd needs a non-empty reduction dim set")
    for d in dims:
        if not -ndim <= d < ndim:
            raise ValueError(f"reduction dim {d} out of range for shape {shape}")
    dset = {d % ndim for d in dims}
    if len(dset) != len(dims):
        raise ValueError(f"duplicate reduction dims in {dims} for shape {shape}")
    red = tuple(sorted(dset))
    kept = tuple(i for i in range(ndim) if i not in dset)
    red_size = math.prod(shape[i] for i in red)
    kept_size = math.prod(shape[i] for i in kept)

    # Size-1 axes never change memory order, so only the relative order of
    # the non-trivial reduced and kept axes decides reachability.
    nt_red = [i for i in red if shape[i] > 1]
    nt_kept = [i for i in kept if shape[i] > 1]
    minor_ok = not nt_red or not nt_kept or max(nt_kept) < min(nt_red)
    major_ok = not nt_red or not nt_kept or max(nt_red) < min(nt_kept)

    def plan(perm, batch, rows, cols, axis, reshape_only):
        inv = [0] * ndim
        for newpos, old in enumerate(perm):
            inv[old] = newpos
        return CanonND(tuple(perm), tuple(inv), batch, rows, cols, axis, reshape_only)

    if minor_ok:
        return plan(kept + red, 1, kept_size, red_size, 1, True)
    if major_ok:
        return plan(red + kept, 1, red_size, kept_size, 0, True)
    lo, hi = min(nt_red), max(nt_red)
    if all(k < lo or k > hi for k in nt_kept):
        # kept prefix / reduced block / kept suffix: the prefix becomes the
        # batch dim and each slice is a transpose-free major problem.
        return plan(tuple(range(ndim)), math.prod(shape[:lo]), math.prod(shape[lo:hi + 1]),
                    math.prod(shape[hi + 1:]), 0, True)
    return plan(kept + red, 1, kept_size, red_size, 1, False)


def canon_apply(x: torch.Tensor, cn: CanonND, *, reduced_cols: bool = False) -> torch.Tensor:
    """Bring a full tensor (or, with ``reduced_cols``, a reduced moment with
    size-1 reduced dims) into the canonical layout."""
    if cn.batch > 1:
        return x.reshape((cn.batch, 1, cn.cols) if reduced_cols else (cn.batch, cn.rows, cn.cols))
    if reduced_cols:
        target = (cn.rows, 1) if cn.axis == 1 else (1, cn.cols)
    else:
        target = (cn.rows, cn.cols)
    if cn.reshape_only:
        return x.reshape(target)
    return x.permute(cn.perm).reshape(target)


def canon_restore(y2: torch.Tensor, cn: CanonND, shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`canon_apply` back to ``shape``. ``reshape`` copies
    where a slice of a super-tensor is not contiguous (major and batched
    groups slice a non-leading axis); dense and minor slices stay views."""
    if cn.reshape_only:
        return y2.reshape(shape)
    permuted = tuple(shape[i] for i in cn.perm)
    return y2.reshape(permuted).permute(cn.inv)


class LeafPlan(NamedTuple):
    """Per-leaf dispatch: 'dense' (K = ()), 'slim' (``cn`` set) or 'jnp'
    (the plain per-leaf path: scalar, empty or non-float leaves)."""

    route: str
    cn: Optional[CanonND]


def leaf_plan(shape: Tuple[int, ...], dtype: torch.dtype, dims: Tuple[int, ...], *,
              allow_transpose: bool = True) -> LeafPlan:
    """Plan one leaf's kernel dispatch: plan, fit gate, route, as the JAX
    ``leaf_plan``. ``allow_transpose=False`` routes a genuinely interleaved
    K (a plan that would transpose) to the plain path, as the sharded
    planner asks (``repro_torch.sharding.shardspec``)."""
    if not (len(shape) >= 1 and math.prod(shape) > 0 and dtype.is_floating_point):
        return LeafPlan("jnp", None)
    dims = tuple(dims)
    if not dims:
        return LeafPlan("dense", None)
    cn = canon_nd(tuple(shape), dims)
    if not strip_fits(cn.cols if cn.axis == 1 else cn.rows):
        return LeafPlan("jnp", None)
    if not cn.reshape_only and not allow_transpose:
        return LeafPlan("jnp", None)
    return LeafPlan("slim", cn)


def snr_op(v: torch.Tensor, *, axis: int = 1) -> torch.Tensor:
    """Per-line mean^2 / var over a canonical moment view (2-D, or batched
    3-D) via the centered-stats kernel, shaped (B, kept); their mean is the
    scalar SNR. ``axis`` is the per-batch reduction axis."""
    n = v.shape[-1] if axis == 1 else v.shape[-2]
    v3 = v if v.ndim == 3 else v[None]
    s1, s1c, s2c = snr_stats_centered_batched(v3, axis=axis)
    return snr_from_centered_stats(s1, s1c, s2c, n)


def snr_partial_op(v: torch.Tensor, *, axis: int = 1):
    """Per-line partial centered stats of a canonical moment view (2-D, or
    batched 3-D), each flattened to 1-D: (line_sum, shifted_line_sum,
    shifted_line_sumsq, line_first) via the partial-sums kernel (B9). The
    sharded SNR building block: each rank runs it on its shard of a line,
    rebases to a mesh-common shift and sums across the owning ranks."""
    v3 = v if v.ndim == 3 else v[None]
    return tuple(o.reshape(-1) for o in snr_stats_centered_partial_batched(v3, axis=axis))


# ---------------------------------------------------------------------------
# Parameter-writing entry points (B6, B7)
# ---------------------------------------------------------------------------
# fused_adam and slim_update import megaplan, which imports this module, so
# they are imported where they are called.


def fused_adam_op(p, g, m, v, *, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.0, count=1):
    """AdamW that writes the parameters, for a leaf of any shape (viewed 2-D
    as ``(-1, last)``, as the JAX op does): (p', m', v') through B6."""
    from .fused_adam import fused_adam

    shape = p.shape
    p2 = p.reshape(-1, shape[-1]) if p.ndim != 2 else p
    outs = fused_adam(p2, g.reshape(p2.shape), m.reshape(p2.shape), v.reshape(p2.shape), lr=lr, b1=b1, b2=b2,
                      eps=eps, wd=wd, count=count)
    return tuple(o.reshape(shape) for o in outs)


def slim_update_op(p, g, m, v_red, *, axis: int, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.0, count=1):
    """2-D parameters; ``axis`` is the compressed (reduced) dim, and v_red
    keeps it as size 1 (the SlimAdam state layout). axis 0 runs the major
    (column-line) form of B7, axis 1 the minor one; neither transposes."""
    from .slim_update import slim_update, slim_update_major

    if p.ndim != 2 or axis not in (0, 1):
        raise ValueError(f"slim_update_op: want a 2-D leaf and axis 0|1, got {tuple(p.shape)}, axis {axis}")
    fn = slim_update_major if axis == 0 else slim_update
    return fn(p, g, m, v_red, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, count=count)


def slim_update_nd(p, g, m, v_red, *, dims: Tuple[int, ...], lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.0, count=1):
    """n-D parameters, any reduction-dims subset (the general SlimAdam
    spec); ``v_red`` keeps the reduced axes as size 1. :func:`leaf_plan`
    picks the batched (B, R, C) view (reshape-only where memory order
    allows, the batched-major form for scan-stacked leaves) and B7 runs on
    it; the layout is restored after. Leaves the plan declines (scalar,
    empty or non-float leaves, and K = ()) take the JAX package's own
    semantics in plain torch, as its ``slim_update_nd`` does: that is the
    route for those leaves, not a fallback on failure."""
    from .fused_adam import host_bias_corrections, param_step
    from .slim_update import slim_update_batched

    dims = tuple(dims)
    plan = leaf_plan(tuple(p.shape), p.dtype, dims)
    if plan.route != "slim":
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        ek = torch.mean(torch.square(g32), dim=dims, keepdim=True) if dims else torch.square(g32)
        v_new = b2 * v_red + (1 - b2) * ek
        bc1, bc2 = host_bias_corrections(b1, b2, count)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        return param_step(p, update, lr=lr, wd=wd), m_new, v_new
    cn = plan.cn
    p3, g3, m3 = (canon_apply(t, cn).contiguous() for t in (p, g, m))
    v3 = canon_apply(v_red, cn, reduced_cols=True).contiguous()
    if p3.ndim == 2:
        p3, g3, m3, v3 = p3[None], g3[None], m3[None], v3[None]
    po, mo, vo = slim_update_batched(p3, g3, m3, v3, axis=cn.axis, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd,
                                     count=count)
    if cn.batch == 1:
        po, mo, vo = po[0], mo[0], vo[0]
    return (canon_restore(po, cn, p.shape), canon_restore(mo, cn, m.shape), canon_restore(vo, cn, v_red.shape))
