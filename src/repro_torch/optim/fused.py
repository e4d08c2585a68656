"""Fused optimizer backend: Adam/SlimAdam tree updates through the
hand-written kernels (port of ``repro/optim/fused.py``).

Two routes, as in the JAX package:

* the megaplan (default, ``megakernel=True``): every kernel-eligible leaf
  joins a megaplan group (``repro_torch.kernels.megaplan``): one
  ``mega_adam_update`` launch for the dense group and one
  ``mega_slim_update_batched`` launch per slim group, so a whole-tree
  update costs O(groups) launches;
* the per-leaf route (``megakernel=False``, the parity oracle): dense leaves
  run ``adam_precond`` one by one, leaves below ``bucket_min_size`` elements
  share one ``adam_precond`` launch per bucket, compressed leaves run
  ``slim_precond_batched`` on their canonical view.

Leaves no kernel serves (scalars, empty or non-float tensors) take the
per-leaf plain math on both routes. For CPU tensors the kernel wrappers run
their plain twins, so the same routing is testable without a GPU.

In-pass outputs: ``with_health`` publishes a :class:`StepHealth` (per-leaf
non-finite counts and the finite-masked gradient sum of squares) from the
kernels' own passes over g; ``emit_snr`` (slim) publishes each compressed
leaf's from-update SNR from the centered g^2 line sums the slim kernels
emit in the same pass.

A kernel that fails to build or launch raises: there is no silent fallback
to the plain path. Only the fault-injection hook at ``"optim.kernel"``
(:func:`set_kernel_fault_hook`, ``repro_torch.train.faults
.inject_kernel_failure``) degrades a group or leaf to the plain math, and
every degraded leaf is counted (:func:`kernel_degraded_leaves`).

Sharded (``mesh`` + ``spec_leaves``, a ``repro_torch.launch.mesh.Mesh``
that shards something): every rank runs the same dispatch on its local
shards, as the JAX package's ``shard_map`` body does. The moments are this
rank's shards. The gradients come in whole (each rank holds the averaged
gradient; the whole-parameter trainer) and each leaf's plan
(``repro_torch.sharding.shardspec``) cuts g to the shard; or, with
``param_shards=True`` (parameter-shard storage, ``repro_torch.launch
.train``), g comes in as this rank's shards, as JAX's ``shard_map`` with
in/out specs equal to the parameter specs takes it: the plan is made from
the global shape its spec implies, and the updates go back as shards.
Local-regime leaves run the unsharded routes above on their
shards, psum-regime leaves run the partial-stats / finalize kernel pair
around an all-reduce over the ranks owning the reduced dims (the reduced
moment stored as each rank's owner slice where the plan places one), and
interleaved-K leaves run the plain math on their shard. Whole gradients'
updates are gathered back whole, so every rank applies the same step;
health rows and SNR scalars are completed across ranks, so they are equal
on every rank.
The injection hook must raise identically on every rank (it sees the same
labels everywhere): a degraded group runs other collectives than a kernel
group, so a hook that fired on one rank only would desynchronise them.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import injection
from ..kernels import megaplan
from ..kernels.fused_adam import adam_precond, bias_corrections, health_terms
from ..kernels.ops import CanonND, canon_apply, canon_restore, leaf_plan
from ..kernels.ref import rebase_centered_stats, snr_stats_centered_partial_ref
from ..kernels.slim_update import (slim_finalize_batched, slim_partial_stats_batched, slim_precond,
                                   slim_precond_batched, slim_precond_major)
from ..kernels.snr_stats import snr_update_stats_finalize
from ..sharding.shardspec import (dim_shards, global_shape, mesh_is_trivial, plan_sharded_tree,
                                  psum_kernel_eligible, spec_dtype)
from .base import ShardCuts

# 0/0 guard for exactly-constant lines in the from-update SNR (the same
# limit as repro_torch.core.snr._VAR_EPS).
_SNR_EPS = 1e-30

Dims = Tuple[int, ...]

# Leaves below this element count get bucketed on the per-leaf route (one
# kernel call per bucket instead of per leaf).
DEFAULT_BUCKET_MIN = 1 << 14


def _bucket_eligible(size: int, bucket_min_size: int) -> bool:
    """The small-leaf boundary: strictly below the threshold buckets,
    exactly at it runs per leaf."""
    return bool(bucket_min_size) and size < bucket_min_size


class StepHealth(NamedTuple):
    """In-pass gradient health of one tree update.

    ``nonfinite``: (n_leaves,) f32 — per-leaf count of non-finite gradient
    entries. ``grad_sumsq``: () f32 — global sum of squares over the finite
    entries, so the gradient norm stays meaningful on a poisoned step.
    Kernel-served leaves take both from the update kernels' own pass; plain
    leaves from :func:`leaf_health`."""
    nonfinite: torch.Tensor
    grad_sumsq: torch.Tensor

    @property
    def bad(self) -> torch.Tensor:
        """() bool — any non-finite gradient entry anywhere in the tree."""
        return (torch.sum(self.nonfinite) > 0) | ~torch.isfinite(self.grad_sumsq)

    @property
    def grad_norm(self) -> torch.Tensor:
        """() f32 — global norm over the finite gradient entries."""
        return torch.sqrt(self.grad_sumsq)


def leaf_health(g: torch.Tensor) -> torch.Tensor:
    """``[nonfinite_count, finite_masked_sumsq]`` of one leaf (plain)."""
    return health_terms(g)


def _health_from_rows(rows: Sequence[torch.Tensor]) -> StepHealth:
    """Stack per-leaf (2,) health rows into a :class:`StepHealth` (the
    global sum of squares in f64, as the kernels' partials are summed)."""
    h = torch.stack(list(rows))
    return StepHealth(nonfinite=h[:, 0], grad_sumsq=h[:, 1].double().sum().float())


def _segment_health(group, nf: torch.Tensor, ss: torch.Tensor) -> List[torch.Tensor]:
    """Per-segment (2,) rows from a group's per-line health outputs (the
    lane-fold zero padding of the dense group is finite and adds 0)."""
    return [torch.stack([a.double().sum(), b.double().sum()]).float()
            for a, b in zip(megaplan.scatter_lines(group, nf), megaplan.scatter_lines(group, ss))]


# ---------------------------------------------------------------------------
# Kernel degradation (fault injection only)
# ---------------------------------------------------------------------------

_DEGRADED = {"leaves": 0, "warned": False}
KERNEL_FAULT_POINT = "optim.kernel"


def set_kernel_fault_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install a fault-injection hook called (with a group or leaf label)
    before every kernel dispatch — raise from it to simulate a kernel
    failure. ``None`` uninstalls. Registered at the shared
    ``"optim.kernel"`` point (:mod:`repro_torch.injection`)."""
    injection.install(KERNEL_FAULT_POINT, hook)


def kernel_degraded_leaves() -> int:
    """Leaves whose kernel dispatch an injected fault degraded to the plain
    math since the last reset."""
    return _DEGRADED["leaves"]


def reset_kernel_degradation() -> None:
    _DEGRADED["leaves"] = 0
    _DEGRADED["warned"] = False


def _guarded(label: str, kernel_fn: Callable[[], Any], jnp_fn: Callable[[], Any], *, leaves: int = 1):
    """Run ``kernel_fn`` unless the ``"optim.kernel"`` hook raises for
    ``label``; then count ``leaves`` degraded and run ``jnp_fn``. Errors of
    the kernel itself propagate."""
    try:
        injection.fire(KERNEL_FAULT_POINT, label)
    except Exception as e:  # noqa: BLE001 — whatever the injected hook raises degrades
        _DEGRADED["leaves"] += leaves
        if not _DEGRADED["warned"]:
            _DEGRADED["warned"] = True
            warnings.warn(f"kernel dispatch for {label} failed ({type(e).__name__}: {e}); degrading to the "
                          f"plain reference math", stacklevel=2)
        return jnp_fn()
    return kernel_fn()


# ---------------------------------------------------------------------------
# Per-leaf plain math
# ---------------------------------------------------------------------------


def jnp_adam_leaf(g, m, v, *, b1, b2, eps, count):
    """Reference Adam leaf update — the plain per-leaf math (named after the
    JAX function it ports) that the 'jnp' backend and excluded leaves run."""
    g32 = g.float()
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * torch.square(g32)
    bc1, bc2 = bias_corrections(b1, b2, count)
    return (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps), m_new, v_new


def jnp_slim_leaf(g, m, v, dims: Dims, *, b1, b2, eps, count, use_first_moment: bool = True,
                  cuts: ShardCuts = ShardCuts(), key: Optional[str] = None):
    """Reference SlimAdam leaf update: the second moment is the mean of g^2
    over ``dims``, stored with size-1 reduced dims. Without the first moment
    (``m`` None) the numerator is g itself and m' is None.

    ``cuts`` with ``key``: ``g`` is this rank's shard of leaf ``key``
    (parameter-shard storage, JAX's pjit path with ``owner_mesh=None``), and
    the mean over ``dims`` is completed across the mesh axes that cut them;
    ``v`` is this rank's shard of the reduced moment under the masked spec,
    so every other op is the shard's own. Whole leaves by default."""
    g32 = g.float()
    g2 = torch.square(g32)
    ek = cuts.mean(torch.mean(g2, dim=dims, keepdim=True), cuts.axes(key, g.ndim, dims)) if dims else g2
    v_new = b2 * v + (1 - b2) * ek
    bc1, bc2 = bias_corrections(b1, b2, count)
    if use_first_moment:
        m_new = b1 * m + (1 - b1) * g32
        num = m_new / bc1
    else:
        m_new, num = None, g32
    return num / (torch.sqrt(v_new / bc2) + eps), m_new, v_new


def jnp_update_snr_leaf(g, v_new, dims: Dims, *, b2, cuts: ShardCuts = ShardCuts(),
                        key: Optional[str] = None) -> torch.Tensor:
    """Reference from-update SNR for one compressed leaf (0-d): SNR_K of the
    step's dense reconstruction ``b2 * V_red + (1 - b2) * g^2``, whose line
    mean is exactly ``v_new`` — the oracle for the ``with_snr`` kernel
    outputs (:func:`repro_torch.kernels.snr_stats.snr_update_stats_finalize`).
    ``cuts``/``key`` as :func:`jnp_slim_leaf`: the line means and variances
    completed across the axes that cut ``dims``, the mean over lines across
    the axes that cut the others."""
    nd = g.ndim
    across_k = cuts.axes(key, nd, dims)
    across_lines = cuts.axes(key, nd, [d for d in range(nd) if d not in {x % nd for x in dims}])
    g2 = torch.square(g.float())
    ek = cuts.mean(torch.mean(g2, dim=dims, keepdim=True), across_k)
    var = cuts.mean(torch.mean(torch.square(g2 - ek), dim=dims, keepdim=True), across_k)
    return cuts.mean(torch.mean(torch.square(v_new) / ((1 - b2) ** 2 * var + _SNR_EPS)), across_lines)


def tree_health(g_leaves, cuts: ShardCuts = ShardCuts(), names: Optional[Sequence[str]] = None) -> StepHealth:
    """The :class:`StepHealth` of a tree by the plain math (each leaf's row
    from :func:`leaf_health`); where ``cuts`` holds the leaves ``names`` as
    this rank's shards, completed across the mesh."""
    rows = [leaf_health(x) for x in g_leaves]
    if cuts.mesh is None:
        return _health_from_rows(rows)
    specs = [cuts.specs[k] for k in names]
    return _psum_health(rows, [cuts.shape(k, x) for k, x in zip(names, g_leaves)], specs, cuts.mesh)


def _plain_leaf(g, m, v, dims: Dims, *, emit_snr: bool, with_health: bool, b1, b2, eps, count,
                use_first_moment: bool = True):
    """(u, m', v', snr or None, health row or None) by the plain math
    (m' None without the first moment)."""
    kw = dict(b1=b1, b2=b2, eps=eps, count=count)
    if not use_first_moment:
        u, m_new, v_new = jnp_slim_leaf(g, None, v, dims, use_first_moment=False, **kw)
    else:
        u, m_new, v_new = jnp_slim_leaf(g, m, v, dims, **kw) if dims else jnp_adam_leaf(g, m, v, **kw)
    snr = jnp_update_snr_leaf(g, v_new, dims, b2=b2) if emit_snr and dims else None
    return u, m_new, v_new, snr, leaf_health(g) if with_health else None


# ---------------------------------------------------------------------------
# Per-leaf kernel route (megakernel=False)
# ---------------------------------------------------------------------------


def _dense_kernel_leaf(g, m, v, *, with_health: bool, **kw):
    """One dense leaf through ``adam_precond`` on a 2-D view of it (1-D
    leaves as one row: the kernel needs no lane fold or padding)."""
    shape = g.shape
    two = (lambda x: x.reshape(1, -1)) if g.ndim == 1 else (lambda x: x.reshape(-1, shape[-1]))
    outs = adam_precond(two(g).contiguous(), two(m).contiguous(), two(v).contiguous(), with_health=with_health,
                        **kw)
    return (*(o.reshape(shape) for o in outs[:3]), None, outs[3] if with_health else None)


def _slim_kernel_leaf(g, m, v_red, cn: CanonND, *, with_snr: bool, with_health: bool, b2, **kw):
    """One compressed leaf through ``slim_precond_batched`` on its canonical
    view (the 2-D wrappers for a batch-free plan without flags, as the JAX
    dispatch does). With ``with_snr`` the kernel's centered g^2 line sums
    finish into the leaf's from-update SNR; with ``with_health`` its (2,)
    accumulator comes last."""
    g2 = canon_apply(g, cn).contiguous()
    m2 = canon_apply(m, cn).contiguous()
    v2 = canon_apply(v_red, cn, reduced_cols=True).contiguous()
    snr = health = None
    if with_snr or with_health or cn.batch > 1:
        to3 = (lambda x: x) if cn.batch > 1 else (lambda x: x[None])
        un3 = (lambda x: x) if cn.batch > 1 else (lambda x: x[0])
        outs = slim_precond_batched(to3(g2), to3(m2), to3(v2), axis=cn.axis, with_snr=with_snr,
                                    with_health=with_health, b2=b2, **kw)
        u2, m2o, v2o = un3(outs[0]), un3(outs[1]), un3(outs[2])
        if with_snr:
            red = cn.cols if cn.axis == 1 else cn.rows
            snr = snr_update_stats_finalize(outs[2], outs[3], outs[4], red, 1.0 - b2, eps=_SNR_EPS)
        if with_health:
            health = outs[-1]
    else:
        fn = slim_precond if cn.axis == 1 else slim_precond_major
        u2, m2o, v2o = fn(g2, m2, v2, b2=b2, **kw)
    return (canon_restore(u2, cn, g.shape), canon_restore(m2o, cn, g.shape),
            canon_restore(v2o, cn, v_red.shape), snr, health)


def _bucket_update(gs, ms, vs, **kw):
    """Flatten + concatenate small leaves, update as one (1, N) super-tensor
    in one ``adam_precond`` call, and split the results back by offset.
    Dense Adam is elementwise, so the round-trip is exact."""
    flat = lambda xs: torch.cat([x.float().reshape(-1) for x in xs])[None]   # noqa: E731
    outs = adam_precond(flat(gs), flat(ms), flat(vs), **kw)
    sizes = [g.numel() for g in gs]
    return [[piece.reshape(g.shape) for piece, g in zip(o[0].split(sizes), gs)] for o in outs]


def _flush_bucket(bucket, gs, ms, vs, out, *, with_health: bool, **kw):
    """Resolve the collected small-leaf indices in place: a lone leaf skips
    the concat round-trip, two or more share one kernel call. Bucketed
    leaves' health rows come from :func:`leaf_health` (the guard needs
    per-leaf counts, and these leaves are small), as in the JAX package."""
    if len(bucket) == 1:
        i = bucket[0]
        out[i] = _guarded(f"dense:{tuple(gs[i].shape)}",
                          lambda: _dense_kernel_leaf(gs[i], ms[i], vs[i], with_health=with_health, **kw),
                          lambda: _plain_leaf(gs[i], ms[i], vs[i], (), emit_snr=False, with_health=with_health,
                                              **kw))
    elif bucket:
        us, mo, vo = _guarded(f"bucket[{len(bucket)}]",
                              lambda: _bucket_update([gs[i] for i in bucket], [ms[i] for i in bucket],
                                                     [vs[i] for i in bucket], **kw),
                              lambda: tuple(zip(*[jnp_adam_leaf(gs[i], ms[i], vs[i], **kw) for i in bucket])))
        for i, u, m, v in zip(bucket, us, mo, vo):
            out[i] = (u, m, v, None, leaf_health(gs[i]) if with_health else None)


def _tree_local(gs, ms, vs, dims_leaves, *, bucket_min_size: int, emit_snr: bool, with_health: bool, **kw):
    """The per-leaf route: each leaf's dispatch from one :func:`leaf_plan`
    lookup. Returns one (u, m', v', snr, health row) tuple per leaf."""
    out: List[Any] = [None] * len(gs)
    bucket: List[int] = []
    for i, (g, m, v, dims) in enumerate(zip(gs, ms, vs, dims_leaves)):
        dims = tuple(dims)
        plan = leaf_plan(tuple(g.shape), g.dtype, dims)
        plain = lambda g=g, m=m, v=v, dims=dims: _plain_leaf(g, m, v, dims, emit_snr=emit_snr,  # noqa: E731
                                                              with_health=with_health, **kw)
        if plan.route == "jnp":
            out[i] = plain()
        elif plan.route == "dense":
            if _bucket_eligible(g.numel(), bucket_min_size):
                bucket.append(i)
            else:
                out[i] = _guarded(f"dense:{tuple(g.shape)}",
                                  lambda g=g, m=m, v=v: _dense_kernel_leaf(g, m, v, with_health=with_health, **kw),
                                  plain)
        else:
            out[i] = _guarded(f"slim:{tuple(g.shape)}",
                              lambda g=g, m=m, v=v, cn=plan.cn: _slim_kernel_leaf(
                                  g, m, v, cn, with_snr=emit_snr, with_health=with_health, **kw),
                              plain)
    _flush_bucket(bucket, gs, ms, vs, out, with_health=with_health, **kw)
    return out


# ---------------------------------------------------------------------------
# Megaplan route: whole-tree grouped launches
# ---------------------------------------------------------------------------


def _mega_dense_group(group, gs, ms, vs, *, with_health: bool, b1, b2, eps, count):
    """One launch over a dense group's lane-folded super-tensor. Returns
    per-segment lists (u, m', v', health rows) aligned with
    ``group.segments``; the group degrades as a unit."""
    n = len(group.segments)

    def kernel_fn():
        bc1, bc2 = bias_corrections(b1, b2, count)
        outs = megaplan.mega_adam_update(
            megaplan.gather_group(group, gs), megaplan.gather_group(group, ms),
            megaplan.gather_group(group, vs), megaplan.segment_lines(group, [bc1] * n),
            megaplan.segment_lines(group, [bc2] * n), b1=b1, b2=b2, eps=eps, with_health=with_health)
        hs = _segment_health(group, outs[3], outs[4]) if with_health else [None] * n
        return (*(megaplan.scatter_group(group, o) for o in outs[:3]), hs)

    def jnp_fn():
        res = [_plain_leaf(gs[s.index], ms[s.index], vs[s.index], (), emit_snr=False, with_health=with_health,
                           b1=b1, b2=b2, eps=eps, count=count) for s in group.segments]
        return [r[0] for r in res], [r[1] for r in res], [r[2] for r in res], [r[4] for r in res]

    return _guarded(f"mega:dense[{n}]", kernel_fn, jnp_fn, leaves=n)


def _mega_slim_group(group, gs, ms, vs, *, emit_snr: bool, with_health: bool, b1, b2, eps, count):
    """One launch over a slim group's canonical super-tensor. Returns
    per-segment lists (u, m', v_red', snr, health rows)."""
    n = len(group.segments)
    to3 = (lambda x: x) if group.kind == "batched" else (lambda x: x[None])
    un3 = (lambda x: x) if group.kind == "batched" else (lambda x: x[0])

    def kernel_fn():
        bc1, bc2 = bias_corrections(b1, b2, count)
        outs = megaplan.mega_slim_update_batched(
            to3(megaplan.gather_group(group, gs)), to3(megaplan.gather_group(group, ms)),
            to3(megaplan.gather_group(group, vs, reduced=True)),
            to3(megaplan.segment_lines(group, [bc1] * n)), to3(megaplan.segment_lines(group, [bc2] * n)),
            axis=group.axis, b1=b1, b2=b2, eps=eps, with_snr=emit_snr, with_health=with_health)
        snrs: List[Any] = [None] * n
        if emit_snr:
            snrs = [snr_update_stats_finalize(vl, s1, s2, group.red, 1.0 - b2, eps=_SNR_EPS)
                    for vl, s1, s2 in zip(*(megaplan.scatter_lines(group, un3(o)) for o in outs[2:5]))]
        k = 3 if emit_snr else 1
        hs = _segment_health(group, un3(outs[k + 2]), un3(outs[k + 3])) if with_health else [None] * n
        return (megaplan.scatter_group(group, un3(outs[0])), megaplan.scatter_group(group, un3(outs[1])),
                megaplan.scatter_group(group, un3(outs[2]), reduced=True), snrs, hs)

    def jnp_fn():
        res = [_plain_leaf(gs[s.index], ms[s.index], vs[s.index], s.dims, emit_snr=emit_snr,
                           with_health=with_health, b1=b1, b2=b2, eps=eps, count=count) for s in group.segments]
        return tuple([r[j] for r in res] for j in range(5))

    return _guarded(f"mega:{group.kind}[{n}]", kernel_fn, jnp_fn, leaves=n)


def _tree_mega(gs, ms, vs, dims_leaves, *, emit_snr: bool, with_health: bool, **kw):
    """The megaplan route. Returns one (u, m', v', snr, health row) tuple
    per leaf."""
    out: List[Any] = [None] * len(gs)
    plan = megaplan.plan_megagroups([tuple(g.shape) for g in gs], [g.dtype for g in gs],
                                    [tuple(d) for d in dims_leaves])
    for i in plan.jnp_idx:
        out[i] = _plain_leaf(gs[i], ms[i], vs[i], tuple(dims_leaves[i]), emit_snr=emit_snr,
                             with_health=with_health, **kw)
    for group in plan.groups:
        if group.kind == "dense":
            us, mo, vo, hs = _mega_dense_group(group, gs, ms, vs, with_health=with_health, **kw)
            snrs = [None] * len(group.segments)
        else:
            us, mo, vo, snrs, hs = _mega_slim_group(group, gs, ms, vs, emit_snr=emit_snr,
                                                    with_health=with_health, **kw)
        for seg, *leaf in zip(group.segments, us, mo, vo, snrs, hs):
            out[seg.index] = tuple(leaf)
    return out


# ---------------------------------------------------------------------------
# Sharded execution: per-rank dispatch with per-leaf regime plans
# ---------------------------------------------------------------------------


def _use_sharded(mesh, spec_leaves) -> bool:
    """The sharded path engages only with both a mesh and specs, on a mesh
    that shards something."""
    return mesh is not None and spec_leaves is not None and not mesh_is_trivial(mesh)


def sharded_tree_plans(g_leaves, dims_leaves, spec_leaves, mesh, *, param_shards: bool = False):
    """Per-leaf :class:`repro_torch.sharding.shardspec.ShardLeafPlan`s of a
    tree update, for the dispatchers below and for callers that count
    regimes (``shardspec.regime_counts``). ``g_leaves`` have their global
    shapes, or with ``param_shards`` are this rank's shards: the plans are
    then made from the global shapes their specs imply."""
    shapes = [tuple(g.shape) for g in g_leaves]
    if param_shards:
        shapes = [global_shape(sh, s, mesh) for sh, s in zip(shapes, spec_leaves)]
    return plan_sharded_tree(shapes, [spec_dtype(g) for g in g_leaves], [tuple(d) for d in dims_leaves],
                             list(spec_leaves), mesh)


def _owner_scatter(v_slice, owner, mesh):
    """Embed this rank's owner slice of a reduced moment into a zeros
    full-line buffer at its owned offset: the additive ``b2 * v`` term of
    the combined all-reduce payload. Inverse of :func:`_owner_slice`."""
    out = v_slice
    for ax, dim in reversed(owner):
        blk = out.shape[dim]
        full = list(out.shape)
        full[dim] = blk * mesh.shape[ax]
        z = torch.zeros(full, dtype=out.dtype, device=out.device)
        z.narrow(dim, mesh.axis_index(ax) * blk, blk).copy_(out)
        out = z
    return out


def _owner_slice(v_full, owner, mesh):
    """This rank's owner slice of a completed full-line reduced moment."""
    for ax, dim in owner:
        blk = v_full.shape[dim] // mesh.shape[ax]
        v_full = v_full.narrow(dim, mesh.axis_index(ax) * blk, blk)
    return v_full.contiguous()


def _psum_snr(s1c, s2c, first, v_new, pl, mesh, *, n_loc, b2):
    """Complete a psum leaf's from-update SNR across its ranks: rebase each
    shard's centered g^2 sums to a common shift (the mean of the shards'
    shifts), sum them over the psum axes, finalise against the completed
    moment, and average the ratio over the kept-line shards."""
    shift = mesh.pmean(first, pl.psum_axes)
    s1c, s2c = rebase_centered_stats(s1c, s2c, first, shift, n_loc)
    snr = snr_update_stats_finalize(v_new, mesh.psum(s1c, pl.psum_axes), mesh.psum(s2c, pl.psum_axes),
                                    pl.red_total, 1.0 - b2, eps=_SNR_EPS)
    return mesh.pmean(snr, pl.kept_axes) if pl.kept_axes else snr


def _red_local(shape, dims):
    """(reduced-moment shape, reduction extent) of a shard's ``shape``."""
    dset = {d % len(shape) for d in dims}
    return tuple(1 if i in dset else s for i, s in enumerate(shape)), math.prod(shape[i] for i in sorted(dset))


def _complete(part, v32, pl, mesh, b2):
    """Complete a psum leaf's partial line sums of g^2 across its ranks:
    with an owner placement, into v' itself (each rank adds ``b2 * v`` of
    the lines it owns to the payload), else into the line mean ek. Returns
    (v' full-line or None, ek or None)."""
    if pl.owner:
        payload = ((1.0 - b2) / pl.red_total) * part + b2 * _owner_scatter(v32, pl.owner, mesh)
        return mesh.psum(payload, pl.psum_axes), None
    return None, mesh.psum(part, pl.psum_axes) / pl.red_total


def _psum_slim_leaf(g, m, v_red, dims: Dims, *, pl, mesh, emit_snr: bool, with_health: bool, b1, b2, eps, count,
                    use_first_moment: bool = True):
    """One SlimAdam leaf whose reduced dims are split across
    ``pl.psum_axes``: pass 1 (B10, ``slim_partial_stats_batched``) writes m'
    and the shard's partial line sums of g^2; an all-reduce over the owning
    axes completes them; pass 2 (B11, ``slim_finalize_batched``) writes u.
    With an owner placement each rank folds ``b2 * v`` for the lines it owns
    into the payload, so the all-reduce delivers the completed v' to every
    rank while each stores only its owner slice. ``emit_snr`` appends the
    completed from-update SNR; ``with_health`` the shard's local (2,) row,
    which the caller completes across ranks. Moments are computed in f32 and
    cast back to their stored dtypes. Returns (u, m', v', snr, health).
    Without the first moment (``m`` None) the numerator is g and only the
    plain form runs, as in the JAX package: the kernels stream an m."""
    m_dtype, v_dtype = (m.dtype if m is not None else None), v_red.dtype
    v32 = v_red.float()
    red_shape, n_loc = _red_local(g.shape, dims)

    def kernel_branch():
        cn = pl.cn
        to3 = (lambda x: x) if cn.batch > 1 else (lambda x: x[None])
        un3 = (lambda x: x) if cn.batch > 1 else (lambda x: x[0])
        view = lambda x, **kw: to3(canon_apply(x, cn, **kw)).contiguous()   # noqa: E731
        g_in = g if g.dtype in (torch.float32, torch.bfloat16) else g.float()
        outs = slim_partial_stats_batched(view(g_in), view(m.float()), axis=cn.axis, b1=b1, with_snr=emit_snr,
                                          with_health=with_health)
        m_new2 = outs[0]
        v_new, ek = _complete(canon_restore(un3(outs[1]), cn, red_shape), v32, pl, mesh, b2)
        kw = dict(axis=cn.axis, b1=b1, b2=b2, eps=eps, count=count)
        if pl.owner:
            u2 = slim_finalize_batched(m_new2, view(v_new, reduced_cols=True), **kw)
            v_out = _owner_slice(v_new, pl.owner, mesh)
        else:
            u2, v_new2 = slim_finalize_batched(m_new2, view(v32, reduced_cols=True),
                                               ek=view(ek, reduced_cols=True), **kw)
            v_new = v_out = canon_restore(un3(v_new2), cn, red_shape)
        snr = None
        if emit_snr:
            s1c, s2c, first = (canon_restore(un3(o), cn, red_shape) for o in outs[2:5])
            snr = _psum_snr(s1c, s2c, first, v_new, pl, mesh, n_loc=n_loc, b2=b2)
        return (canon_restore(un3(u2), cn, g.shape), canon_restore(un3(m_new2), cn, g.shape).to(m_dtype),
                v_out.to(v_dtype), snr, outs[-1] if with_health else None)

    def jnp_branch():
        # a local plan the kernel pair cannot serve ('psum_jnp'), or a
        # degraded leaf: the same cross-rank algebra in plain math.
        g32 = g.float()
        red = sorted({d % g.ndim for d in dims})
        v_new, ek = _complete(torch.sum(g32 * g32, dim=red, keepdim=True), v32, pl, mesh, b2)
        if pl.owner:
            v_out = _owner_slice(v_new, pl.owner, mesh)
        else:
            v_new = v_out = b2 * v32 + (1 - b2) * ek
        bc1, bc2 = bias_corrections(b1, b2, count)
        m_new = b1 * m.float() + (1 - b1) * g32 if use_first_moment else None
        num = m_new / bc1 if use_first_moment else g32
        u = num / (torch.sqrt(v_new / bc2) + eps)
        snr = None
        if emit_snr:
            _, s1c, s2c, first = snr_stats_centered_partial_ref(g32 * g32, tuple(red))
            snr = _psum_snr(s1c, s2c, first, v_new, pl, mesh, n_loc=n_loc, b2=b2)
        return (u, m_new.to(m_dtype) if use_first_moment else None, v_out.to(v_dtype), snr,
                leaf_health(g32) if with_health else None)

    if psum_kernel_eligible(pl, use_first_moment):
        return _guarded(f"psum:{tuple(g.shape)}", kernel_branch, jnp_branch)
    return jnp_branch()


def _psum_mega_group(group, form: str, plans, gs, ms, vs, *, mesh, emit_snr: bool, with_health: bool, b1, b2, eps,
                     count) -> Dict[int, tuple]:
    """One partial-stats launch (B12) and one finalize launch (B13) over a
    grouped psum super-tensor; each leaf's cross-rank algebra (all-reduce
    over its own psum axes, owner scatter / slice) runs between the two on
    its O(kept) lines, exactly as :func:`_psum_slim_leaf` does per leaf.
    ``form`` is 'owner' or 'plain' (the finalize forms differ, so the caller
    partitions first). Returns ``{leaf index: (u, m', v', snr, health)}``."""
    n = len(group.segments)
    to3 = (lambda x: x) if group.kind == "batched" else (lambda x: x[None])
    un3 = (lambda x: x) if group.kind == "batched" else (lambda x: x[0])
    cat = lambda lines: to3(torch.cat(lines, dim=group.concat_axis)).contiguous()   # noqa: E731

    outs = megaplan.mega_slim_partial_stats_batched(
        to3(megaplan.gather_group(group, gs)), to3(megaplan.gather_group(group, ms)), axis=group.axis, b1=b1,
        with_snr=emit_snr, with_health=with_health)
    parts = megaplan.scatter_group(group, un3(outs[1]), reduced=True)
    v_lines, ek_lines, v_news = [], [], []
    v_outs: List[Any] = [None] * n
    for j, seg in enumerate(group.segments):
        pl = plans[seg.index]
        v32 = vs[seg.index].float()
        v_new, ek = _complete(parts[j], v32, pl, mesh, b2)
        if form == "owner":
            v_lines.append(canon_apply(v_new, seg.cn, reduced_cols=True))
            v_outs[j] = _owner_slice(v_new, pl.owner, mesh).to(vs[seg.index].dtype)
        else:
            v_lines.append(canon_apply(v32, seg.cn, reduced_cols=True))
            ek_lines.append(canon_apply(ek, seg.cn, reduced_cols=True))
            # the finalize kernel's elementwise form, kept full-line for the SNR
            v_new = b2 * v32 + (1 - b2) * ek
        v_news.append(v_new)

    bc1, bc2 = bias_corrections(b1, b2, count)
    l1 = to3(megaplan.segment_lines(group, [bc1] * n)).contiguous()
    l2 = to3(megaplan.segment_lines(group, [bc2] * n)).contiguous()
    if form == "owner":
        u_cat = megaplan.mega_slim_finalize_batched(outs[0], cat(v_lines), l1, l2, axis=group.axis, b2=b2, eps=eps)
    else:
        u_cat, v_new_cat = megaplan.mega_slim_finalize_batched(outs[0], cat(v_lines), l1, l2, axis=group.axis,
                                                               ek=cat(ek_lines), b2=b2, eps=eps)
        for j, (seg, v_red) in enumerate(zip(group.segments,
                                             megaplan.scatter_group(group, un3(v_new_cat), reduced=True))):
            v_outs[j] = v_red.to(vs[seg.index].dtype)
    us = megaplan.scatter_group(group, un3(u_cat))
    m_news = megaplan.scatter_group(group, un3(outs[0]))

    snrs: List[Any] = [None] * n
    if emit_snr:
        s1s, s2s, firsts = (megaplan.scatter_group(group, un3(o), reduced=True) for o in outs[2:5])
        for j, seg in enumerate(group.segments):
            snrs[j] = _psum_snr(s1s[j], s2s[j], firsts[j], v_news[j], plans[seg.index], mesh,
                                n_loc=_red_local(seg.shape, seg.dims)[1], b2=b2)
    k = 5 if emit_snr else 2
    hs = _segment_health(group, un3(outs[k]), un3(outs[k + 1])) if with_health else [None] * n
    return {seg.index: (us[j], m_news[j].to(ms[seg.index].dtype), v_outs[j], snrs[j], hs[j])
            for j, seg in enumerate(group.segments)}


def _psum_mega_leaves(idx, plans, gs, ms, vs, dims_leaves, *, mesh, **kw) -> Dict[int, tuple]:
    """Group the kernel-eligible psum leaves ``idx`` and run each group
    through :func:`_psum_mega_group`. Owner-slice and plain leaves partition
    first (their finalize forms differ); within a form, differing psum axes
    do not split a group, since each leaf's all-reduce stays its own. A
    degraded group runs its leaves through :func:`_psum_slim_leaf`."""
    items = {"owner": [], "plain": []}
    for i in idx:
        shape = tuple(gs[i].shape)
        items["owner" if plans[i].owner else "plain"].append((i, shape, _red_local(shape, dims_leaves[i])[0],
                                                              tuple(dims_leaves[i]), plans[i].cn))
    out: Dict[int, tuple] = {}
    for form in ("owner", "plain"):
        for group in megaplan.groups_from_plans(items[form]):
            def per_leaf(group=group):
                return {seg.index: _psum_slim_leaf(gs[seg.index], ms[seg.index], vs[seg.index], seg.dims,
                                                   pl=plans[seg.index], mesh=mesh, **kw)
                        for seg in group.segments}

            out.update(_guarded(f"mega:psum:{group.kind}[{len(group.segments)}]",
                                lambda group=group, form=form: _psum_mega_group(group, form, plans, gs, ms, vs,
                                                                                 mesh=mesh, **kw),
                                per_leaf, leaves=len(group.segments)))
    return out


def _psum_health(rows, shapes, specs, mesh) -> StepHealth:
    """Complete per-shard health rows across the mesh: divide each leaf's
    row by the number of ranks that hold a replica of its shard (from its
    global shape), then one (n, 2) all-reduce over every axis gives the
    exact global totals."""
    total = mesh.size
    repl = torch.tensor([total / math.prod(dim_shards(sh, s, mesh)) for sh, s in zip(shapes, specs)],
                        dtype=torch.float32)
    h = torch.stack(list(rows))
    h = mesh.psum(h / repl.to(h.device)[:, None], tuple(mesh.shape))
    return StepHealth(nonfinite=h[:, 0], grad_sumsq=h[:, 1].double().sum().float())


def _shard_inputs(g_leaves, plans, mesh, param_shards: bool):
    """(this rank's g shards, the global shapes) of a sharded tree update."""
    shapes = [global_shape(pl.local_shape, pl.spec, mesh) for pl in plans]
    if param_shards:
        return list(g_leaves), shapes
    return [mesh.shard(g, pl.spec) for g, pl in zip(g_leaves, plans)], shapes


def _sharded_adam_tree(g_leaves, mu_leaves, nu_leaves, spec_leaves, mesh, *, with_health: bool,
                       param_shards: bool = False, **kw):
    """Dense Adam on a mesh: elementwise math never crosses ranks, so each
    rank runs the unsharded route on its shards; the updates are gathered
    whole (shards with ``param_shards``) and the health rows completed
    across ranks."""
    plans = sharded_tree_plans(g_leaves, [()] * len(g_leaves), spec_leaves, mesh, param_shards=param_shards)
    specs = [pl.spec for pl in plans]
    local, shapes = _shard_inputs(g_leaves, plans, mesh, param_shards)
    u, m, v, _, h = _tree(local, mu_leaves, nu_leaves, [()] * len(local), emit_snr=False, with_health=with_health,
                          **kw)
    if not param_shards:
        u = [mesh.gather(x, s) for x, s in zip(u, specs)]
    return (u, m, v) + ((_psum_health(h, shapes, specs, mesh),) if with_health else ())


def _sharded_slim_tree(g_leaves, mu_leaves, nu_leaves, dims_leaves, spec_leaves, mesh, *, emit_snr: bool,
                       with_health: bool, megakernel: bool, bucket_min_size: int, use_first_moment: bool = True,
                       param_shards: bool = False, **kw):
    """SlimAdam on a mesh, three regimes per leaf: 'local' leaves run the
    unsharded routes on their shards; kernel-eligible 'psum' leaves run the
    grouped partial-stats / finalize pair (per leaf with
    ``megakernel=False``) around their all-reduces; the rest run the plain
    math on their shard. SNR scalars of leaves whose lines are sharded over
    kept axes average across those ranks. Without the first moment
    (``mu_leaves`` None) every leaf runs the plain math, local leaves per
    leaf on their shard and psum leaves in the plain psum form, as the JAX
    package routes it (``repro/optim/fused.py:925-1020``). The updates go
    back whole, or as shards with ``param_shards``."""
    plans = sharded_tree_plans(g_leaves, dims_leaves, spec_leaves, mesh, param_shards=param_shards)
    n = len(g_leaves)
    gs, shapes = _shard_inputs(g_leaves, plans, mesh, param_shards)
    ms, vs = (list(mu_leaves) if use_first_moment else [None] * n), list(nu_leaves)
    dims_leaves = [tuple(d) for d in dims_leaves]
    leaf_kw = dict(emit_snr=emit_snr, with_health=with_health, **kw)
    out: List[Any] = [None] * n
    if megakernel and use_first_moment:
        elig = [i for i, pl in enumerate(plans) if pl.regime == "psum" and psum_kernel_eligible(pl)]
        if elig:
            for i, res in _psum_mega_leaves(elig, plans, gs, ms, vs, dims_leaves, mesh=mesh, **leaf_kw).items():
                out[i] = res
    local_idx = [i for i, pl in enumerate(plans) if pl.regime == "local"]
    if not use_first_moment:
        local_idx = []
        leaf_kw["use_first_moment"] = False
    if local_idx:
        res = _tree([gs[i] for i in local_idx], [ms[i] for i in local_idx], [vs[i] for i in local_idx],
                    [dims_leaves[i] for i in local_idx], megakernel=megakernel, bucket_min_size=bucket_min_size,
                    **leaf_kw)
        for j, i in enumerate(local_idx):
            out[i] = tuple(r[j] for r in res)
    for i, pl in enumerate(plans):
        if out[i] is not None:
            continue
        if pl.regime == "psum":
            out[i] = _psum_slim_leaf(gs[i], ms[i], vs[i], dims_leaves[i], pl=pl, mesh=mesh, **leaf_kw)
        else:   # 'jnp' (and 'local' without the first moment): plain math on the shard
            out[i] = _plain_leaf(gs[i], ms[i], vs[i], dims_leaves[i], **leaf_kw)
    for i, pl in enumerate(plans):
        if emit_snr and pl.regime != "psum" and out[i][3] is not None and pl.kept_axes:
            # each rank holds an equal share of the kept lines: the global
            # ratio mean is the mean of the per-rank means
            out[i] = out[i][:3] + (mesh.pmean(out[i][3], pl.kept_axes), out[i][4])
    u = [o[0] if param_shards else mesh.gather(o[0], pl.spec) for o, pl in zip(out, plans)]
    res = (u, [o[1] for o in out], [o[2] for o in out])
    if emit_snr:
        res = res + ([o[3] for o in out],)
    if with_health:
        res = res + (_psum_health([o[4] for o in out], shapes, [pl.spec for pl in plans], mesh),)
    return res


def init_sharded_moments(params, dims_leaves, spec_leaves, mesh, *, reduced: bool, use_first_moment: bool = True,
                         param_shards: bool = False):
    """This rank's zero moments of a sharded tree update: ``(mu, nu)``
    shards shaped by each leaf's plan — mu by the parameter's spec, nu by
    the plan's storage spec (the owner slice of a psum leaf, the masked
    spec otherwise); ``reduced=False`` (Adam) keeps nu full-shape like mu;
    without the first moment mu is None. ``params`` are whole, or this
    rank's shards with ``param_shards``."""
    from ..sharding.shardspec import local_shape

    plans = sharded_tree_plans(params, dims_leaves, spec_leaves, mesh, param_shards=param_shards)
    mu, nu = [], []
    for p, d, pl in zip(params, dims_leaves, plans):
        if use_first_moment:
            mu.append(torch.zeros(pl.local_shape, dtype=torch.float32, device=p.device))
        if not reduced:
            nu.append(torch.zeros(pl.local_shape, dtype=torch.float32, device=p.device))
            continue
        spec = pl.nu_spec if pl.nu_spec is not None else pl.red_spec
        shape = global_shape(pl.local_shape, pl.spec, mesh)
        nu.append(torch.zeros(local_shape(_red_local(shape, d)[0], spec, mesh), dtype=torch.float32,
                              device=p.device))
    return (mu if use_first_moment else None), nu


# ---------------------------------------------------------------------------
# Tree-level entry points
# ---------------------------------------------------------------------------


def _check_unsharded(param_shards: bool) -> None:
    if param_shards:
        raise ValueError("param_shards=True needs a mesh that shards something and the parameter specs")


def _tree(gs, ms, vs, dims_leaves, *, megakernel: bool, bucket_min_size: int, **kw):
    """(updates, new_mu, new_nu, snr list, health rows) as per-leaf lists."""
    if megakernel:
        out = _tree_mega(gs, ms, vs, dims_leaves, **kw)
    else:
        out = _tree_local(gs, ms, vs, dims_leaves, bucket_min_size=bucket_min_size, **kw)
    return tuple([leaf[j] for leaf in out] for j in range(5))


def adam_tree_update(g_leaves: Sequence[torch.Tensor], mu_leaves: Sequence[torch.Tensor],
                     nu_leaves: Sequence[torch.Tensor], *, b1: float, b2: float, eps: float, count: torch.Tensor,
                     bucket_min_size: int = DEFAULT_BUCKET_MIN, mesh=None, spec_leaves=None,
                     with_health: bool = False, megakernel: bool = True, param_shards: bool = False):
    """Dense Adam over a leaf list: by default one ``mega_adam_update``
    launch for every kernel-eligible leaf, plain math for the rest;
    ``megakernel=False`` runs the per-leaf route (small leaves bucketed).
    Returns (updates, new_mu, new_nu) as lists aligned with the input, and
    with ``with_health`` a :class:`StepHealth` last.

    With ``mesh`` + ``spec_leaves`` (one PartitionSpec per leaf) the update
    runs sharded (see the module docstring): g whole, the moments and the
    returned moments this rank's shards, the updates whole; with
    ``param_shards`` g and the updates this rank's shards."""
    if _use_sharded(mesh, spec_leaves) and len(g_leaves):
        return _sharded_adam_tree(g_leaves, mu_leaves, nu_leaves, spec_leaves, mesh, megakernel=megakernel,
                                  bucket_min_size=bucket_min_size, with_health=with_health, b1=b1, b2=b2, eps=eps,
                                  count=count, param_shards=param_shards)
    _check_unsharded(param_shards)
    u, m, v, _, h = _tree(g_leaves, mu_leaves, nu_leaves, [()] * len(g_leaves), megakernel=megakernel,
                          bucket_min_size=bucket_min_size, emit_snr=False, with_health=with_health,
                          b1=b1, b2=b2, eps=eps, count=count)
    return (u, m, v) + ((_health_from_rows(h),) if with_health else ())


def slim_tree_update(g_leaves: Sequence[torch.Tensor], mu_leaves: Sequence[torch.Tensor],
                     nu_leaves: Sequence[torch.Tensor], dims_leaves: Sequence[Dims], *,
                     b1: float, b2: float, eps: float, count: torch.Tensor,
                     bucket_min_size: int = DEFAULT_BUCKET_MIN, mesh=None, spec_leaves=None,
                     emit_snr: bool = False, with_health: bool = False, megakernel: bool = True,
                     use_first_moment: bool = True, param_shards: bool = False):
    """SlimAdam over a leaf list with per-leaf reduction dims: K = () leaves
    take the dense route, K != () leaves the slim kernel their canonical
    plan names (one launch per megaplan group by default; per leaf with
    ``megakernel=False``). Returns (updates, new_mu, new_nu), then with
    ``emit_snr`` a per-leaf list of from-update SNR scalars (None for
    K = () leaves), then with ``with_health`` a :class:`StepHealth`.

    With ``mesh`` + ``spec_leaves`` the update runs sharded with per-leaf
    regime plans (see the module docstring): g whole, the moments and the
    returned moments this rank's shards (the reduced moment of a psum leaf
    its owner slice), the updates whole, SNR and health equal on every
    rank; with ``param_shards`` g and the updates this rank's shards.
    ``use_first_moment=False`` (``mu_leaves`` None) is served on the mesh
    only, by the plain math; unsharded callers run it per leaf."""
    if _use_sharded(mesh, spec_leaves) and len(g_leaves):
        return _sharded_slim_tree(g_leaves, mu_leaves, nu_leaves, dims_leaves, spec_leaves, mesh,
                                  emit_snr=emit_snr, with_health=with_health, megakernel=megakernel,
                                  bucket_min_size=bucket_min_size, use_first_moment=use_first_moment,
                                  param_shards=param_shards, b1=b1, b2=b2, eps=eps, count=count)
    _check_unsharded(param_shards)
    if not use_first_moment:
        raise ValueError("slim_tree_update: use_first_moment=False runs on a mesh only; unsharded, run the "
                         "plain per-leaf math")
    u, m, v, s, h = _tree(g_leaves, mu_leaves, nu_leaves, dims_leaves, megakernel=megakernel,
                          bucket_min_size=bucket_min_size, emit_snr=emit_snr, with_health=with_health,
                          b1=b1, b2=b2, eps=eps, count=count)
    return (u, m, v) + ((s,) if emit_snr else ()) + ((_health_from_rows(h),) if with_health else ())
