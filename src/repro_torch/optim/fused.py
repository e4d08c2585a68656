"""Fused optimizer backend: Adam/SlimAdam tree updates through the
hand-written kernels (port of the unsharded paths of
``repro/optim/fused.py``).

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

The sharded paths are not ported yet.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import injection
from ..kernels import megaplan
from ..kernels.fused_adam import adam_precond, bias_corrections, health_terms
from ..kernels.ops import CanonND, canon_apply, canon_restore, leaf_plan
from ..kernels.slim_update import slim_precond, slim_precond_batched, slim_precond_major
from ..kernels.snr_stats import snr_update_stats_finalize

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


def jnp_slim_leaf(g, m, v, dims: Dims, *, b1, b2, eps, count):
    """Reference SlimAdam leaf update (first moment kept): the second moment
    is the mean of g^2 over ``dims``, stored with size-1 reduced dims."""
    g32 = g.float()
    g2 = torch.square(g32)
    ek = torch.mean(g2, dim=dims, keepdim=True) if dims else g2
    v_new = b2 * v + (1 - b2) * ek
    bc1, bc2 = bias_corrections(b1, b2, count)
    m_new = b1 * m + (1 - b1) * g32
    return (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps), m_new, v_new


def jnp_update_snr_leaf(g, v_new, dims: Dims, *, b2) -> torch.Tensor:
    """Reference from-update SNR for one compressed leaf (0-d): SNR_K of the
    step's dense reconstruction ``b2 * V_red + (1 - b2) * g^2``, whose line
    mean is exactly ``v_new`` — the oracle for the ``with_snr`` kernel
    outputs (:func:`repro_torch.kernels.snr_stats.snr_update_stats_finalize`)."""
    g2 = torch.square(g.float())
    var = torch.var(g2, dim=dims, keepdim=True, correction=0)
    return torch.mean(torch.square(v_new) / ((1 - b2) ** 2 * var + _SNR_EPS))


def _plain_leaf(g, m, v, dims: Dims, *, emit_snr: bool, with_health: bool, b1, b2, eps, count):
    """(u, m', v', snr or None, health row or None) by the plain math."""
    kw = dict(b1=b1, b2=b2, eps=eps, count=count)
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
# Tree-level entry points
# ---------------------------------------------------------------------------


def _tree(gs, ms, vs, dims_leaves, *, megakernel: bool, bucket_min_size: int, **kw):
    """(updates, new_mu, new_nu, snr list, health rows) as per-leaf lists."""
    if megakernel:
        out = _tree_mega(gs, ms, vs, dims_leaves, **kw)
    else:
        out = _tree_local(gs, ms, vs, dims_leaves, bucket_min_size=bucket_min_size, **kw)
    return tuple([leaf[j] for leaf in out] for j in range(5))


def adam_tree_update(g_leaves: Sequence[torch.Tensor], mu_leaves: Sequence[torch.Tensor],
                     nu_leaves: Sequence[torch.Tensor], *, b1: float, b2: float, eps: float, count: torch.Tensor,
                     bucket_min_size: int = DEFAULT_BUCKET_MIN, with_health: bool = False,
                     megakernel: bool = True):
    """Dense Adam over a leaf list: by default one ``mega_adam_update``
    launch for every kernel-eligible leaf, plain math for the rest;
    ``megakernel=False`` runs the per-leaf route (small leaves bucketed).
    Returns (updates, new_mu, new_nu) as lists aligned with the input, and
    with ``with_health`` a :class:`StepHealth` last."""
    u, m, v, _, h = _tree(g_leaves, mu_leaves, nu_leaves, [()] * len(g_leaves), megakernel=megakernel,
                          bucket_min_size=bucket_min_size, emit_snr=False, with_health=with_health,
                          b1=b1, b2=b2, eps=eps, count=count)
    return (u, m, v) + ((_health_from_rows(h),) if with_health else ())


def slim_tree_update(g_leaves: Sequence[torch.Tensor], mu_leaves: Sequence[torch.Tensor],
                     nu_leaves: Sequence[torch.Tensor], dims_leaves: Sequence[Dims], *,
                     b1: float, b2: float, eps: float, count: torch.Tensor,
                     bucket_min_size: int = DEFAULT_BUCKET_MIN, emit_snr: bool = False,
                     with_health: bool = False, megakernel: bool = True):
    """SlimAdam over a leaf list with per-leaf reduction dims: K = () leaves
    take the dense route, K != () leaves the slim kernel their canonical
    plan names (one launch per megaplan group by default; per leaf with
    ``megakernel=False``). Returns (updates, new_mu, new_nu), then with
    ``emit_snr`` a per-leaf list of from-update SNR scalars (None for
    K = () leaves), then with ``with_health`` a :class:`StepHealth`."""
    u, m, v, s, h = _tree(g_leaves, mu_leaves, nu_leaves, dims_leaves, megakernel=megakernel,
                          bucket_min_size=bucket_min_size, emit_snr=emit_snr, with_health=with_health,
                          b1=b1, b2=b2, eps=eps, count=count)
    return (u, m, v) + ((s,) if emit_snr else ()) + ((_health_from_rows(h),) if with_health else ())
