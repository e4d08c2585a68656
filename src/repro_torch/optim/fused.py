"""Fused optimizer backend: Adam/SlimAdam tree updates through the megaplan
kernels (port of the unsharded megaplan path of ``repro/optim/fused.py``).

Every kernel-eligible leaf joins a megaplan group (``repro_torch.kernels
.megaplan``): one ``mega_adam_update`` launch for the dense group and one
``mega_slim_update_batched`` launch per slim group, so a whole-tree update
costs O(groups) launches. Leaves no kernel serves (scalars, empty or
non-float tensors) take the per-leaf plain math. For CPU tensors the
kernel wrappers run their plain twins, so the same routing is testable
without a GPU.

A kernel that fails to build or launch raises: unlike the JAX package's
``_guarded`` there is no silent fallback to the plain path.

The per-leaf ``megakernel=False`` oracle, bucketing, the ``with_snr`` /
``with_health`` outputs and the sharded paths are not ported yet.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from ..kernels import megaplan

Dims = Tuple[int, ...]


def bias_corrections(b1: float, b2: float, count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^t, 1 - b2^t) as 0-d f32 tensors on the count's device, in f32
    as the JAX package computes them (``repro/kernels/fused_adam.py:29``)."""
    c = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=c.device)
    return (one - torch.full_like(c, b1) ** c, one - torch.full_like(c, b2) ** c)


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


def _mega_dense_group(group, gs, ms, vs, *, b1, b2, eps, count):
    """One launch over a dense group's lane-folded super-tensor; returns
    per-segment (u, m', v') lists aligned with ``group.segments``."""
    n = len(group.segments)
    bc1, bc2 = bias_corrections(b1, b2, count)
    outs = megaplan.mega_adam_update(
        megaplan.gather_group(group, gs), megaplan.gather_group(group, ms),
        megaplan.gather_group(group, vs), megaplan.segment_lines(group, [bc1] * n),
        megaplan.segment_lines(group, [bc2] * n), b1=b1, b2=b2, eps=eps)
    return tuple(megaplan.scatter_group(group, o) for o in outs)


def _mega_slim_group(group, gs, ms, vs, *, b1, b2, eps, count):
    """One launch over a slim group's canonical super-tensor; returns
    per-segment (u, m', v_red') lists."""
    n = len(group.segments)
    to3 = (lambda x: x) if group.kind == "batched" else (lambda x: x[None])
    un3 = (lambda x: x) if group.kind == "batched" else (lambda x: x[0])
    bc1, bc2 = bias_corrections(b1, b2, count)
    u, m_new, v_new = megaplan.mega_slim_update_batched(
        to3(megaplan.gather_group(group, gs)), to3(megaplan.gather_group(group, ms)),
        to3(megaplan.gather_group(group, vs, reduced=True)),
        to3(megaplan.segment_lines(group, [bc1] * n)), to3(megaplan.segment_lines(group, [bc2] * n)),
        axis=group.axis, b1=b1, b2=b2, eps=eps)
    return (megaplan.scatter_group(group, un3(u)), megaplan.scatter_group(group, un3(m_new)),
            megaplan.scatter_group(group, un3(v_new), reduced=True))


def _tree_mega(g_leaves, mu_leaves, nu_leaves, dims_leaves, *, b1, b2, eps, count):
    n = len(g_leaves)
    plan = megaplan.plan_megagroups([tuple(g.shape) for g in g_leaves], [g.dtype for g in g_leaves],
                                    [tuple(d) for d in dims_leaves])
    out_u: List[Any] = [None] * n
    out_m: List[Any] = [None] * n
    out_v: List[Any] = [None] * n
    kw = dict(b1=b1, b2=b2, eps=eps, count=count)
    for i in plan.jnp_idx:
        dims = tuple(dims_leaves[i])
        leaf = (jnp_slim_leaf(g_leaves[i], mu_leaves[i], nu_leaves[i], dims, **kw) if dims
                else jnp_adam_leaf(g_leaves[i], mu_leaves[i], nu_leaves[i], **kw))
        out_u[i], out_m[i], out_v[i] = leaf
    for group in plan.groups:
        run = _mega_dense_group if group.kind == "dense" else _mega_slim_group
        us, mo, vo = run(group, g_leaves, mu_leaves, nu_leaves, **kw)
        for seg, u, m, v in zip(group.segments, us, mo, vo):
            out_u[seg.index], out_m[seg.index], out_v[seg.index] = u, m, v
    return out_u, out_m, out_v


def adam_tree_update(g_leaves: Sequence[torch.Tensor], mu_leaves: Sequence[torch.Tensor],
                     nu_leaves: Sequence[torch.Tensor], *, b1: float, b2: float, eps: float,
                     count: torch.Tensor):
    """Dense Adam over a leaf list: one ``mega_adam_update`` launch for every
    kernel-eligible leaf, plain math for the rest. Returns (updates, new_mu,
    new_nu) as lists aligned with the input."""
    return _tree_mega(g_leaves, mu_leaves, nu_leaves, [()] * len(g_leaves),
                      b1=b1, b2=b2, eps=eps, count=count)


def slim_tree_update(g_leaves: Sequence[torch.Tensor], mu_leaves: Sequence[torch.Tensor],
                     nu_leaves: Sequence[torch.Tensor], dims_leaves: Sequence[Dims], *,
                     b1: float, b2: float, eps: float, count: torch.Tensor):
    """SlimAdam over a leaf list with per-leaf reduction dims: K = () leaves
    join the dense group, K != () leaves the slim group their canonical plan
    names (one launch per group). Returns (updates, new_mu, new_nu)."""
    return _tree_mega(g_leaves, mu_leaves, nu_leaves, dims_leaves, b1=b1, b2=b2, eps=eps, count=count)
