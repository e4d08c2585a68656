"""Dense MLP blocks and the top-k mixture of experts (port of
``repro/models/mlp_moe.py``) on one device.

The MoE routes like the JAX layer, bit for bit in its integer parts: an f32
router and softmax, the top k with the lower expert index first on ties (as
``lax.top_k``; ``torch.topk`` promises no order on ties, so the port takes
the first k of a stable descending sort), gates renormalised, then a
cumsum over the token-major ``(n * k,)`` choices that gives each choice its
slot in its expert's ``capacity`` slots; a choice whose slot reaches the
capacity is dropped. The experts run batched (``torch.bmm`` over the expert
dim, weights cast to the activation dtype at use), and the combine gathers
each token's k expert rows in choice order and sums them, where the JAX
layer scatter-adds: no atomics, so a token's output, and under remat its
recompute, is the same on every run. No step waits for the device (no
boolean-mask indexing), so the host runs ahead of the card.

Under a sharding context the tokens are dispatched in G groups, as the JAX
layer does: G is the product of the mesh's batch axes (1 where the batch
does not divide), and each group's capacity comes from its own
``b * s / G`` tokens. Under a device-free ``SpecMesh`` the one process
computes all G groups, so the port's forward gives the JAX package's mesh
numbers. On a process mesh each rank holds one group's rows; with a
``model`` axis the dense MLP runs tensor- and sequence-parallel
(:func:`_mlp_explicit_tp`; a decode step's whole token: all-reduce tensor
parallelism) and the MoE expert-parallel over ``model``
(:func:`moe_forward`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..sharding import logical
from .common import ParamSpec


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_specs(d_model: int, d_ff: int, *, gated: bool, w_init, down_init):
    specs = {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "mlp_up", w_init,
                          fan_in=("embed",), fan_out=("mlp",)),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "mlp_down", down_init,
                            fan_in=("mlp",), fan_out=("embed",)),
    }
    if gated:
        specs["w_gate"] = ParamSpec((d_model, d_ff), ("embed", "mlp"), "mlp_gate", w_init,
                                    fan_in=("embed",), fan_out=("mlp",))
    return specs


def _mlp(p, x: torch.Tensor, *, gated: bool) -> torch.Tensor:
    h = x @ logical.weight(p, "w_up").to(x.dtype)
    if gated:
        h = F.silu(x @ logical.weight(p, "w_gate").to(x.dtype)) * h
    else:
        h = gelu(h)
    return h @ logical.weight(p, "w_down").to(x.dtype)


def mlp_forward(p, x: torch.Tensor, *, gated: bool) -> torch.Tensor:
    """The dense MLP. On a process mesh with ``tp > 1`` model ranks, x is
    the residual stream in the forward's layout: the tensor-parallel region
    where JAX takes its own (the sequence cut over ``model``, ``d_ff``
    divisible), else JAX's fallback (the region whole, this rank's part
    kept). In the decode layout (x whole on the model group): this rank's
    partial sum (:func:`_mlp_shard`) completed by a ``psum`` over ``model``
    where ``d_ff`` divides, else the MLP whole."""
    lay = logical.active_layout()
    if lay.tp > 1 and x.ndim == 3 and lay.decode:
        # the decode layout's all-reduce form: the whole token, this rank's
        # columns and rows, the partial sums completed by a psum
        ok = logical.whole_shape(p, "w_up")[1] % lay.tp == 0
        lay.count("mlp", ok)
        if ok:
            from ..launch.mesh import psum

            return psum(_mlp_shard(p, x, gated, lay.idx, lay.tp), lay.mesh, "model")
        return _mlp_shard(p, x, gated, 0, 1)
    if lay.tp > 1 and x.ndim == 3:
        ok = lay.sp and logical.whole_shape(p, "w_up")[1] % lay.tp == 0
        logical.region("mlp", ok)
        if ok:
            return _mlp_explicit_tp(p, x, gated, lay)
        return lay.whole(lambda xf: _mlp(p, xf, gated=gated), x)
    return _mlp(p, x, gated=gated)


def _mlp_shard(p, x_full: torch.Tensor, gated: bool, i: int, n: int) -> torch.Tensor:
    """Model rank ``i`` of ``n``'s partial sum (in x's dtype): its columns of
    up/gate and rows of down (:func:`repro_torch.sharding.logical.dot`:
    narrows of whole weights, stored shards gathered over ``data``, or in
    the decode layout stored shards read where they lie), cast to x's
    dtype. ``n = 1``: the whole MLP."""
    f_l = logical.whole_shape(p, "w_up")[1] // n
    cols, rows = {1: (i * f_l, f_l)}, {0: (i * f_l, f_l)}
    h = logical.dot("bsd,df->bsf", x_full, p, "w_up", cols)
    if gated:
        h = F.silu(logical.dot("bsd,df->bsf", x_full, p, "w_gate", cols)) * h
    else:
        h = gelu(h)
    return logical.dot("bsf,fd->bsd", h, p, "w_down", rows).to(x_full.dtype)


def _mlp_explicit_tp(p, x: torch.Tensor, gated: bool, lay) -> torch.Tensor:
    """Megatron-SP tensor parallelism (``repro/models/mlp_moe.py:60``): one
    all-gather of the sequence over ``model`` in, this rank's partial sum
    (:func:`_mlp_shard`), reduce-scattered back along the sequence."""
    from ..launch.mesh import all_gather, psum_scatter

    x_full = all_gather(x, lay.mesh, "model", 1)
    return psum_scatter(_mlp_shard(p, x_full, gated, lay.idx, lay.tp), lay.mesh, "model", 1)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    gated: bool = True
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


def moe_specs(cfg: MoEConfig, *, w_init, down_init):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts"), "moe_router", w_init),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "mlp"), "mlp_up", w_init,
                          fan_in=("embed",), fan_out=("mlp",)),
        "w_down": ParamSpec((e, f, d), ("experts", "mlp", "embed"), "mlp_down", down_init,
                            fan_in=("mlp",), fan_out=("embed",)),
    }
    if cfg.gated:
        specs["w_gate"] = ParamSpec((e, d, f), ("experts", "embed", "mlp"), "mlp_gate", w_init,
                                    fan_in=("embed",), fan_out=("mlp",))
    return specs


def moe_capacity(n: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n`` routed tokens: ``capacity_factor`` times
    the mean demand ``n * k / E``, rounded half to even as the JAX layer
    rounds on the host; dropless (``n`` slots) when ``n * k <= 16 * E``, so
    decode steps and small chunks never drop a choice."""
    e, k = cfg.n_experts, cfg.top_k
    capacity = int(max(1, round(n * k / e * cfg.capacity_factor)))
    if n * k <= 16 * e:
        capacity = min(n, max(capacity, n))
    return capacity


def _expert_ffn_dense(p, xg: torch.Tensor, cfg: MoEConfig, dtype, experts=None) -> torch.Tensor:
    """The experts' FFN batched over the expert dim, on the experts
    ``experts`` ((start, count); None: all), the weights read through
    :func:`repro_torch.sharding.logical.dot` (the slots are its rows). xg:
    (E_l, C, d) -> (E_l, C, d)."""
    cut = {0: experts} if experts else None
    h = logical.dot("ecd,edf->ecf", xg, p, "w_up", cut, rows=1, dtype=dtype)
    if cfg.gated:
        h = F.silu(logical.dot("ecd,edf->ecf", xg, p, "w_gate", cut, rows=1, dtype=dtype)) * h
    else:
        h = gelu(h)
    return logical.dot("ecf,efd->ecd", h, p, "w_down", cut, rows=1, dtype=dtype)


class _MoveRows(torch.autograd.Function):
    """``out[i] = src[index[i]]`` where ``mask[i]``, else 0. Its gradient
    goes back through the inverse map: ``dsrc[r]`` is the sum, over the
    ``group`` consecutive entries of ``back`` that belong to row r, of
    ``dout[back[g]]`` where ``back_mask[g]``. Both ways are gathers, so the
    backward needs no atomics and no sort of duplicate indices (a gather's
    own backward accumulates every empty slot's zero into row 0)."""

    @staticmethod
    def forward(ctx, src, index, mask, back, back_mask, group: int):
        ctx.save_for_backward(back, back_mask)
        ctx.group = group
        return torch.where(mask[:, None], src[index], 0)

    @staticmethod
    def backward(ctx, dout):
        back, back_mask = ctx.saved_tensors
        g = torch.where(back_mask[:, None], dout[back], 0)
        if ctx.group > 1:
            g = g.reshape(-1, ctx.group, g.shape[-1]).sum(dim=1)
        return g, None, None, None, None, None


class Dispatch(NamedTuple):
    """One group's routing as flat maps between the ``n * k`` token-major
    choices and the ``E * capacity`` slots, with the rows it gathered. The
    two maps are inverse bijections between the kept choices and the filled
    slots."""
    xg: torch.Tensor        # (E, C, d): the row each slot holds, 0 for an empty slot
    slot: torch.Tensor      # (n * k,): each choice's slot, 0 for a dropped choice
    keep: torch.Tensor      # (n * k,): the choice found a slot
    choice: torch.Tensor    # (E * C,): each slot's choice, 0 for an empty slot
    valid: torch.Tensor     # (E * C,): the slot is filled


def _dispatch_group(xf: torch.Tensor, eidx: torch.Tensor, e: int, k: int, capacity: int) -> Dispatch:
    """Token dispatch for one group, as the JAX function orders it. xf:
    (n, d); eidx: (n, k). A choice's position among its expert's slots is
    how many earlier token-major choices picked the same expert (a cumsum
    along each expert's row of the transposed one-hot, over contiguous
    memory); a choice whose position reaches ``capacity`` is dropped."""
    flat_e = eidx.reshape(-1)
    nk, dev = flat_e.shape[0], flat_e.device
    hits = flat_e[None, :] == torch.arange(e, device=dev)[:, None]                  # (E, n * k)
    my_pos = torch.cumsum(hits, dim=1, dtype=torch.int32).gather(0, flat_e[None, :])[0] - 1
    keep = my_pos < capacity
    slot = flat_e * capacity + my_pos
    # A dropped choice writes a spare last entry, cut off after: no boolean
    # mask, so nothing waits for the device.
    dispatch = torch.full((e * capacity + 1,), nk, dtype=torch.int64, device=dev)
    dispatch[torch.where(keep, slot, e * capacity)] = torch.arange(nk, device=dev)
    valid = dispatch[:-1] != nk
    slot, choice = torch.where(keep, slot, 0), torch.where(valid, dispatch[:-1], 0)
    xg = _MoveRows.apply(xf, choice // k, valid, slot, keep, k).reshape(e, capacity, -1)
    return Dispatch(xg, slot, keep, choice, valid)


def _combine(y: torch.Tensor, gates: torch.Tensor, dp: Dispatch) -> torch.Tensor:
    """y: (E, C, d) expert outputs; gates: (n, k) -> (n, d): each token's k
    rows ``y[e_j, slot_j]`` in choice order, 0 for a dropped choice, times
    the gate cast to y's dtype, summed. Every filled slot is read by exactly
    one choice."""
    n, k = gates.shape
    rows = _MoveRows.apply(y.reshape(-1, y.shape[-1]), dp.slot, dp.keep, dp.choice, dp.valid, 1)
    return (rows.reshape(n, k, -1) * gates.to(y.dtype)[..., None]).sum(dim=1)


def _router(xf: torch.Tensor, router: torch.Tensor, k: int):
    """(f32 logits (n, E), probs, renormalised gates (n, k), expert ids
    (n, k)) of the tokens ``xf`` (n, d) under ``router`` (d, E):
    :func:`_route` of their f32 logits."""
    return _route(xf.float() @ router.float(), k)


def _route(logits: torch.Tensor, k: int):
    """:func:`_router` from f32 logits: the top k of the softmax, the lower
    expert index first among equal probabilities, as ``lax.top_k`` orders
    them."""
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top.values[:, :k], top.indices[:, :k]
    return logits, probs, gates / gates.sum(dim=-1, keepdim=True), eidx


_drop_log: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_drops() -> Iterator[List[torch.Tensor]]:
    """Within the block, every :func:`moe_forward` call appends to the
    yielded list the number of routing choices it dropped in each of its
    dispatch groups (a (G,) int64 device tensor; on a process mesh, (1,):
    this rank's group), read by the caller when it likes. A remat
    recompute routes again and appends again."""
    global _drop_log
    prev, _drop_log = _drop_log, []
    try:
        yield _drop_log
    finally:
        _drop_log = prev


class Routing(NamedTuple):
    """One call's routing: f32 router logits and probabilities (n, E) over
    the tokens in group-major order, the renormalised gates and expert ids
    (n, k), each group's :class:`Dispatch` and the capacity."""
    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    eidx: torch.Tensor
    groups: List[Dispatch]
    capacity: int


def moe_groups(b: int, lay) -> int:
    """JAX's G for a batch of ``b`` rows: the product of the batch axes, or
    1 where it does not divide ``b``. On a process mesh each rank holds one
    group's rows."""
    g = lay.groups
    if lay.process or b % g:
        return 1
    return g


def moe_route(p, xf: torch.Tensor, cfg: MoEConfig, groups: int) -> Routing:
    """Route ``xf`` (n, d) and dispatch it in ``groups`` contiguous groups of
    ``n / groups`` tokens, each with the capacity of its own tokens."""
    e, k = cfg.n_experts, cfg.top_k
    n_g = xf.shape[0] // groups
    logits, probs, gates, eidx = _route(logical.dot("nd,de->ne", xf.float(), p, "router", dtype=torch.float32), k)
    capacity = moe_capacity(n_g, cfg)
    dps = [_dispatch_group(xs, es, e, k, capacity) for xs, es in zip(xf.split(n_g), eidx.split(n_g))]
    return Routing(logits, probs, gates, eidx, dps, capacity)


def _aux_loss(routing: Routing, cfg: MoEConfig, lay, s: int) -> torch.Tensor:
    """The load-balance loss ``aux_coef * E * sum(density * density_proxy)``
    with density from each token's top-1 choice and both means over every
    token of every group, plus the router z-loss. On a process mesh each
    rank sums the tokens it owns (its rows, its part of the sequence) and
    one all-reduce completes the sums before the product."""
    e = cfg.n_experts
    hits = F.one_hot(routing.eidx[:, 0], e).float()
    lse2 = torch.square(torch.logsumexp(routing.logits, dim=-1))
    if not lay.process:
        density = hits.mean(dim=0)
        proxy = routing.probs.mean(dim=0)
        zloss = torch.mean(lse2)
    else:
        from ..launch.mesh import psum

        start, n_own = lay.own(s)
        own = lambda t: t.reshape(-1, s, *t.shape[1:]).narrow(1, start, n_own)   # noqa: E731
        part = torch.cat([own(hits).sum(dim=(0, 1)), own(routing.probs).sum(dim=(0, 1)),
                          own(lse2).sum().reshape(1)])
        axes = logical.batch_axes(lay.mesh, lay.ctx.rules) + (("model",) if lay.tp > 1 else ())
        total = psum(part, lay.mesh, axes) if axes else part
        n_all = routing.logits.shape[0] * lay.groups
        density, proxy, zloss = total[:e] / n_all, total[e:2 * e] / n_all, total[2 * e] / n_all
    return cfg.aux_coef * e * torch.sum(density * proxy) + cfg.router_z_coef * zloss


def moe_forward(p, x: torch.Tensor, cfg: MoEConfig, *,
                with_aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, f32 aux loss): the
    load-balance loss ``aux_coef * E * sum(density * density_proxy)`` with
    density from each token's top-1 choice, plus the router z-loss.
    ``with_aux=False`` (the decode steps, which drop it) returns None for
    the aux loss and skips its work.

    On a process mesh x is this rank's rows, in the forward's layout. Each
    rank gathers its group's sequence over ``model`` and routes and
    dispatches the whole group (every rank of a model group alike); where
    ``model`` divides E (``_expert_ffn_sharded``'s condition) it runs its
    E/tp experts on their slots, the outputs are all-gathered over
    ``model`` and combined, and the rank keeps its part of the sequence;
    otherwise every rank runs all the experts (the fallback). In the decode
    layout the token is whole on the model group, so the gather and the
    keep are no-ops and the same expert-parallel form runs."""
    lay = logical.active_layout()
    b, s_l, d = x.shape
    e = cfg.n_experts
    xw = lay.gather_seq(x) if lay.process else x
    s = xw.shape[1]
    groups = moe_groups(b, lay)
    routing = moe_route(p, xw.reshape(b * s, d), cfg, groups)
    aux_loss = _aux_loss(routing, cfg, lay, s) if with_aux else None
    if _drop_log is not None:
        _drop_log.append(torch.stack([(~dp.keep).sum() for dp in routing.groups]))
    dps = routing.groups
    xg = dps[0].xg if groups == 1 else torch.cat([dp.xg for dp in dps], dim=1)   # (E, G * C, d), group-major
    if lay.tp > 1:
        ep = e % lay.tp == 0
        lay.count("moe", ep)
    else:
        ep = False
    if ep:
        from ..launch.mesh import all_gather

        e_l = e // lay.tp
        lo = lay.idx * e_l
        y = all_gather(_expert_ffn_dense(p, xg.narrow(0, lo, e_l), cfg, x.dtype, (lo, e_l)), lay.mesh, "model", 0)
    else:
        y = _expert_ffn_dense(p, xg, cfg, x.dtype)
    if groups == 1:
        out = _combine(y, routing.gates, dps[0])
    else:
        n_g = b * s // groups
        out = torch.cat([_combine(y_g, g_g, dp) for y_g, g_g, dp in
                         zip(y.split(routing.capacity, dim=1), routing.gates.split(n_g), dps)])
    out = out.reshape(b, s, d)
    return (lay.keep_own(out) if lay.process else out), aux_loss
