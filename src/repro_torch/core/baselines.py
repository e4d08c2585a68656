"""Baseline low-memory optimizers the paper compares against (port of
``repro/core/baselines.py``; paper Fig. 1, App. A).

Drop-in-Adam family: rule sets for SlimAdam, since each shares second
moments along some dims K (paper §2). They run through the ported SlimAdam
and its megaplan, so on the card their updates take the same kernels as the
paper's own rules.
  * :func:`adalayer_rules`          — one second moment per parameter block
  * :func:`adalayer_ln_tl_rules`    — AdaLayer + uncompressed LayerNorm and
                                      tied embedding/LM-head (Zhao et al., 2024)
  * :func:`adam_mini_v1_rules` / :func:`adam_mini_v2_rules` (Zhang et al., 2024b)

Algorithmically different family, plain PyTorch per leaf as the JAX package
writes them in plain jnp (no kernel):
  * :func:`adafactor`  (Shazeer & Stern, 2018) — factored second moments
  * :func:`sm3`        (Anil et al., 2019) — per-axis max accumulators
  * :func:`lion`       (Chen et al., 2023) — sign momentum

States are NamedTuples with the JAX package's fields, so checkpoints carry
the same leaf names in both packages.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..optim.adam import shard_clip
from ..optim.base import (
    GradientTransformation,
    ShardCuts,
    add_decayed_weights,
    chain,
    matrices_only,
    scale_by_learning_rate,
)
from .labels import STRUCTURAL_AXES, ParamMeta, flatten_with_names
from .rules import Rule


# ---------------------------------------------------------------------------
# Rule-based baselines (members of the low-memory Adam family)
# ---------------------------------------------------------------------------


def _all_eligible(m: ParamMeta) -> Tuple[str, ...]:
    return tuple(a for a in m.axes if a not in STRUCTURAL_AXES)


def adalayer_rules(meta: Any) -> Dict[str, Rule]:
    """One second moment per parameter block (AdaLayer): reduce every
    non-structural axis. Stacked tensors keep one moment per layer."""
    return {name: _all_eligible(m) or None for name, m in flatten_with_names(meta)}


def adalayer_ln_tl_rules(meta: Any) -> Dict[str, Rule]:
    """AdaLayer + per-parameter moments for norms and embedding/LM-head."""
    out = adalayer_rules(meta)
    for name, m in flatten_with_names(meta):
        if m.role in ("norm", "token_embedding", "lm_head", "head"):
            out[name] = None
    return out


def _per_head(elig: Tuple[str, ...]) -> Rule:
    """Reduce everything except the 'heads'/'kv_heads' axis."""
    return tuple(a for a in elig if a not in ("heads", "kv_heads")) or None


def adam_mini_v1_rules(meta: Any) -> Dict[str, Rule]:
    """Adam-mini v1.0.4: one moment per default parameter block, except
    per-parameter embedding/LM-head and per-head attention K/Q."""
    out: Dict[str, Rule] = {}
    for name, m in flatten_with_names(meta):
        elig = _all_eligible(m)
        if m.role in ("token_embedding", "lm_head", "head"):
            out[name] = None
        elif m.role in ("attn_k", "attn_q"):
            out[name] = _per_head(elig)
        else:
            out[name] = elig or None
    return out


def adam_mini_v2_rules(meta: Any) -> Dict[str, Rule]:
    """Adam-mini v1.1.1: one moment per output neuron (reduce the input
    dim), except per-head K/Q and per-token embedding/LM-head; norms
    compressed."""
    out: Dict[str, Rule] = {}
    for name, m in flatten_with_names(meta):
        elig = _all_eligible(m)
        if m.role in ("token_embedding", "lm_head", "head"):
            # one moment per token: reduce the embedding axis
            out[name] = tuple(a for a in m.fan_in + m.fan_out if a == "embed") or None
        elif m.role in ("attn_k", "attn_q"):
            out[name] = _per_head(elig)
        elif m.role == "norm" or not elig:
            out[name] = elig or None
        elif m.fan_in:
            out[name] = tuple(m.fan_in)  # one moment per output neuron
        else:
            out[name] = elig
    return out


def _recipe(core: GradientTransformation, learning_rate, weight_decay: float,
            grad_clip: Optional[float], mesh=None, param_specs=None, param_shards: bool = False
            ) -> GradientTransformation:
    """clip -> core -> decoupled wd (matrices) -> -lr: the chain indices of
    the JAX package's baselines (the clip's norm completed across the mesh
    under ``param_shards``)."""
    parts = shard_clip(grad_clip, mesh, param_specs, param_shards)
    parts.append(core)
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay, mask=matrices_only))
    parts.append(scale_by_learning_rate(learning_rate))
    return chain(*parts)


def _cuts(mesh, param_specs, param_shards: bool) -> ShardCuts:
    """Whole leaves, or with ``param_shards`` this rank's shards under
    ``param_specs`` on ``mesh`` (both required)."""
    if not param_shards:
        return ShardCuts()
    if mesh is None or param_specs is None:
        raise ValueError("parameter shards need the mesh and the parameter specs")
    return ShardCuts(mesh, dict(param_specs))


# ---------------------------------------------------------------------------
# Adafactor (v1: no momentum; v2: + update EMA), relative_step=False
# ---------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    count: torch.Tensor   # int32 0-d
    vr: Any               # {name: row stats (factored leaves) or the full v}
    vc: Any               # {name: column stats (factored leaves) or a 0-d placeholder}
    mu: Any               # {name: update EMA} (v2), else None


def _factored(shape) -> bool:
    """Whether a leaf of (global) ``shape`` keeps factored statistics."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _col_specs(cuts: ShardCuts, k: str, shape) -> Tuple[Any, Any]:
    """(the spec the column statistics of a factored leaf are computed in,
    the spec they are stored in): JAX's ``_masked_like_params_partial``
    matches the state by shape, so a leaf whose last two dims are equal
    stores its column statistics under the row statistics' entries."""
    from ..sharding.shardspec import PartitionSpec as P
    from ..sharding.state_shardings import _masked_like_params_partial

    ent = list(cuts.specs[k]) + [None] * (len(shape) - len(cuts.specs[k]))
    col = shape[:-2] + shape[-1:]
    stored = _masked_like_params_partial({k: cuts.specs[k]}, {k: torch.empty(col, device="meta")},
                                         {k: torch.empty(shape, device="meta")})[k]
    return P(*(ent[:-2] + ent[-1:])), stored


def adafactor(learning_rate, *, decay_rate: float = 0.8, eps1: float = 1e-30, clip_threshold: float = 1.0,
              momentum: Optional[float] = None, weight_decay: float = 0.0,
              grad_clip: Optional[float] = 1.0, mesh=None, param_specs=None,
              param_shards: bool = False) -> GradientTransformation:
    """Adafactor with factored second moments of every matrix-like leaf
    (v_hat = vr vc^T / mean(vr) over the last two dims), RMS update
    clipping, and with ``momentum`` (v2: 0.9) an EMA of the updates.

    ``param_shards`` (with ``mesh`` and ``param_specs``): the parameters,
    gradients and updates are this rank's shards, and the state its shards
    under ``repro_torch.sharding.opt_state_specs``. Which leaves factor
    follows their global shapes; the row and column means, the mean of the
    row statistics and the RMS of the update are completed across the mesh
    axes that cut the dims they reduce."""
    cuts = _cuts(mesh, param_specs, param_shards)

    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def col_layout(k, shape):
        if cuts.mesh is None:
            return None
        natural, stored = _col_specs(cuts, k, shape)
        return None if natural == stored else (natural, stored)

    def init_fn(params):
        from ..sharding.shardspec import local_shape

        vr, vc = {}, {}
        for k, p in params.items():
            shape = cuts.shape(k, p)
            if not _factored(shape):
                vr[k], vc[k] = zeros(p.shape, p), zeros((), p)
                continue
            vr[k] = zeros(p.shape[:-1], p)
            layout = col_layout(k, shape)
            vc[k] = zeros(p.shape[:-2] + p.shape[-1:] if layout is None else
                          local_shape(shape[:-2] + shape[-1:], layout[1], cuts.mesh), p)
        mu = {k: zeros(p.shape, p) for k, p in params.items()} if momentum else None
        device = next(iter(params.values())).device
        return AdafactorState(count=torch.zeros((), dtype=torch.int32, device=device), vr=vr, vc=vc, mu=mu)

    def leaf(k, g, vr, vc, mu, beta2t):
        shape, nd = cuts.shape(k, g), g.ndim
        g = g.float()
        g2 = torch.square(g) + eps1
        if _factored(shape):
            layout = col_layout(k, shape)
            if layout is not None:
                vc = cuts.mesh.shard(cuts.mesh.gather(vc, layout[1]), layout[0])
            rows = cuts.sum(torch.sum(g2, dim=-1), cuts.axes(k, nd, (-1,))) / shape[-1]
            cols = cuts.sum(torch.sum(g2, dim=-2), cuts.axes(k, nd, (-2,))) / shape[-2]
            new_vr = beta2t * vr + (1 - beta2t) * rows
            new_vc = beta2t * vc + (1 - beta2t) * cols
            vr_mean = cuts.sum(torch.sum(new_vr, dim=-1, keepdim=True), cuts.axes(k, nd, (-2,))) / shape[-2]
            vhat = (new_vr / vr_mean)[..., :, None] * new_vc[..., None, :]
            if layout is not None:
                new_vc = cuts.mesh.shard(cuts.mesh.gather(new_vc, layout[0]), layout[1])
        else:
            new_vr = beta2t * vr + (1 - beta2t) * g2
            new_vc = vc
            vhat = new_vr
        u = g / torch.sqrt(vhat)
        # update clipping by RMS (Shazeer & Stern eq. 6), over the whole leaf
        total = cuts.sum(torch.sum(torch.square(u)), cuts.axes(k, nd, range(nd)))
        rms_u = torch.sqrt(total / math.prod(shape)) + 1e-16
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        if mu is not None:
            u = momentum * mu + (1 - momentum) * u
        return u, new_vr, new_vc

    def core_update(updates, state, params=None):
        count = state.count + 1
        beta2t = 1.0 - torch.pow(count.float(), -decay_rate)
        outs = {k: leaf(k, g, state.vr[k], state.vc[k], state.mu[k] if state.mu is not None else None, beta2t)
                for k, g in updates.items()}
        u = {k: o[0] for k, o in outs.items()}
        return u, AdafactorState(count=count, vr={k: o[1] for k, o in outs.items()},
                                 vc={k: o[2] for k, o in outs.items()}, mu=dict(u) if momentum else None)

    return _recipe(GradientTransformation(init_fn, core_update), learning_rate, weight_decay, grad_clip,
                   mesh, param_specs, param_shards)


# ---------------------------------------------------------------------------
# SM3 (SM3-II with optional momentum and exponential moving accumulators)
# ---------------------------------------------------------------------------


class SM3State(NamedTuple):
    accs: Any   # {name: tuple of per-axis accumulators, each size 1 off its axis}
    mom: Any    # {name: momentum}


def sm3(learning_rate, *, momentum: float = 0.9, beta: float = 0.95, eps: float = 1e-8,
        weight_decay: float = 0.0, grad_clip: Optional[float] = 1.0, mesh=None, param_specs=None,
        param_shards: bool = False) -> GradientTransformation:
    """SM3-II: the second moment of an entry is the min over its axes'
    max-accumulators; ``beta`` > 0 makes it an EMA (paper App. A: 0.95 is
    best for GPT pre-training).

    ``param_shards`` (with ``mesh`` and ``param_specs``): the parameters,
    gradients, updates and momentum are this rank's shards; the per-axis
    accumulators are held whole on every rank (replicated, as JAX lays
    them out). Each rank reads its block of them, takes the max over the
    other dims of its shard, completes it across the mesh axes that cut
    those dims, and gathers the axis back whole."""
    cuts = _cuts(mesh, param_specs, param_shards)

    def accs_of(k, p):
        if p.ndim == 0:
            return (torch.zeros((), dtype=torch.float32, device=p.device),)
        shape = cuts.shape(k, p)
        return tuple(torch.zeros(tuple(s if i == ax else 1 for i, s in enumerate(shape)), dtype=torch.float32,
                                 device=p.device) for ax in range(p.ndim))

    def init_fn(params):
        return SM3State(accs={k: accs_of(k, p) for k, p in params.items()},
                        mom={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()})

    def leaf(k, g, accs, m):
        g = g.float()
        nd = g.ndim
        if nd == 0:
            nu = accs[0]
            new_nu = torch.clamp(beta * nu, min=0.0) + (1 - beta) * torch.square(g) if beta > 0 \
                else nu + torch.square(g)
            new_accs = (new_nu,)
            precond = g / (torch.sqrt(new_nu) + eps)
        else:
            nu_hat = cuts.block(accs[0], k, nd, 0)
            for ax in range(1, nd):
                nu_hat = torch.minimum(nu_hat, cuts.block(accs[ax], k, nd, ax))
            nu = beta * nu_hat + (1 - beta) * torch.square(g) if beta > 0 else nu_hat + torch.square(g)
            # the max over every other axis (a 1-D leaf's only accumulator is nu itself)
            new_accs = []
            for ax in range(nd):
                others = tuple(i for i in range(nd) if i != ax)
                acc = cuts.max(torch.amax(nu, dim=others, keepdim=True), cuts.axes(k, nd, others)) if others else nu
                new_accs.append(cuts.whole(acc, k, nd, ax))
            new_accs = tuple(new_accs)
            precond = g / (torch.sqrt(nu) + eps)
        return momentum * m + (1 - momentum) * precond, new_accs

    def core_update(updates, state, params=None):
        outs = {k: leaf(k, g, state.accs[k], state.mom[k]) for k, g in updates.items()}
        mom = {k: o[0] for k, o in outs.items()}
        return dict(mom), SM3State(accs={k: o[1] for k, o in outs.items()}, mom=mom)

    return _recipe(GradientTransformation(init_fn, core_update), learning_rate, weight_decay, grad_clip,
                   mesh, param_specs, param_shards)


# ---------------------------------------------------------------------------
# Lion
# ---------------------------------------------------------------------------


class LionState(NamedTuple):
    mu: Any     # {name: f32 momentum}


def lion(learning_rate, b1: float = 0.9, b2: float = 0.95, weight_decay: float = 0.1,
         grad_clip: Optional[float] = 1.0, mesh=None, param_specs=None,
         param_shards: bool = False) -> GradientTransformation:
    """Lion: the update is sign(b1 * m + (1 - b1) * g), the momentum a b2
    EMA of g (paper App. A: b2 = 0.95 is best for GPT-small). Elementwise,
    so on parameter shards (``param_shards``) only the clip's norm crosses
    ranks."""

    def init_fn(params):
        return LionState(mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                             for k, p in params.items()})

    def core_update(updates, state, params=None):
        g = {k: u.float() for k, u in updates.items()}
        direction = {k: torch.sign(b1 * state.mu[k] + (1 - b1) * x) for k, x in g.items()}
        return direction, LionState(mu={k: b2 * state.mu[k] + (1 - b2) * x for k, x in g.items()})

    return _recipe(GradientTransformation(init_fn, core_update), learning_rate, weight_decay, grad_clip,
                   mesh, param_specs, param_shards)
