"""Adam / AdamW / SGD-M on the transformation API (port of ``repro/optim/adam.py``).

The uncompressed baseline the paper measures against; SlimAdam coincides
with it when every leaf's K is empty.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from . import fused
from .base import (
    GradientTransformation,
    ShardCuts,
    add_decayed_weights,
    chain,
    clip_by_global_norm,
    matrices_only,
    resolve_backend,
    scale_by_learning_rate,
    trace,
)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # int32 0-d, on the parameters' device
    mu: Any               # {name: f32 first moment}
    nu: Any               # {name: f32 second moment}
    # In-pass gradient health (emit_health states only; None otherwise, and
    # None contributes no checkpoint leaf). See repro_torch.optim.fused.StepHealth.
    health: Any = None


def _sharding(backend: str, mesh, param_specs, what: str, param_shards: bool = False):
    """(mesh, param_specs) for the fused backend's sharded path and for
    parameter shards on any route, else (None, None): the plain per-leaf
    math on whole leaves needs no mesh."""
    if param_shards:
        if mesh is None or param_specs is None:
            raise ValueError(f"{what}: parameter shards need a mesh and the parameter specs")
        return mesh, param_specs
    if backend == "jnp" or (mesh is None and param_specs is None):
        return None, None
    from ..sharding.shardspec import sharded_pair

    return sharded_pair(mesh, param_specs, what)


def fused_route(backend: str, device) -> bool:
    """Whether ``backend`` runs the fused route for tensors on ``device``
    ('auto' picks it for CUDA tensors, as ``resolve_backend`` does); the
    backend named is the one that runs."""
    return resolve_backend(backend, device) == "fused"


def shard_clip(grad_clip: Optional[float], mesh, param_specs, param_shards: bool) -> list:
    """The chain's gradient clip: its norm completed across the mesh where
    the gradients are this rank's shards."""
    if grad_clip is None:
        return []
    if param_shards and (mesh is None or param_specs is None):
        raise ValueError("parameter shards need a mesh and the parameter specs")
    return [clip_by_global_norm(grad_clip, **(dict(mesh=mesh, specs=param_specs) if param_shards else {}))]


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
                  backend: str = "jnp", bucket_min_size: int = fused.DEFAULT_BUCKET_MIN,
                  mesh=None, param_specs=None, emit_health: bool = False,
                  megakernel: bool = True, param_shards: bool = False) -> GradientTransformation:
    """Adam preconditioner. ``backend`` (see ``repro_torch.optim.base
    .BACKENDS``): 'fused' runs the whole tree through one
    ``mega_adam_update`` launch (``megakernel=False``: the per-leaf
    ``adam_precond`` route, leaves below ``bucket_min_size`` elements
    bucketed); 'jnp' runs the plain per-leaf math; 'auto' picks 'fused' for
    CUDA tensors. State layout is backend-independent.

    ``emit_health=True`` publishes a :class:`repro_torch.optim.fused
    .StepHealth` on ``state.health`` each update — per-leaf non-finite
    counts + the finite-masked grad sumsq, from the kernels' own pass (the
    guarded train step reads it to skip poisoned steps).

    ``mesh`` + ``param_specs`` (a ``repro_torch.launch.mesh.Mesh`` and a
    ``{name: PartitionSpec}`` dict) make the fused backend sharded: the
    state holds this rank's shards of mu and nu, the update takes the whole
    gradients and returns whole updates (``repro_torch.optim.fused``); with
    ``param_shards`` the parameters, gradients and updates are this rank's
    shards too (parameter-shard storage), on either route: 'jnp' runs the
    plain math on each shard, elementwise, with the health completed
    across the mesh."""
    resolve_backend(backend)
    mesh, param_specs = _sharding(backend, mesh, param_specs, "scale_by_adam", param_shards)

    def spec_leaves(names):
        from ..sharding.shardspec import normalize_spec_leaves

        return normalize_spec_leaves(param_specs, names, "scale_by_adam")

    def init_fn(params):
        device = next(iter(params.values())).device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if mesh is not None and fused_route(backend, device):
            names = list(params)
            mu, nu = fused.init_sharded_moments(list(params.values()), [()] * len(names), spec_leaves(names), mesh,
                                                reduced=False, param_shards=param_shards)
            return ScaleByAdamState(count=count, mu=dict(zip(names, mu)), nu=dict(zip(names, nu)))
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
        return ScaleByAdamState(count=count, mu=zeros, nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    def update_fn(updates, state, params=None):
        names = list(updates)
        count = state.count + 1
        g = [updates[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        kw = dict(b1=b1, b2=b2, eps=eps, count=count)
        health = None
        if fused_route(backend, g[0].device):
            if mesh is not None:
                kw.update(mesh=mesh, spec_leaves=spec_leaves(names), param_shards=param_shards)
            out = fused.adam_tree_update(g, mu, nu, bucket_min_size=bucket_min_size, with_health=emit_health,
                                         megakernel=megakernel, **kw)
            u, mu, nu = out[:3]
            health = out[3] if emit_health else None
        else:
            # elementwise: on parameter shards every op is the shard's own
            u, mu, nu = zip(*[fused.jnp_adam_leaf(*leaf, **kw) for leaf in zip(g, mu, nu)])
            if emit_health:
                cuts = ShardCuts(mesh, dict(zip(names, spec_leaves(names)))) if param_shards else ShardCuts()
                health = fused.tree_health(g, cuts, names)
        return dict(zip(names, u)), ScaleByAdamState(count, dict(zip(names, mu)), dict(zip(names, nu)), health)

    return GradientTransformation(init_fn, update_fn)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: Optional[float] = 1.0,
          backend: str = "jnp", mesh=None, param_specs=None, emit_health: bool = False,
          megakernel: bool = True, param_shards: bool = False) -> GradientTransformation:
    """The paper's recipe: clip(1.0) -> Adam -> decoupled wd -> -lr
    (``learning_rate`` a constant or a schedule of the step count;
    ``mesh``/``param_specs``/``param_shards`` thread to
    :func:`scale_by_adam`, and with ``param_shards`` to the clip)."""
    parts = shard_clip(grad_clip, mesh, param_specs, param_shards)
    parts.append(scale_by_adam(b1=b1, b2=b2, eps=eps, backend=backend, mesh=mesh, param_specs=param_specs,
                               emit_health=emit_health, megakernel=megakernel, param_shards=param_shards))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay, mask=matrices_only))
    parts.append(scale_by_learning_rate(learning_rate))
    return chain(*parts)


def sgdm(learning_rate, momentum: float = 0.9, nesterov: bool = False, weight_decay: float = 0.0,
         grad_clip: Optional[float] = 1.0, mesh=None, param_specs=None,
         param_shards: bool = False) -> GradientTransformation:
    """SGD with momentum: clip -> (coupled wd) -> momentum buffer -> -lr.
    Elementwise after the clip, so on parameter shards (``param_shards``)
    only the clip's norm crosses ranks."""
    parts = shard_clip(grad_clip, mesh, param_specs, param_shards)
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay, mask=matrices_only))
    parts.append(trace(momentum, nesterov=nesterov))
    parts.append(scale_by_learning_rate(learning_rate))
    return chain(*parts)
