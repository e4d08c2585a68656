"""SlimAdam, the paper's low-memory Adam (port of ``repro/core/slim_adam.py``,
Eq. 2).

For a tensor with compression dims K the second moment follows

    V_{t+1} = b2 * V_t + (1 - b2) * E_K[G_t^2]

with V stored reduced over K (the reduced dims kept as size 1, so the
preconditioner broadcast is free). K = () recovers Adam for that tensor.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..optim import fused
from ..optim.adam import _sharding, fused_route, shard_clip
from ..optim.base import (
    GradientTransformation,
    ShardCuts,
    add_decayed_weights,
    chain,
    matrices_only,
    resolve_backend,
    scale_by_learning_rate,
)

Dims = Tuple[int, ...]


class ScaleBySlimAdamState(NamedTuple):
    count: torch.Tensor   # int32 0-d
    mu: Any               # {name: f32 first moment, full shape}; None without the first moment
    nu: Any               # {name: f32 second moment, size-1 reduced dims}
    # From-update SNR snapshot ({name: 0-d tensor, None for K = () leaves}),
    # published only by transformations built with ``emit_snr=True``.
    snr: Any = None
    # In-pass gradient health (emit_health states only). See
    # repro_torch.optim.fused.StepHealth.
    health: Any = None


def _reduced_shape(shape, dims: Dims) -> Tuple[int, ...]:
    return tuple(1 if i in set(dims) else s for i, s in enumerate(shape))


def second_moment_elements(params: Dict[str, torch.Tensor], dims: Dict[str, Dims]) -> int:
    """Stored second-moment entry count."""
    return sum(int(torch.Size(_reduced_shape(p.shape, tuple(dims[k]))).numel()) for k, p in params.items())


def scale_by_slim_adam(dims: Dict[str, Dims], b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, *,
                       use_first_moment: bool = True,
                       backend: str = "jnp", bucket_min_size: int = fused.DEFAULT_BUCKET_MIN,
                       mesh=None, param_specs=None, emit_snr: bool = False, emit_health: bool = False,
                       megakernel: bool = True, param_shards: bool = False) -> GradientTransformation:
    """Adam preconditioner with mean-shared second moments along per-leaf
    dims (``dims``: ``{name: positional dims}``, from
    ``repro_torch.core.rules.rules_as_tree``). ``backend`` 'fused' routes
    the tree through the megaplan (K = () leaves in the dense group, the
    rest in one ``mega_slim_update_batched`` launch per slim group;
    ``megakernel=False``: the per-leaf route, ``adam_precond`` and
    ``slim_precond_batched``, small dense leaves bucketed); 'jnp' runs the
    plain per-leaf math; 'auto' picks 'fused' for CUDA tensors.

    ``emit_snr=True`` makes each update also measure the from-update SNR of
    every compressed leaf (SNR_K of ``b2*V + (1-b2)*g^2``) and publish it on
    ``state.snr``; on the fused backend its line sums ride the update
    kernels' pass over g. Build a second transformation with this flag for
    measure steps and reuse the same state. ``emit_health=True`` publishes a
    :class:`repro_torch.optim.fused.StepHealth` on ``state.health``.

    ``use_first_moment=False`` keeps no first moment (``state.mu`` is None;
    the numerator is g). Every backend runs it through the per-leaf plain
    math, as the JAX package's fused backend does: the kernels read and
    write a first moment, so serving this variant through them would stream
    a discarded full-size m. On a mesh its state is sharded like the
    first-moment variant's and the update runs by leaf regime in plain
    math: a local leaf on its shard, a psum leaf in the plain psum form.

    ``mesh`` + ``param_specs`` make the fused backend sharded: the state
    holds this rank's shards (a psum leaf's reduced moment as its owner
    slice), the update takes the whole gradients and returns whole updates,
    with SNR and health equal on every rank (``repro_torch.optim.fused``);
    with ``param_shards`` the parameters, gradients and updates are this
    rank's shards too (parameter-shard storage), on either route: 'jnp'
    completes each leaf's mean of g^2 across the mesh axes that cut its K
    and keeps the reduced moment under the masked spec
    (``fused.jnp_slim_leaf`` with its ``cuts``)."""
    resolve_backend(backend)
    mesh, param_specs = _sharding(backend, mesh, param_specs, "scale_by_slim_adam", param_shards)

    def spec_leaves(names):
        from ..sharding.shardspec import normalize_spec_leaves

        return normalize_spec_leaves(param_specs, names, "scale_by_slim_adam")

    def init_fn(params):
        device = next(iter(params.values())).device
        if mesh is not None and fused_route(backend, device):
            names = list(params)
            mu, nu = fused.init_sharded_moments(list(params.values()), [tuple(dims[k]) for k in names],
                                                spec_leaves(names), mesh, reduced=True,
                                                use_first_moment=use_first_moment, param_shards=param_shards)
            return ScaleBySlimAdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                                        mu=dict(zip(names, mu)) if use_first_moment else None,
                                        nu=dict(zip(names, nu)))
        return ScaleBySlimAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
            if use_first_moment else None,
            nu={k: torch.zeros(_reduced_shape(p.shape, tuple(dims[k])), dtype=torch.float32, device=p.device)
                for k, p in params.items()})

    def update_fn(updates, state, params=None):
        names = list(updates)
        count = state.count + 1
        g = [updates[k] for k in names]
        mu = [state.mu[k] for k in names] if use_first_moment else [None] * len(names)
        nu = [state.nu[k] for k in names]
        d = [tuple(dims[k]) for k in names]
        kw = dict(b1=b1, b2=b2, eps=eps, count=count)
        snr = health = None
        on_fused = fused_route(backend, g[0].device)
        if on_fused and (use_first_moment or fused._use_sharded(mesh, param_specs)):
            if mesh is not None:
                kw.update(mesh=mesh, spec_leaves=spec_leaves(names), param_shards=param_shards)
            out = fused.slim_tree_update(g, mu if use_first_moment else None, nu, d, bucket_min_size=bucket_min_size,
                                         emit_snr=emit_snr, with_health=emit_health, megakernel=megakernel,
                                         use_first_moment=use_first_moment, **kw)
            u, mu, nu = out[:3]
            snr = out[3] if emit_snr else None
            health = out[-1] if emit_health else None
        else:
            # the plain math, on parameter shards each leaf's E_K[g^2] completed across the mesh
            cuts = ShardCuts(mesh, dict(zip(names, spec_leaves(names)))) if param_shards else ShardCuts()
            u, mu, nu = zip(*[fused.jnp_slim_leaf(*leaf, use_first_moment=use_first_moment, cuts=cuts, key=k, **kw)
                              for k, *leaf in zip(names, g, mu, nu, d)])
            if emit_snr:
                snr = [fused.jnp_update_snr_leaf(x, v, kd, b2=b2, cuts=cuts, key=k) if kd else None
                       for k, x, v, kd in zip(names, g, nu, d)]
            if emit_health:
                health = fused.tree_health(g, cuts, names)
        return dict(zip(names, u)), ScaleBySlimAdamState(count, dict(zip(names, mu)) if use_first_moment else None,
                                                          dict(zip(names, nu)),
                                                          dict(zip(names, snr)) if emit_snr else None, health)

    return GradientTransformation(init_fn, update_fn)


def slim_adam(learning_rate, dims: Dict[str, Dims], b1: float = 0.9, b2: float = 0.95,
              eps: float = 1e-8, weight_decay: float = 0.1, grad_clip: Optional[float] = 1.0,
              backend: str = "jnp", mesh=None, param_specs=None, emit_snr: bool = False,
              emit_health: bool = False, megakernel: bool = True, param_shards: bool = False
              ) -> GradientTransformation:
    """AdamW recipe with SlimAdam's compressed preconditioner — the same
    hyperparameters as Adam, as the paper requires (``learning_rate`` a
    constant or a schedule of the step count; ``mesh``/``param_specs``
    thread to :func:`scale_by_slim_adam`, ``param_shards`` there and to the
    clip)."""
    parts = shard_clip(grad_clip, mesh, param_specs, param_shards)
    parts.append(scale_by_slim_adam(dims, b1=b1, b2=b2, eps=eps, backend=backend, mesh=mesh,
                                    param_specs=param_specs, emit_snr=emit_snr, emit_health=emit_health,
                                    megakernel=megakernel, param_shards=param_shards))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay, mask=matrices_only))
    parts.append(scale_by_learning_rate(learning_rate))
    return chain(*parts)
