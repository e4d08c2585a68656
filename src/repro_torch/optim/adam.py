"""Adam / AdamW on the transformation API (port of ``repro/optim/adam.py``).

The uncompressed baseline the paper measures against; SlimAdam coincides
with it when every leaf's K is empty.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from . import fused
from .base import (
    GradientTransformation,
    add_decayed_weights,
    chain,
    clip_by_global_norm,
    matrices_only,
    resolve_backend,
    scale_by_learning_rate,
)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # int32 0-d, on the parameters' device
    mu: Any               # {name: f32 first moment}
    nu: Any               # {name: f32 second moment}


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, *,
                  backend: str = "jnp") -> GradientTransformation:
    """Adam preconditioner. ``backend`` (see ``repro_torch.optim.base
    .BACKENDS``): 'fused' runs the whole tree through one
    ``mega_adam_update`` launch; 'jnp' runs the plain per-leaf math; 'auto'
    picks 'fused' for CUDA tensors. State layout is backend-independent."""
    resolve_backend(backend)

    def init_fn(params):
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
        device = next(iter(params.values())).device
        return ScaleByAdamState(count=torch.zeros((), dtype=torch.int32, device=device), mu=zeros,
                                nu={k: torch.zeros_like(z) for k, z in zeros.items()})

    def update_fn(updates, state, params=None):
        names = list(updates)
        count = state.count + 1
        g = [updates[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        kw = dict(b1=b1, b2=b2, eps=eps, count=count)
        if resolve_backend(backend, g[0].device) == "fused":
            u, mu, nu = fused.adam_tree_update(g, mu, nu, **kw)
        else:
            u, mu, nu = zip(*[fused.jnp_adam_leaf(*leaf, **kw) for leaf in zip(g, mu, nu)])
        return dict(zip(names, u)), ScaleByAdamState(count, dict(zip(names, mu)), dict(zip(names, nu)))

    return GradientTransformation(init_fn, update_fn)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: Optional[float] = 1.0,
          backend: str = "jnp") -> GradientTransformation:
    """The paper's recipe: clip(1.0) -> Adam -> decoupled wd -> -lr."""
    parts = [clip_by_global_norm(grad_clip)] if grad_clip is not None else []
    parts.append(scale_by_adam(b1=b1, b2=b2, eps=eps, backend=backend))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay, mask=matrices_only))
    parts.append(scale_by_learning_rate(learning_rate))
    return chain(*parts)
