"""Minimal optax-style gradient transformations on flat name -> tensor dicts
(port of ``repro/optim/base.py``).

    tx = chain(clip_by_global_norm(1.0), slim_adam(...), add_decayed_weights(0.1),
               scale_by_learning_rate(lr))

``update(grads, state, params) -> (updates, new_state)``; updates are added
to the parameters by :func:`apply_updates`. States are NamedTuples of device
tensors; nothing here synchronises with the host, except :func:`multi_steps`
(one read of its micro-step counter per update).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]

# Optimizer execution backends, named as in the JAX package:
#   'jnp'   — the per-leaf plain-PyTorch math (the reference path)
#   'fused' — the megaplan through the hand-written CUDA kernels (for CPU
#             tensors the kernels' plain twins run in their place)
#   'auto'  — 'fused' for CUDA tensors, 'jnp' otherwise
BACKENDS = ("jnp", "fused", "auto")


def resolve_backend(backend: str, device: Optional[torch.device] = None) -> str:
    """Collapse 'auto' to a concrete backend for tensors on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "auto":
        return "fused" if device is not None and torch.device(device).type == "cuda" else "jnp"
    return backend


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], Tuple[Tree, Any]]


class EmptyState(NamedTuple):
    pass


def identity() -> GradientTransformation:
    """Pass the updates through unchanged."""
    return GradientTransformation(lambda params: EmptyState(), lambda updates, state, params=None: (updates, state))


class ChainState(NamedTuple):
    inner_states: Tuple[Any, ...]


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transformations left to right."""

    def init_fn(params):
        return ChainState(tuple(t.init(params) for t in transforms))

    def update_fn(updates, state, params=None):
        new_states = []
        for t, s in zip(transforms, state.inner_states):
            updates, s = t.update(updates, s, params)
            new_states.append(s)
        return updates, ChainState(tuple(new_states))

    return GradientTransformation(init_fn, update_fn)


def _stateless(fn: Callable[[Tree, Optional[Tree]], Tree]) -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None: (fn(updates, params), state))


class ScaleState(NamedTuple):
    pass


def scale(factor: float) -> GradientTransformation:
    """Multiply every update by a constant."""
    return GradientTransformation(lambda params: ScaleState(),
                                  lambda updates, state, params=None: ({k: u * factor for k, u in updates.items()},
                                                                       state))


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 0-d


def scale_by_schedule(schedule: Callable[[torch.Tensor], torch.Tensor]) -> GradientTransformation:
    """Multiply by ``schedule(count)`` and advance the count (a state leaf,
    so it rides in checkpoints at the same chain index as JAX's)."""

    def init_fn(params):
        device = next(iter(params.values())).device
        return ScaleByScheduleState(count=torch.zeros((), dtype=torch.int32, device=device))

    def update_fn(updates, state, params=None):
        step_size = schedule(state.count)
        updates = {k: u * step_size.to(u.dtype) for k, u in updates.items()}
        return updates, ScaleByScheduleState(count=state.count + 1)

    return GradientTransformation(init_fn, update_fn)


def scale_by_learning_rate(lr, *, flip_sign: bool = True) -> GradientTransformation:
    """Multiply by -lr (+lr with ``flip_sign=False``): a constant, or a
    schedule of the step count (``repro_torch.optim.schedules``)."""
    m = -1.0 if flip_sign else 1.0
    if callable(lr):
        return scale_by_schedule(lambda count: m * lr(count))
    return scale(m * lr)


def global_norm(tree: Tree, *, mesh=None, specs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32, on the device.

    With ``mesh`` + ``specs`` (``{name: PartitionSpec}``) the leaves are this
    rank's shards, each laid out by its spec: each leaf's sum of squares is
    divided by the number of ranks that hold a copy of its shard (the sizes
    of the axes its spec does not use), and one all-reduce over every axis
    completes the sum, so every rank gets the global norm."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))
    from ..sharding.shardspec import spec_entries

    parts = []
    for k, x in tree.items():
        used = {a for e in spec_entries(specs[k], x.ndim) for a in e}
        copies = mesh.size // mesh.axis_size(tuple(used))
        parts.append(torch.sum(torch.square(x.float())) / copies)
    return torch.sqrt(mesh.psum(torch.stack(parts).sum(), tuple(mesh.shape)))


def clip_by_global_norm(max_norm: float, *, mesh=None, specs: Optional[Dict[str, Any]] = None
                        ) -> GradientTransformation:
    """Rescale only when the norm exceeds ``max_norm``; never amplify. The
    decision stays on the device (no host sync). ``mesh`` + ``specs``: the
    updates are this rank's shards and the norm is completed across the
    mesh (:func:`global_norm`)."""

    def clip(updates, params):
        g_norm = global_norm(updates, mesh=mesh, specs=specs)
        factor = torch.where(g_norm <= max_norm, torch.ones_like(g_norm), max_norm / (g_norm + 1e-16))
        return {k: u * factor.to(u.dtype) for k, u in updates.items()}

    return _stateless(clip)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Callable[[Tree], Dict[str, bool]]] = None) -> GradientTransformation:
    """Decoupled weight decay (AdamW): u + wd * p on the leaves ``mask``
    selects (all leaves without a mask)."""

    def decay(updates, params):
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        use = mask(params) if mask is not None else {k: True for k in params}
        return {k: (u + weight_decay * params[k].to(u.dtype) if use[k] else u) for k, u in updates.items()}

    return _stateless(decay)


def matrices_only(params: Tree) -> Dict[str, bool]:
    """The standard LM weight-decay mask: decay tensors with ndim >= 2."""
    return {k: p.ndim >= 2 for k, p in params.items()}


class ShardCuts:
    """Where each leaf of a parameter-shaped dict is cut across a mesh
    (parameter-shard storage: the leaves are this rank's shards under
    ``specs``), so that a reduction over some of a leaf's dims can be
    completed across the mesh axes that cut them, with the global extent
    as the divisor. With ``mesh`` None every leaf is whole, and every
    completion is the identity."""

    def __init__(self, mesh=None, specs: Optional[Dict[str, Any]] = None):
        self.mesh = mesh if specs is not None else None
        self.specs = specs

    def entries(self, k: str, ndim: int) -> Tuple[Tuple[str, ...], ...]:
        """The mesh axes cutting each dim of leaf ``k``."""
        if self.mesh is None:
            return ((),) * ndim
        from ..sharding.shardspec import spec_entries

        return spec_entries(self.specs[k], ndim)

    def axes(self, k: str, ndim: int, dims) -> Tuple[str, ...]:
        """The mesh axes cutting any of ``dims`` of leaf ``k``."""
        ent = self.entries(k, ndim)
        return tuple(a for d in sorted({d % ndim for d in dims}) for a in ent[d])

    def shape(self, k: str, x: torch.Tensor) -> Tuple[int, ...]:
        """The global shape of leaf ``k``, of which ``x`` is this rank's shard."""
        if self.mesh is None:
            return tuple(x.shape)
        from ..sharding.shardspec import global_shape

        return global_shape(tuple(x.shape), self.specs[k], self.mesh)

    def sum(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """``x`` summed over the ranks of ``axes``."""
        return self.mesh.psum(x, axes) if axes else x

    def mean(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """The mean of ``x`` over the ranks of ``axes``: of a local mean over
        a leaf's dims, the mean over the whole leaf (its shards are equal in
        size). The identity, bit for bit, where no axis cuts."""
        return self.mesh.psum(x, axes) / self.mesh.axis_size(axes) if axes else x

    def max(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks of ``axes``."""
        return self.mesh.pmax(x, axes) if axes else x

    def block(self, x: torch.Tensor, k: str, ndim: int, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of a tensor that holds dim ``dim``
        of leaf ``k`` whole (a replicated per-axis statistic)."""
        axes = self.entries(k, ndim)[dim]
        if not axes:
            return x
        blk = x.shape[dim] // self.mesh.axis_size(axes)
        return x.narrow(dim, self.mesh.group_index(axes) * blk, blk)

    def whole(self, x: torch.Tensor, k: str, ndim: int, dim: int) -> torch.Tensor:
        """The inverse of :meth:`block`: every rank's block along ``dim``,
        gathered."""
        axes = self.entries(k, ndim)[dim]
        if not axes:
            return x
        from ..sharding.shardspec import PartitionSpec

        return self.mesh.gather(x.contiguous(), PartitionSpec(*[axes if i == dim else None for i in range(ndim)]))


class TraceState(NamedTuple):
    trace: Any            # {name: momentum buffer}, shaped and typed like the parameters


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """SGD momentum buffer: t' = decay * t + u; the update is t' (Nesterov:
    decay * t' + u)."""

    def init_fn(params):
        return TraceState(trace={k: torch.zeros_like(p) for k, p in params.items()})

    def update_fn(updates, state, params=None):
        new = {k: decay * state.trace[k] + u for k, u in updates.items()}
        if nesterov:
            updates = {k: decay * new[k] + u for k, u in updates.items()}
        else:
            updates = new
        return updates, TraceState(trace=new)

    return GradientTransformation(init_fn, update_fn)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """p <- p + u in place (the port updates parameters in place to save
    the copy JAX's functional update makes); returns ``params``. The sum is
    taken in f32 and rounded once to the parameter's dtype, as JAX's
    ``apply_updates`` (``repro/optim/base.py:222``) rounds it: an in-place
    add computes in the promoted dtype and casts to the parameter once, so
    a bf16 parameter with an f32 update is not rounded twice."""
    for k, p in params.items():
        p.add_(updates[k])
    return params


# ---------------------------------------------------------------------------
# Gradient accumulation (multi-step) wrapper
# ---------------------------------------------------------------------------


class MultiStepsState(NamedTuple):
    mini_step: torch.Tensor   # int32 0-d
    inner_state: Any
    acc_grads: Any            # {name: f32 running mean of the micro-step gradients}


def multi_steps(inner: GradientTransformation, every_k: int) -> GradientTransformation:
    """Accumulate gradients for ``every_k`` micro-steps, then apply ``inner``
    to their mean. Between applications the updates are zeros, so the caller
    can apply them every micro-step.

    Unlike the rest of this module the update reads the device counter
    ``mini_step`` to the host once per call, to choose between the two
    branches (the JAX package's ``lax.cond``). The port's entry points do
    not use it: the train step accumulates microbatches itself
    (``make_train_step(grad_accum=)``)."""

    def init_fn(params):
        device = next(iter(params.values())).device
        return MultiStepsState(mini_step=torch.zeros((), dtype=torch.int32, device=device),
                               inner_state=inner.init(params),
                               acc_grads={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                          for k, p in params.items()})

    def update_fn(updates, state, params=None):
        acc = {k: state.acc_grads[k] + u.float() / every_k for k, u in updates.items()}
        if int(state.mini_step) == every_k - 1:
            out, inner_state = inner.update(acc, state.inner_state, params)
            acc = {k: torch.zeros_like(a) for k, a in acc.items()}
        else:
            out, inner_state = {k: torch.zeros_like(a) for k, a in acc.items()}, state.inner_state
        return out, MultiStepsState(mini_step=(state.mini_step + 1) % every_k, inner_state=inner_state,
                                    acc_grads=acc)

    return GradientTransformation(init_fn, update_fn)
