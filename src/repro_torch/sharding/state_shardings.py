"""PartitionSpecs for optimizer states (port of
``repro/sharding/state_shardings.py``).

Optimizer states mirror the parameter dict, so their specs derive from the
parameter specs:

  * full-shape moments (Adam's mu and nu, SlimAdam's mu) take the parameter
    spec;
  * SlimAdam's reduced second moments take the spec with the collapsed
    dims replicated — or, with ``owner_mesh`` (the sharded fused backend),
    the owner-slice storage spec of a psum leaf
    (``repro_torch.sharding.shardspec.owner_placement``);
  * the baselines' full-shape buffers (SGD-M's trace, Lion's and SM3's
    momentum, Adafactor v2's update EMA, ``multi_steps``' accumulators)
    take the parameter spec, Adafactor's row and column statistics the
    entries of the dims they keep, SM3's per-axis accumulators are
    replicated;
  * counts, schedules and the snr / health snapshots are replicated.

``abstract_state`` is a state with global shapes: build it with the
unsharded optimizer on ``device="meta"`` tensors, which allocate nothing.
:func:`shardings_from_specs` turns these specs, and the parameters' own
(``logical.param_specs``, under parameter-shard storage), into the
NamedShardings that checkpoints gather and cut by and that the step takes
as ``grad_shardings`` (``repro_torch.launch.train``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from .shardspec import PartitionSpec as P, plan_sharded_leaf


def _check_mirrors(state: Mapping[str, Any], params: Mapping[str, Any], what: str) -> None:
    if set(state) != set(params):
        hint = ("the spec dict must be derived from the same parameters "
                "(repro_torch.sharding.logical.param_specs)" if what == "param_spec_tree" else
                "the optimizer state must come from tx.init on the same parameters the specs were derived for")
        raise ValueError(f"opt_state_specs: {what} does not mirror the parameter dict "
                         f"({sorted(state)} vs {sorted(params)}): {hint}.")


def _masked_like_params(spec_tree, state_leaves, params, owner_mesh) -> Dict[str, P]:
    """Parameter specs with the entries dropped where the state dim
    collapsed to 1; with ``owner_mesh``, a psum leaf's owner storage spec."""
    out = {}
    for k, spec in spec_tree.items():
        p, s = params[k], state_leaves[k]
        entries = list(spec) + [None] * (p.ndim - len(spec))
        dims = tuple(i for i in range(p.ndim) if s.shape[i] != p.shape[i])
        base = P(*[None if i in dims else entries[i] for i in range(p.ndim)])
        if owner_mesh is not None and dims:
            pl = plan_sharded_leaf(p.shape, p.dtype, dims, spec, owner_mesh)
            if pl.regime == "psum" and pl.owner:
                base = pl.nu_spec
        out[k] = base
    return out


def _masked_like_params_partial(spec_tree, state_leaves, params) -> Dict[str, P]:
    """Adafactor's row and column statistics: fewer dims than the
    parameter, so keep the spec entries of the dims that survive (row
    stats drop the last dim, column stats the second-to-last), matched by
    shape in JAX's order (``repro/sharding/state_shardings.py:171-189``)."""
    out = {}
    for k, spec in spec_tree.items():
        p, s = params[k], state_leaves[k]
        entries = list(spec) + [None] * (p.ndim - len(spec))
        shape, pshape = tuple(s.shape), tuple(p.shape)
        if s.ndim == p.ndim:
            out[k] = P(*entries)
        elif s.ndim == 0:
            out[k] = P()
        elif shape == pshape[:-1]:
            out[k] = P(*entries[:-1])
        elif shape == pshape[:-2] + pshape[-1:]:
            out[k] = P(*(entries[:-2] + entries[-1:]))
        else:
            out[k] = P()
    return out


def _replicated(tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_replicated(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_replicated(v) for v in tree)
    return P()


def opt_state_specs(abstract_state: Any, params_abstract: Mapping[str, Any], param_spec_tree: Mapping[str, P],
                    *, owner_mesh: Any = None) -> Any:
    """PartitionSpec tree matching ``abstract_state``: JAX's walk
    (``repro/sharding/state_shardings.py:138-162``) over every optimizer
    state type.

    ``owner_mesh``: the mesh, when the optimizer runs the sharded fused
    backend — SlimAdam's psum-regime reduced moments then take their
    owner-slice storage specs, the layout the sharded update keeps; leave
    it None for the 'jnp' backend, whose reduced moments keep the masked
    specs. Raises ``ValueError`` when a state dict does not mirror the
    parameters."""
    # the state types import the optimizer, which imports this package
    from ..core.baselines import AdafactorState, LionState, SM3State
    from ..core.slim_adam import ScaleBySlimAdamState
    from ..optim.adam import ScaleByAdamState
    from ..optim.base import ChainState, EmptyState, MultiStepsState, ScaleByScheduleState, TraceState

    _check_mirrors(param_spec_tree, params_abstract, "param_spec_tree")
    like = lambda: dict(param_spec_tree)   # noqa: E731

    def walk(node: Any) -> Any:
        if isinstance(node, ChainState):
            return ChainState(tuple(walk(s) for s in node.inner_states))
        if isinstance(node, ScaleBySlimAdamState):
            if node.mu is not None:
                _check_mirrors(node.mu, params_abstract, "ScaleBySlimAdamState.mu")
            _check_mirrors(node.nu, params_abstract, "ScaleBySlimAdamState.nu")
            return ScaleBySlimAdamState(
                count=P(), mu=like() if node.mu is not None else None,
                nu=_masked_like_params(param_spec_tree, node.nu, params_abstract, owner_mesh),
                snr=_replicated(node.snr), health=_replicated(node.health))
        if isinstance(node, ScaleByAdamState):
            _check_mirrors(node.mu, params_abstract, "ScaleByAdamState.mu")
            _check_mirrors(node.nu, params_abstract, "ScaleByAdamState.nu")
            return ScaleByAdamState(count=P(), mu=like(), nu=like(), health=_replicated(node.health))
        if isinstance(node, TraceState):
            _check_mirrors(node.trace, params_abstract, "TraceState.trace")
            return TraceState(trace=like())
        if isinstance(node, MultiStepsState):
            _check_mirrors(node.acc_grads, params_abstract, "MultiStepsState.acc_grads")
            return MultiStepsState(mini_step=P(), inner_state=walk(node.inner_state), acc_grads=like())
        if isinstance(node, AdafactorState):
            _check_mirrors(node.vr, params_abstract, "AdafactorState.vr")
            _check_mirrors(node.vc, params_abstract, "AdafactorState.vc")
            return AdafactorState(count=P(),
                                  vr=_masked_like_params_partial(param_spec_tree, node.vr, params_abstract),
                                  vc=_masked_like_params_partial(param_spec_tree, node.vc, params_abstract),
                                  mu=like() if node.mu is not None else None)
        if isinstance(node, SM3State):
            return SM3State(accs=_replicated(node.accs), mom=like())
        if isinstance(node, LionState):
            _check_mirrors(node.mu, params_abstract, "LionState.mu")
            return LionState(mu=like())
        if isinstance(node, ScaleByScheduleState):
            return ScaleByScheduleState(count=P())
        if isinstance(node, EmptyState):
            return EmptyState()
        return _replicated(node)

    return walk(abstract_state)


def shardings_from_specs(spec_tree: Any, mesh) -> Any:
    """The spec tree with each :class:`PartitionSpec` leaf turned into a
    ``repro_torch.launch.mesh.NamedSharding`` on ``mesh`` (what
    ``checkpoint.store.restore(..., shardings=)`` and the trainer's
    checkpoint gather read)."""
    from ..launch.mesh import NamedSharding

    def walk(node):
        if node is None:
            return None
        if isinstance(node, P):
            return NamedSharding(mesh, node)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f)) for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"shardings_from_specs: unexpected node {type(node).__name__}")

    return walk(spec_tree)
