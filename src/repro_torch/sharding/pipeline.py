"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis (port of
``repro/sharding/pipeline.py``).

Schedule: synchronous GPipe, as the JAX function runs it. M microbatches
flow through P stages in M + P - 1 ticks; at tick t stage 0 takes
microbatch t (zeros once t >= M), every other stage the activation the
previous stage handed over at tick t - 1, every stage runs ``stage_fn`` and
hands its result to the next stage by a ``ppermute`` (but at the last tick,
whose handoff no stage would take); the last stage emits microbatch
t - (P - 1). A psum over the axis then gives every stage the
last stage's outputs. The bubble fraction is (P - 1) / (M + P - 1).

Each rank of a ``repro_torch.launch.mesh.Mesh`` is one stage and holds the
stage parameters whole (leading stage dim P), computing with its own stage's
slice; the schedule is differentiable through the mesh's collectives
(``repro_torch.launch.mesh``), whose backward is their transpose. Since the
psum hands every stage the same outputs, a loss computed on every stage is
counted P times in the sum over ranks: divide it by P (or compute it on one
stage) and the stage-parameter gradients, summed over the ranks, are those
of :func:`sequential_reference`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..launch.mesh import Mesh, axis_index, ppermute, psum


def _stage(params: Dict[str, Any], i: int):
    if isinstance(params, dict):
        return {k: _stage(v, i) for k, v in params.items()}
    return params[i]


def gpipe(stage_fn: Callable, stage_params, x_micro: torch.Tensor, *, mesh: Mesh, axis: str = "pipe"):
    """Run ``stage_fn(params_i, x)`` as a P-stage pipeline on the ranks of
    ``axis``. ``stage_params``: a dict (nested allowed) of tensors with a
    leading stage dim (P, ...); ``x_micro``: (M, micro_batch, ...), whole on
    every rank. Returns the final stage's (M, micro_batch, ...) outputs on
    every rank."""
    n_stages = mesh.shape[axis]
    m = x_micro.shape[0]
    idx = axis_index(mesh, axis)
    params_i = _stage(stage_params, idx)
    zero = torch.zeros_like(x_micro[0])
    first = torch.tensor(idx == 0, device=x_micro.device)
    last = torch.tensor(idx == n_stages - 1, device=x_micro.device)
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    buf = zero
    outs = []
    for t in range(m + n_stages - 1):
        # every stage computes the same graph (the selections are
        # elementwise, as JAX's where), so every rank's backward reissues
        # the handoffs in the same order
        act = stage_fn(params_i, torch.where(first, x_micro[t] if t < m else zero, buf))
        if t < m + n_stages - 2:    # the last tick's handoff has no taker
            buf = ppermute(act, mesh, axis, perm)
        if t >= n_stages - 1:
            outs.append(act)
    return psum(torch.where(last, torch.stack(outs), 0.0), mesh, axis)


def sequential_reference(stage_fn: Callable, stage_params, x_micro: torch.Tensor) -> torch.Tensor:
    """Oracle: the P stages in sequence on each microbatch."""
    first = stage_params
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n_stages = first.shape[0]
    outs = []
    for x in x_micro:
        for i in range(n_stages):
            x = stage_fn(_stage(stage_params, i), x)
        outs.append(x)
    return torch.stack(outs)
