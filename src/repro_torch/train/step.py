"""Train and eval step factories (port of ``repro/train/step.py``).

    train_step(opt_state, batch) -> (opt_state, metrics)
    guarded_train_step(opt_state, batch, controls) -> (opt_state, metrics)
    eval_step(batch) -> metrics
    serve_step(params, cache, tokens) -> (next_tokens, logits, cache)

Gradients come from autograd through the model's forward; the optimizer
update runs under ``no_grad`` and the parameters are updated in place. The
plain step's metrics stay device tensors: nothing in it waits for the
device. The guarded step reads one flag (the step's health) to the host.

On a mesh (``mesh=``, a ``repro_torch.launch.mesh.Mesh``) the global batch's
rows split over the batch axes (``pod``, ``data``), as the JAX package's
``batch`` rule splits them: the ranks of one model group share rows, and
under a sharding context on the same mesh the forward runs tensor-,
sequence- and expert-parallel over ``model`` (``repro_torch.sharding.
logical``), each rank owning a contiguous part of the sequence. Two ways
to store the parameters:

* whole on every rank (the whole-parameter path, ``Trainer``'s): a parallel
  region computes with this rank's slice of a weight (a narrow), so a
  rank's gradient holds what its own computations contributed;
* as this rank's shards (``grad_shardings=``, the parameters' NamedShardings:
  parameter-shard storage, as ``repro/launch/train.py`` stores them): the
  forward reads them as ``logical.Weights``, and a region gathers what its
  slice lacks over the axes it does not own (``logical.weight``), whose
  backward reduce-scatters the gradient onto the shard.

The gradient convention. Each rank's loss is its share of the global
token mean over the positions it owns (``repro_torch.train.loss.lm_loss``),
so the global loss is the mean of the ranks' losses. Every collective's
backward is its transpose (all-gather and reduce-scatter each other's,
psum its own), so the backward of each rank's loss delivers to every rank
the gradient of the *sum* of the ranks' losses with respect to what it
computed; a value a model group computes alike reaches the loss only
through each rank's own positions, so it is counted once. Whole
parameters: one all-reduce over every axis, divided by the number of
ranks, gives each rank the gradient of the global loss, and the metrics'
mean; the sharded optimizer (built with the same mesh) updates its shards
and returns whole updates, and every rank applies the same step. Shards:
each gradient shard already sums the contributions of the ranks its
gathers spanned; an all-reduce over the axes its spec does not use
completes it, and one division by the number of ranks keeps the
convention. The whole averaged gradient is never formed; the optimizer
(built with ``param_shards=True``) returns this rank's update shards, and
the gradient norm is completed across the mesh.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models import transformer
from ..models.common import ParamModel
from ..optim.base import GradientTransformation, apply_updates, global_norm
from ..sharding.logical import Weights, batch_axes
from ..sharding.shardspec import spec_entries
from .loss import lm_loss

# The gradient all-reduce's bucket (f32 elements): bounds the extra device
# memory of averaging a model's gradients to two buckets.
AVERAGE_BUCKET = 1 << 26


def scale_by_control(tree: Dict[str, torch.Tensor], value) -> Dict[str, torch.Tensor]:
    """``tree`` times a guard control, as the JAX step applies one
    (``repro/train/step.py:104-108``): the control rounded to f32, then to
    each tensor's dtype, and one multiply in that dtype (a bf16 update is
    scaled by bf16(0.05), not by 0.05). A control of exactly 1 changes no
    bit, so it multiplies nothing."""
    c32 = torch.tensor(float(value), dtype=torch.float32)
    if float(c32) == 1.0:
        return tree
    by_dtype: Dict[torch.dtype, torch.Tensor] = {}
    return {k: t * by_dtype.setdefault(t.dtype, c32.to(t.dtype)) for k, t in tree.items()}


def make_train_step(model: ParamModel, tx: GradientTransformation, *, forward_fn=None, grad_accum: int = 1,
                    guard: bool = False, mesh=None, grad_shardings=None) -> Callable:
    """One optimizer step over ``model``'s parameters. ``forward_fn(cfg,
    params, batch) -> (logits, aux)`` defaults to the decoder's
    (``repro_torch.models.linear_lm.forward`` and
    ``repro_torch.models.resnet.forward`` train the paper's probes).

    With ``grad_accum > 1`` the batch is split into ``grad_accum``
    microbatches along its leading dim; their gradients accumulate in f32 as
    ``acc + g / grad_accum`` in microbatch order (the paper's micro-batch
    recipe), and each metric is the mean over the microbatches.

    ``guard=True`` returns the fault-tolerant variant
    ``train_step(opt_state, batch, controls)``, ``controls`` being
    ``{'lr_scale': float, 'grad_scale': float}`` (``Guard.controls``): the
    gradients are multiplied by ``grad_scale`` and the updates by
    ``lr_scale``, each rounded as the JAX step rounds it
    (:func:`scale_by_control`). The step
    reads the in-pass :class:`repro_torch.optim.fused.StepHealth` the
    optimizer published (build ``tx`` with ``emit_health=True``; without it
    the finiteness of the gradient norm decides). A bad step applies no
    update and keeps the old optimizer state, so parameters, moments and
    count stay bit-identical: the update is computed into new tensors and
    committed only when the step is good. Extra metrics:
    ``nonfinite_count`` (f64, exact), ``step_skipped``, ``health_grad_norm``. The
    returned state never carries ``health``; a from-update SNR snapshot
    rides on it for the trainer to consume (dropped on a bad step).

    ``mesh``: the rows split over the mesh's batch axes and the gradients
    averaged over every rank (see the module docstring); the batch's leading
    dim must split evenly over the batch axes. The guarded step's skip
    decision then comes from health completed across ranks, so it is the
    same on every rank.

    ``grad_shardings`` (``{name: NamedSharding}``, JAX's argument of the
    same name): ``model.params`` are this rank's shards under those specs,
    each gradient arrives as this rank's shard of its spec, ``tx`` must be
    built with ``param_shards=True``, and the updates are written into the
    shards in place (see the module docstring); ``mesh`` defaults to the
    shardings' mesh. ``grad_norm`` is completed across the mesh."""
    params = model.params
    if grad_shardings is not None and mesh is None:
        mesh = next(iter(grad_shardings.values())).mesh
    compute_grads = make_grad_fn(model, forward_fn=forward_fn, grad_accum=grad_accum, mesh=mesh,
                                 grad_shardings=grad_shardings)
    specs = {k: s.spec for k, s in grad_shardings.items()} if grad_shardings is not None else None
    norm = lambda grads: global_norm(grads, **(dict(mesh=mesh, specs=specs) if specs else {}))   # noqa: E731

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        grads, metrics = compute_grads(batch)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            apply_updates(params, updates)
            metrics["grad_norm"] = norm(grads)
        return opt_state, metrics

    def guarded_train_step(opt_state, batch: Dict[str, torch.Tensor], controls: Dict[str, float]):
        from .guard import find_step_health, strip_step_health

        grads, metrics = compute_grads(batch)
        with torch.no_grad():
            grads = scale_by_control(grads, controls["grad_scale"])
            updates, new_state = tx.update(grads, opt_state, params)
            gn = norm(grads)
            health = find_step_health(new_state)
            if health is not None:
                bad_t, nonfinite, health_gn = health.bad, health.nonfinite.double().sum(), health.grad_norm
            else:
                bad_t = ~torch.isfinite(gn)
                nonfinite, health_gn = bad_t.double(), gn
            bad = bool(bad_t)
            if not bad:
                apply_updates(params, scale_by_control(updates, controls["lr_scale"]))
                opt_state = strip_step_health(new_state)
            metrics.update(grad_norm=gn, nonfinite_count=nonfinite, health_grad_norm=health_gn,
                           step_skipped=torch.tensor(float(bad)))
        return opt_state, metrics

    return guarded_train_step if guard else train_step


def make_grad_fn(model: ParamModel, *, forward_fn=None, grad_accum: int = 1, mesh=None,
                 grad_shardings=None) -> Callable:
    """``grad_fn(batch) -> (grads {name: tensor}, metrics)``: the gradients
    and metrics a train step hands its optimizer (see
    :func:`make_train_step` for ``grad_accum``, ``mesh`` and
    ``grad_shardings``): on a mesh, this rank's rows through the forward
    and the backward, then averaged over every rank, so each rank returns
    the global batch's gradients, whole, or with ``grad_shardings`` its
    shards of them."""
    fwd = forward_fn or transformer.forward
    params = model.params
    names = list(params)
    leaves = list(params.values())
    if grad_shardings is not None and mesh is None:
        mesh = next(iter(grad_shardings.values())).mesh
    ranks = mesh.size if mesh is not None else 1
    stored = None
    if grad_shardings is not None:
        stored = Weights(params, {k: grad_shardings[k].spec for k in names}, mesh)

    def local_rows(batch):
        """This rank's rows of the global batch: its block over the batch
        axes."""
        if ranks == 1:
            return batch
        axes = batch_axes(mesh)
        parts = mesh.axis_size(axes)
        if parts == 1:
            return batch
        n = next(iter(batch.values())).shape[0]
        if n % parts:
            raise ValueError(f"batch of {n} rows does not split over the batch axes {axes} ({parts})")
        k = n // parts
        return {key: v.narrow(0, mesh.group_index(axes) * k, k) for key, v in batch.items()}

    def summed(flat, axes):
        """Each tensor of ``flat`` summed over ``axes`` and divided by the
        number of ranks, flat, in f32 all-reduces of at most
        ``AVERAGE_BUCKET`` elements (none without axes)."""
        if not axes:
            return [t.float() / ranks for t in flat]
        out, bucket, size = [], [], 0
        for i, t in enumerate(flat):
            bucket.append(t)
            size += t.numel()
            if size >= AVERAGE_BUCKET or i == len(flat) - 1:
                total = mesh.psum(torch.cat([b.float() for b in bucket]), axes) / ranks
                out.extend(total.split([b.numel() for b in bucket]))
                bucket, size = [], 0
        return out

    def average(grads, metrics):
        """The mean of the ranks' gradients and metrics. Whole gradients:
        all-reduces over every mesh axis. Shards: each leaf's all-reduce
        over the axes its spec does not use (none for a leaf split over
        every axis), leaves grouped by those axes; the metrics in one small
        all-reduce over every axis."""
        if ranks == 1:
            return grads, metrics
        keys = list(metrics)
        every = tuple(mesh.shape)
        scalars = [metrics[k].float().reshape(1) for k in keys]
        if stored is None:
            out = summed([g.reshape(-1) for g in grads] + scalars, every)
        else:
            groups: Dict[tuple, list] = {}
            for i, (k, g) in enumerate(zip(names, grads)):
                used = {a for e in spec_entries(stored.specs[k], g.ndim) for a in e}
                groups.setdefault(tuple(a for a in every if a not in used), []).append(i)
            out = [None] * len(grads)
            for axes, idx in groups.items():
                for i, x in zip(idx, summed([grads[i].reshape(-1) for i in idx], axes)):
                    out[i] = x
            out += summed(scalars, every)
        grads = [x.reshape(g.shape).to(g.dtype) for x, g in zip(out, grads)]
        return grads, {k: x.reshape(()) for k, x in zip(keys, out[len(grads):])}

    def grads_of(batch):
        loss, metrics = lm_loss(model.cfg, stored if stored is not None else params, batch, fwd)
        grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def accumulate(batch):
        if grad_accum == 1:
            return grads_of(batch)
        n = next(iter(batch.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch of {n} rows does not split into {grad_accum} microbatches")
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        per_micro = []
        for micro in zip(*(v.chunk(grad_accum) for v in batch.values())):
            grads, metrics = grads_of(dict(zip(batch, micro)))
            with torch.no_grad():
                acc = [a + g.float() / grad_accum for a, g in zip(acc, grads)]
            per_micro.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean(0) for k in per_micro[0]}
        return acc, metrics

    def grad_fn(batch):
        grads, metrics = accumulate(local_rows(batch))
        grads, metrics = average(grads, metrics)
        return dict(zip(names, grads)), metrics

    return grad_fn


def make_eval_step(model: ParamModel, forward_fn=None) -> Callable:
    """Forward-only metrics of ``model`` on a batch (no gradients)."""
    fwd = forward_fn or transformer.forward

    def eval_step(batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            _, metrics = lm_loss(model.cfg, model.params, batch, fwd)
        return metrics

    return eval_step


def make_serve_step(cfg) -> Callable:
    """One batched decode step: ``(params, cache, tokens (B, 1)) ->
    (next_tokens (B, 1) int32, logits (B, 1, vocab), cache)``, greedy argmax
    as in the JAX package. The cache's tensors are written in place
    (:func:`repro_torch.models.transformer.decode_step`). Under a sharding
    context over a process mesh it runs in JAX's decode layout: ``params``
    this rank's stored shards (``launch.train.stored_weights``) or whole,
    ``cache`` and ``tokens`` this rank's (``init_decode_cache`` under the
    context); the next tokens and the logits are its rows', whole and alike
    on every rank of its model group."""

    def serve_step(params: Dict[str, torch.Tensor], cache: transformer.DecodeCache, tokens: torch.Tensor):
        logits, new_cache = transformer.decode_step(cfg, params, cache, tokens)
        next_tokens = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        return next_tokens, logits, new_cache

    return serve_step
