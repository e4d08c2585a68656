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
logical``), each rank owning a contiguous part of the sequence. Parameters
stay whole on every rank; a parallel region computes with this rank's
slice of a weight (a narrow), so a rank's gradient holds what its own
computations contributed.

The gradient convention. Each rank's loss is its share of the global
token mean over the positions it owns (``repro_torch.train.loss.lm_loss``),
so the global loss is the mean of the ranks' losses. Every collective's
backward is its transpose (all-gather and reduce-scatter each other's,
psum its own), so the backward of each rank's loss delivers to every rank
the gradient of the *sum* of the ranks' losses with respect to what it
computed; a value a model group computes alike reaches the loss only
through each rank's own positions, so it is counted once. One all-reduce
over every axis, divided by the number of ranks, then gives each rank the
gradient of the global loss, and the metrics' mean; the sharded optimizer
(built with the same mesh) updates its shards and returns whole updates,
and every rank applies the same step.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models import transformer
from ..models.common import ParamModel
from ..optim.base import GradientTransformation, apply_updates, global_norm
from ..sharding.logical import batch_axes
from .loss import lm_loss

# The gradient all-reduce's bucket (f32 elements): bounds the extra device
# memory of averaging a model's gradients to two buckets.
AVERAGE_BUCKET = 1 << 26


def make_train_step(model: ParamModel, tx: GradientTransformation, *, forward_fn=None, grad_accum: int = 1,
                    guard: bool = False, mesh=None) -> Callable:
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
    ``{'lr_scale': float, 'grad_scale': float}``: the gradients are
    multiplied by ``grad_scale`` and the updates by ``lr_scale``. The step
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
    same on every rank."""
    params = model.params
    compute_grads = make_grad_fn(model, forward_fn=forward_fn, grad_accum=grad_accum, mesh=mesh)

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        grads, metrics = compute_grads(batch)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            apply_updates(params, updates)
            metrics["grad_norm"] = global_norm(grads)
        return opt_state, metrics

    def guarded_train_step(opt_state, batch: Dict[str, torch.Tensor], controls: Dict[str, float]):
        from .guard import find_step_health, strip_step_health

        grads, metrics = compute_grads(batch)
        with torch.no_grad():
            g_scale = float(controls["grad_scale"])
            if g_scale != 1.0:
                grads = {k: g * g_scale for k, g in grads.items()}
            updates, new_state = tx.update(grads, opt_state, params)
            gn = global_norm(grads)
            health = find_step_health(new_state)
            if health is not None:
                bad_t, nonfinite, health_gn = health.bad, health.nonfinite.double().sum(), health.grad_norm
            else:
                bad_t = ~torch.isfinite(gn)
                nonfinite, health_gn = bad_t.double(), gn
            bad = bool(bad_t)
            if not bad:
                lr_scale = float(controls["lr_scale"])
                if lr_scale != 1.0:
                    updates = {k: u * lr_scale for k, u in updates.items()}
                apply_updates(params, updates)
                opt_state = strip_step_health(new_state)
            metrics.update(grad_norm=gn, nonfinite_count=nonfinite, health_grad_norm=health_gn,
                           step_skipped=torch.tensor(float(bad)))
        return opt_state, metrics

    return guarded_train_step if guard else train_step


def make_grad_fn(model: ParamModel, *, forward_fn=None, grad_accum: int = 1, mesh=None) -> Callable:
    """``grad_fn(batch) -> (grads {name: tensor}, metrics)``: the gradients
    and metrics a train step hands its optimizer (see
    :func:`make_train_step` for ``grad_accum`` and ``mesh``): on a mesh,
    this rank's rows through the forward and the backward, then averaged
    over every rank, so each rank returns the global batch's gradients."""
    fwd = forward_fn or transformer.forward
    params = model.params
    names = list(params)
    leaves = list(params.values())
    ranks = mesh.size if mesh is not None else 1

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

    def average(grads, metrics):
        """All-reduces over every mesh axis, in buckets of at most
        ``AVERAGE_BUCKET`` f32 elements: the mean of the ranks' gradients
        and metrics."""
        if ranks == 1:
            return grads, metrics
        keys = list(metrics)
        flat = [g.reshape(-1) for g in grads] + [metrics[k].float().reshape(1) for k in keys]
        out, bucket, size = [], [], 0
        for i, t in enumerate(flat):
            bucket.append(t)
            size += t.numel()
            if size >= AVERAGE_BUCKET or i == len(flat) - 1:
                summed = mesh.psum(torch.cat([b.float() for b in bucket]), tuple(mesh.shape)) / ranks
                out.extend(summed.split([b.numel() for b in bucket]))
                bucket, size = [], 0
        grads = [x.reshape(g.shape).to(g.dtype) for x, g in zip(out, grads)]
        return grads, {k: x.reshape(()) for k, x in zip(keys, out[len(grads):])}

    def grads_of(batch):
        loss, metrics = lm_loss(model.cfg, params, batch, fwd)
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
    (:func:`repro_torch.models.transformer.decode_step`)."""

    def serve_step(params: Dict[str, torch.Tensor], cache: transformer.DecodeCache, tokens: torch.Tensor):
        logits, new_cache = transformer.decode_step(cfg, params, cache, tokens)
        next_tokens = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        return next_tokens, logits, new_cache

    return serve_step
