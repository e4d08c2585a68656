"""Train and eval step factories (port of ``repro/train/step.py``).

    train_step(opt_state, batch) -> (opt_state, metrics)
    guarded_train_step(opt_state, batch, controls) -> (opt_state, metrics)
    eval_step(batch) -> metrics
    serve_step(params, cache, tokens) -> (next_tokens, logits, cache)

Gradients come from autograd through the model's forward; the optimizer
update runs under ``no_grad`` and the parameters are updated in place. The
plain step's metrics stay device tensors: nothing in it waits for the
device. The guarded step reads one flag (the step's health) to the host.

On a mesh (``mesh=``, a ``repro_torch.launch.mesh.Mesh``) each rank runs the
forward and backward on its slice of the global batch and one all-reduce
averages the gradients and the metrics, so every rank holds the same
gradients; a sharded optimizer (built with the same mesh) then updates its
shards and returns whole updates, and every rank applies the same step.
The numbers are the JAX package's sharded step's; only the forward's
layout differs (the JAX package splits the batch over 'data' and the
weights over 'model' inside one program).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models import transformer
from ..models.common import ParamModel
from ..optim.base import GradientTransformation, apply_updates, global_norm
from .loss import lm_loss


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

    ``mesh``: data parallelism over every rank of the mesh (see the module
    docstring); the batch's leading dim must split evenly across them. The
    guarded step's skip decision then comes from health completed across
    ranks, so it is the same on every rank."""
    fwd = forward_fn or transformer.forward
    params = model.params
    names = list(params)
    leaves = list(params.values())
    ranks = mesh.size if mesh is not None else 1

    def local_rows(batch):
        """This rank's slice of the global batch."""
        if ranks == 1:
            return batch
        n = next(iter(batch.values())).shape[0]
        if n % ranks:
            raise ValueError(f"batch of {n} rows does not split across {ranks} ranks")
        k = n // ranks
        return {key: v.narrow(0, mesh.rank * k, k) for key, v in batch.items()}

    def average(grads, metrics):
        """One all-reduce over every mesh axis: the mean of the ranks'
        gradients and metrics."""
        if ranks == 1:
            return grads, metrics
        keys = list(metrics)
        flat = torch.cat([g.float().reshape(-1) for g in grads] + [metrics[k].float().reshape(1) for k in keys])
        flat = mesh.psum(flat, tuple(mesh.shape)) / ranks
        pieces = flat.split([g.numel() for g in grads] + [1] * len(keys))
        grads = [x.reshape(g.shape).to(g.dtype) for x, g in zip(pieces, grads)]
        return grads, {k: x.reshape(()) for k, x in zip(keys, pieces[len(grads):])}

    def grads_of(batch):
        loss, metrics = lm_loss(model.cfg, params, batch, fwd)
        grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def compute_grads(batch):
        grads, metrics = accumulate(local_rows(batch))
        grads, metrics = average(grads, metrics)
        return dict(zip(names, grads)), metrics

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
