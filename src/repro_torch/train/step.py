"""Train step factory (port of ``repro/train/step.py``, the plain step with
``grad_accum=1``).

    train_step(opt_state, batch) -> (opt_state, metrics)

Gradients come from autograd through the model's forward; the optimizer
update runs under ``no_grad`` and the parameters are updated in place. The
metrics stay device tensors: nothing in the step waits for the device.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models import transformer
from ..optim.base import GradientTransformation, apply_updates, global_norm
from .loss import lm_loss


def make_train_step(model: transformer.Transformer, tx: GradientTransformation) -> Callable:
    params = model.params

    def train_step(opt_state, batch: Dict[str, torch.Tensor]):
        loss, metrics = lm_loss(model.cfg, params, batch, transformer.forward)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            apply_updates(params, updates)
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["grad_norm"] = global_norm(grads)
        return opt_state, metrics

    return train_step
