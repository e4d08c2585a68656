"""Cross entropy with an f32 logsumexp, for causal LMs and encoders (port of
``repro/train/loss.py``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, z_coef: float = 0.0) -> torch.Tensor:
    """Token-mean CE. logits: (B, S, V) any dtype; labels: (B, S) int.
    Computed in f32; ``z_coef`` adds a z-loss on the logsumexp's magnitude
    (0 by default: the paper does not use it)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_coef:
        loss = loss + z_coef * torch.mean(torch.square(lse))
    return loss


def lm_loss(cfg, params, batch: Dict[str, torch.Tensor],
            forward_fn) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + CE (+ aux). Labels are the next-token ids from the data for
    a causal LM, per-position targets for an encoder. Where the forward
    prepends frontend embeddings (a VLM), only the last ``labels.shape[1]``
    positions, the text, are scored. A classifier's (B, classes) logits take
    (B,) labels (ResNet)."""
    logits, aux = forward_fn(cfg, params, batch)
    labels = batch["labels"]
    if labels.ndim > 1 and logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = cross_entropy(logits, labels)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}
