"""Causal-LM cross entropy with an f32 logsumexp (port of ``repro/train/loss.py``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE. logits: (B, S, V) any dtype; labels: (B, S) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def lm_loss(cfg, params, batch: Dict[str, torch.Tensor],
            forward_fn) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + CE (+ aux). Labels are the next-token ids from the data."""
    logits, aux = forward_fn(cfg, params, batch)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}
