"""Cross entropy with an f32 logsumexp, for causal LMs and encoders (port of
``repro/train/loss.py``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..sharding import logical


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, z_coef: float = 0.0,
                  denom: Optional[float] = None) -> torch.Tensor:
    """Token-mean CE. logits: (B, S, V) any dtype; labels: (B, S) int.
    Computed in f32; ``z_coef`` adds a z-loss on the logsumexp's magnitude
    (0 by default: the paper does not use it). ``denom`` divides the sum
    of the tokens' losses in place of their count (a rank's share of a
    mean over the mesh)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(lse - gold) if denom is None else torch.sum(lse - gold) / denom
    if z_coef:
        loss = loss + z_coef * torch.mean(torch.square(lse))
    return loss


def _own_positions(cfg, logits: torch.Tensor, labels: torch.Tensor, lay):
    """On a process mesh with ``tp`` model ranks: (this rank's logits,
    their labels, the denominator) over the positions the rank owns, the
    text ones where a VLM prepends frontend positions. ``logits`` are those
    of the whole sequence, or already of the owned part (the forward's
    sequence-parallel layout)."""
    s_text = labels.shape[1]
    total = s_text + (getattr(cfg, "extra_embed_len", 0) if getattr(cfg, "embed_inputs", True) else 0)
    start, n_own = lay.own(total)
    if logits.shape[1] == total:
        logits = logits.narrow(1, start, n_own)
    elif logits.shape[1] != n_own:
        raise ValueError(f"logits over {logits.shape[1]} positions: neither the {total} of the sequence nor the "
                         f"{n_own} this rank owns")
    text0 = total - s_text
    lo, hi = max(start, text0), start + n_own
    hi = max(hi, lo)
    return (logits.narrow(1, lo - start, hi - lo), labels.narrow(1, lo - text0, hi - lo),
            labels.shape[0] * s_text / lay.tp)


def lm_loss(cfg, params, batch: Dict[str, torch.Tensor],
            forward_fn) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + CE (+ aux). Labels are the next-token ids from the data for
    a causal LM, per-position targets for an encoder. Where the forward
    prepends frontend embeddings (a VLM), only the last ``labels.shape[1]``
    positions, the text, are scored. A classifier's (B, classes) logits take
    (B,) labels (ResNet).

    On a process mesh with a ``model`` axis each rank scores the positions
    it owns (``logical.Layout.own``) and divides by its share of the mesh's
    tokens, so the mean of the ranks' losses is the global token mean and
    a position the model group computes alike reaches it once."""
    logits, aux = forward_fn(cfg, params, batch)
    labels = batch["labels"]
    lay = logical.capture_layout()
    if labels.ndim > 1 and lay.tp > 1:
        logits, labels, denom = _own_positions(cfg, logits, labels, lay)
        ce = cross_entropy(logits, labels, denom=denom)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}
    if labels.ndim > 1 and logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = cross_entropy(logits, labels)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}
