"""Two-layer linear LM (paper §4.1 / App. B.2): embedding + linear head
(port of ``repro/models/linear_lm.py``).

The smallest model where the token-dimension incompressibility mechanism
shows; ``benchmarks/vocab_tail.py`` sweeps its vocabulary size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .common import ParamModel, ParamSpec, init_params, meta_tree


def _truncated_normal(std: float):
    """N(0, std^2) truncated to +-2 standard deviations."""
    def init(gen, shape, dtype):
        t = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * std).to(dtype)

    return init


@dataclasses.dataclass(frozen=True)
class LinearLMConfig:
    vocab_size: int
    d_model: int = 768

    def specs(self):
        return {
            "embed": ParamSpec((self.vocab_size, self.d_model), ("vocab", "embed"), "token_embedding",
                               _truncated_normal(1.0), fan_in=("vocab",), fan_out=("embed",)),
            "head": ParamSpec((self.d_model, self.vocab_size), ("embed", "vocab"), "lm_head",
                              _truncated_normal(self.d_model ** -0.5), fan_in=("embed",), fan_out=("vocab",)),
        }

    def init(self, gen: torch.Generator, device):
        spec = self.specs()
        return init_params(spec, gen, device), meta_tree(spec)


def forward(cfg: LinearLMConfig, params, batch: Dict[str, torch.Tensor]):
    """batch['tokens']: (B, S) -> (logits (B, S, vocab), aux = 0)."""
    x = params["embed"][batch["tokens"].long()]
    logits = torch.einsum("bsd,dv->bsv", x, params["head"])
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


class LinearLM(ParamModel):
    """The linear LM's parameters as an ``nn.Module`` (see
    :class:`repro_torch.models.common.ParamModel`)."""

    def forward(self, batch: Dict[str, torch.Tensor]):
        return forward(self.cfg, self.params, batch)
