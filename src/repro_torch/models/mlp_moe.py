"""Dense MLP block (port of the dense part of ``repro/models/mlp_moe.py``;
MoE is not ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamSpec


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_specs(d_model: int, d_ff: int, *, gated: bool, w_init, down_init):
    specs = {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "mlp_up", w_init,
                          fan_in=("embed",), fan_out=("mlp",)),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "mlp_down", down_init,
                            fan_in=("mlp",), fan_out=("embed",)),
    }
    if gated:
        specs["w_gate"] = ParamSpec((d_model, d_ff), ("embed", "mlp"), "mlp_gate", w_init,
                                    fan_in=("embed",), fan_out=("mlp",))
    return specs


def mlp_forward(p, x: torch.Tensor, *, gated: bool) -> torch.Tensor:
    h = x @ p["w_up"].to(x.dtype)
    if gated:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = gelu(h)
    return h @ p["w_down"].to(x.dtype)
