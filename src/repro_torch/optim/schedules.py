"""Learning-rate schedules (port of ``repro/optim/schedules.py``; paper:
linear warmup -> cosine decay to eta/10).

A schedule maps the step count (an int32 0-d tensor, optimizer state) to a
0-d f32 tensor on the count's device, computed in f32 as the JAX package
computes it. Nothing here reads the count to the host.
"""
from __future__ import annotations

import math

import torch


def constant(value: float):
    def schedule(count):
        return torch.full((), value, dtype=torch.float32, device=count.device)

    return schedule


def linear_warmup(peak: float, warmup_steps: int):
    def schedule(count):
        frac = torch.clamp(count.float() / max(warmup_steps, 1), max=1.0)
        return peak * frac

    return schedule


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    def schedule(count):
        frac = torch.clamp(count.float() / max(decay_steps, 1), 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, end_value: float | None = None):
    """The paper's schedule: linear 0 -> peak over warmup, cosine to peak/10.

    ``end_value`` defaults to peak / 10 per the paper (eta_min = eta / 10).
    """
    if end_value is None:
        end_value = peak / 10.0
    alpha = end_value / peak if peak > 0 else 0.0
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(count):
        count_f = count.float()
        warm = peak * torch.clamp(count_f / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((count_f - warmup_steps) / decay_steps, 0.0, 1.0)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        decayed = peak * ((1 - alpha) * cosine + alpha)
        return torch.where(count_f < warmup_steps, warm, decayed)

    return schedule
