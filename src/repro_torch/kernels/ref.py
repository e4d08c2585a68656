"""Plain oracles of the parameter-writing steps and the plain line stats,
and the O(kept) finalisation and cross-shard algebra shared by the SNR
paths (port of ``repro/kernels/ref.py``). The kernels' plain twins, which
follow each kernel's operation order, live beside their wrappers
(``fused_adam.py``, ``megaplan.py``, ``slim_update.py``, ``snr_stats.py``,
``ssm_scan.py``); these follow the optimizer's formulas, as the JAX ones
do."""
from __future__ import annotations

from typing import Tuple

import torch


def adam_update_ref(p, g, m, v, *, lr: float, b1: float, b2: float, eps: float, wd: float, count: int):
    """Dense fused AdamW step (``repro/kernels/ref.py:13``): returns
    (p', m', v'), f32 state, p' in p's dtype. The bias corrections are
    Python floats, as the JAX oracle computes them."""
    g32 = g.float()
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * torch.square(g32)
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if wd:
        update = update + wd * p.float()
    return (p.float() - lr * update).to(p.dtype), m_new, v_new


def slim_update_ref(p, g, m, v_row, *, lr: float, b1: float, b2: float, eps: float, wd: float, count: int):
    """SlimAdam step with the second moment compressed along axis 1
    (``repro/kernels/ref.py:28``): p, g, m (R, C); v_row (R, 1).
    V <- b2 V + (1 - b2) mean_C[g^2], broadcast in the preconditioner."""
    g32 = g.float()
    m_new = b1 * m + (1 - b1) * g32
    ek = torch.mean(torch.square(g32), dim=1, keepdim=True)
    v_new = b2 * v_row + (1 - b2) * ek
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if wd:
        update = update + wd * p.float()
    return (p.float() - lr * update).to(p.dtype), m_new, v_new


def snr_stats_ref(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (sum, sum of squares) over axis 1 (``repro/kernels/ref.py:48``)."""
    v32 = v.float()
    return torch.sum(v32, dim=1), torch.sum(torch.square(v32), dim=1)


def snr_from_stats(s1: torch.Tensor, s2: torch.Tensor, n: int, eps: float = 1e-30) -> torch.Tensor:
    """The SNR from raw line sums (``repro/kernels/ref.py:57``): the mean
    over lines of mean^2 / var, with mean = s1 / n and var = s2 / n -
    mean^2 (uncentered, so it cancels where the mean is large against the
    spread; :func:`snr_from_centered_stats` finalizes the shifted sums)."""
    mean = s1 / n
    var = s2 / n - torch.square(mean)
    return torch.mean(torch.square(mean) / (torch.clamp(var, min=0.0) + eps))


def snr_from_centered_stats(s1: torch.Tensor, s1c: torch.Tensor, s2c: torch.Tensor,
                            n: int, eps: float = 1e-30) -> torch.Tensor:
    """Finalize centered line stats into each line's mean^2 / var: variance
    from the shifted sums (shift-invariant, no magnitude-scale
    cancellation), mean from the raw sum. The scalar SNR is the mean of
    these ratios; the JAX original returns that mean directly."""
    mean = s1 / n
    mean_c = s1c / n
    var = s2c / n - torch.square(mean_c)
    return torch.square(mean) / (torch.clamp(var, min=0.0) + eps)


def snr_stats_centered_partial_ref(v: torch.Tensor, dims: Tuple[int, ...]):
    """Per-line (sum, shifted sum, shifted sumsq, first entry) over any
    reduction ``dims``, keepdims layout: the plain math the sharded SNR
    paths use where no kernel serves a shard (``repro/kernels/ref.py:73``).
    Differences round in f32; the sums run in f64, as the kernels' do."""
    v32 = v.float()
    dset = sorted({d % v32.ndim for d in dims})
    first = v32
    for d in dset:
        first = first.narrow(d, 0, 1)
    diff = (v32 - first).double()
    return (v32.double().sum(dim=dset, keepdim=True).float(), diff.sum(dim=dset, keepdim=True).float(),
            (diff * diff).sum(dim=dset, keepdim=True).float(), first)


def rebase_centered_stats(s1c: torch.Tensor, s2c: torch.Tensor, first: torch.Tensor, shift: torch.Tensor,
                          n: int):
    """Re-express one shard's centered sums (local shift ``first``) under a
    common ``shift`` (``repro/kernels/ref.py:89``):

        s1c' = s1c + n * (first - shift)
        s2c' = s2c + 2 * (first - shift) * s1c + n * (first - shift)^2

    Exact algebra whose terms stay O(spread) (``first - shift`` is a
    difference of near-equal line entries), so after rebasing the sums of a
    line's shards simply add across ranks."""
    d = first - shift
    return s1c + n * d, s2c + 2.0 * d * s1c + n * d * d
