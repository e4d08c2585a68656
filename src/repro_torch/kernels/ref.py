"""O(kept) finalisation and cross-shard algebra shared by the SNR paths
(port of the part of ``repro/kernels/ref.py`` the main path uses). The
kernels' plain twins live beside their wrappers (``megaplan.py``,
``slim_update.py``, ``snr_stats.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


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
