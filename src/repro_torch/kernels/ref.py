"""O(kept) finalisation shared by the SNR paths (port of the part of
``repro/kernels/ref.py`` the main path uses). The kernels' plain twins live
beside their wrappers (``megaplan.py``, ``snr_stats.py``)."""
from __future__ import annotations

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
