"""The port's kernels (CUDA C++ for sm_90a, built on first use by
``build.py``) with their plain PyTorch twins, and the canonical-layout and
megaplan logic around them: the optimizer and SNR kernels of training (the
megaplan group kernels and their per-leaf forms, and the sharded psum pair
and partial SNR stats of the sharded trainer) and the paged attention of
serving."""
from __future__ import annotations

from typing import Dict

from .fused_adam import adam_precond
from .megaplan import (mega_adam_update, mega_slim_finalize_batched, mega_slim_partial_stats_batched,
                       mega_slim_update_batched)
# Bound under another name, so ``kernels.paged_attention`` stays the module.
from .paged_attention import paged_attention as _paged_attention
from .slim_update import slim_finalize_batched, slim_partial_stats_batched, slim_precond_batched
from .snr_stats import snr_stats_centered_batched, snr_stats_centered_partial_batched

KERNELS = (mega_adam_update, mega_slim_update_batched, adam_precond, slim_precond_batched,
           snr_stats_centered_batched, _paged_attention, snr_stats_centered_partial_batched,
           slim_partial_stats_batched, slim_finalize_batched, mega_slim_partial_stats_batched,
           mega_slim_finalize_batched)


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counter."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by wrapper name."""
    return {fn.__name__: fn.launches for fn in KERNELS}
