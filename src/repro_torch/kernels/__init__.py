"""The port's kernels (CUDA C++ for sm_90a, built on first use by
``build.py``) with their plain PyTorch twins, and the canonical-layout and
megaplan logic around them: the optimizer and SNR kernels of training (the
megaplan group kernels and their per-leaf forms, the sharded psum pair and
partial SNR stats of the sharded trainer, and the parameter-writing AdamW
and SlimAdam steps with the plain line stats), the paged attention of
serving and the selective scan of the Mamba layers, forward and backward."""
from __future__ import annotations

from typing import Dict

from .fused_adam import adam_precond
# Bound under other names, so ``kernels.fused_adam``, ``kernels.paged_attention``
# and ``kernels.ssm_scan`` stay the modules.
from .fused_adam import fused_adam as _fused_adam
from .megaplan import (mega_adam_update, mega_slim_finalize_batched, mega_slim_partial_stats_batched,
                       mega_slim_update_batched)
from .paged_attention import PAGED_ATTN_BUFS, paged_fits
from .paged_attention import paged_attention as _paged_attention
from .slim_update import (slim_finalize_batched, slim_partial_stats_batched, slim_precond_batched,
                          slim_update_batched)
from .snr_stats import snr_stats_batched, snr_stats_centered_batched, snr_stats_centered_partial_batched
from .ssm_scan import ssm_scan as _ssm_scan, ssm_scan_bwd

KERNELS = (mega_adam_update, mega_slim_update_batched, adam_precond, slim_precond_batched,
           snr_stats_centered_batched, _paged_attention, snr_stats_centered_partial_batched,
           slim_partial_stats_batched, slim_finalize_batched, mega_slim_partial_stats_batched,
           mega_slim_finalize_batched, _fused_adam, slim_update_batched, snr_stats_batched, _ssm_scan, ssm_scan_bwd)


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's counters: its launches and its dry-run
    calls on ``meta``."""
    for fn in KERNELS:
        fn.launches = 0
        fn.meta_calls = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by wrapper name."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def meta_call_counts() -> Dict[str, int]:
    """Calls on ``meta`` tensors since the last reset, by wrapper name: the
    launches a dry run predicts, each counted where the card would launch
    (:func:`build.on_meta`)."""
    return {fn.__name__: fn.meta_calls for fn in KERNELS}


reset_launch_counts()
