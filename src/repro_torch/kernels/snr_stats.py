"""One-pass centered line statistics for the SNR analysis (port of
``repro/kernels/snr_stats.py`` ``snr_stats_centered_batched``).

Kernel: ``csrc/snr_stats.cu`` replaces the Pallas kernel at
``repro/kernels/snr_stats.py:133`` (body ``_snr_centered_kernel`` :81,
``pallas_call`` in ``_stats_call`` :116). It is bound by bytes: one 4-byte
read per element, 12 bytes written per line. The source note there says how
the design follows from that.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

_ARGTYPES = [build.PTR] * 4 + [build.SIZE] * 3 + [build.INT, build.PTR]
_MAX_GRID_Y = 65535
_MAX_GRID_X = 2**31 - 1


def snr_stats_centered_batched_plain(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: per line (s1, s1c, s2c), each (B, kept).
    The shift v0 is the line's first entry; differences round in f32 as the
    TPU kernel rounds them, the sums run in f64 as the CUDA kernel's do."""
    red = 2 if axis == 1 else 1
    first = v.narrow(red, 0, 1)
    d = (v - first).double()
    return (v.double().sum(red).float(), d.sum(red).float(), (d * d).sum(red).float())


def snr_stats_centered_batched(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, ...]:
    """v: (B, R, C) f32 -> (line_sum, shifted_line_sum, shifted_line_sumsq),
    each (B, kept), kept = R for ``axis=1`` and C for ``axis=0``. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if v.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"snr_stats_centered_batched: want a (B, R, C) tensor and axis 0|1, "
                         f"got shape {tuple(v.shape)}, axis {axis}")
    device = build.check_operands("snr_stats_centered_batched", v=v)
    if device.type == "cpu":
        return snr_stats_centered_batched_plain(v, axis=axis)
    b, r, c = v.shape
    kept = r if axis == 1 else c
    if v.numel() == 0:
        raise ValueError("snr_stats_centered_batched: empty lines have no statistics")
    if (axis == 1 and b * r > _MAX_GRID_X) or (axis == 0 and b > _MAX_GRID_Y):
        raise ValueError(f"snr_stats_centered_batched: shape {tuple(v.shape)} exceeds the launch grid")
    outs = tuple(torch.empty((b, kept), dtype=torch.float32, device=device) for _ in range(3))
    fn = build.entry("repro_snr_stats_centered", _ARGTYPES)
    build.launch("snr_stats_centered_batched", fn, device, v.data_ptr(),
                 *(o.data_ptr() for o in outs), b, r, c, axis)
    snr_stats_centered_batched.launches += 1
    return outs


snr_stats_centered_batched.launches = 0
