"""One-pass centered line statistics for the SNR analysis (port of
``repro/kernels/snr_stats.py``: ``snr_stats_centered_batched``, and the
plain helpers ``centered_line_stats`` and ``snr_update_stats_finalize`` of
the from-update SNR).

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


def centered_line_stats(x: torch.Tensor, red: int):
    """Per-line (s1c, s2c, first) of ``x`` shifted by each line's first
    entry, keepdims along ``red``: differences rounded in f32 as the TPU
    kernel rounds them, sums in f64 as the CUDA kernels accumulate them.
    The plain version of the ``with_snr`` line outputs of the slim update
    kernels (applied to g^2); the centering makes both sums O(spread)
    rather than O(magnitude)."""
    first = x.narrow(red, 0, 1)
    d = (x - first).double()
    return d.sum(dim=red, keepdim=True).float(), (d * d).sum(dim=red, keepdim=True).float(), first


def snr_update_stats_finalize(v_new: torch.Tensor, s1c: torch.Tensor, s2c: torch.Tensor, n: int,
                              one_minus_b2: float, eps: float = 1e-30) -> torch.Tensor:
    """The from-update SNR of one leaf (0-d tensor), O(kept) plain torch
    (``repro/kernels/snr_stats.py:55-72``).

    ``s1c``/``s2c`` are the centered line sums of g^2 along the leaf's
    compression dims K (the update kernels' ``with_snr`` outputs), ``v_new``
    the updated reduced moment, all of one layout. The measured quantity is
    SNR_K of the step's dense reconstruction ``b2 * V_red + (1 - b2) * g^2``:
    its line mean is ``v_new`` and its line variance ``(1 - b2)^2 *
    Var_K[g^2]``."""
    mean_c = s1c / n
    var = s2c / n - torch.square(mean_c)
    var = torch.clamp(var, min=0.0) * (one_minus_b2 * one_minus_b2)
    return torch.mean(torch.square(v_new) / (var + eps))


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
