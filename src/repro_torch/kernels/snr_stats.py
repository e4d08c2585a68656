"""One-pass centered line statistics for the SNR analysis (port of
``repro/kernels/snr_stats.py``: ``snr_stats_centered_batched``, its
partial-sums form ``snr_stats_centered_partial_batched`` for lines split
across ranks, and the plain helpers ``centered_line_stats`` and
``snr_update_stats_finalize`` of the from-update SNR).

Kernels: ``csrc/snr_stats.cu`` replaces the Pallas kernels at
``repro/kernels/snr_stats.py:133`` (B5, body ``_snr_centered_kernel`` :81)
and ``:152`` (B9, body ``_snr_centered_partial_kernel`` :89), both launched
by ``_stats_call`` (``pallas_call`` :116). Both are bound by bytes: one
4-byte read per element, 12 bytes written per line (16 with B9's shift).
The source note there says how the design follows from that. B8
``snr_stats_batched`` (plain per-line sum and sum of squares, and its 2-D
wrapper ``snr_stats``) is the PLAIN form of the same line walk, replacing
``repro/kernels/snr_stats.py:126`` (body ``_snr_kernel`` :75, through
``_stats_call``); bound by bytes, 4 B per element and 8 B per line.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

_ARGTYPES = [build.PTR] * 5 + [build.SIZE] * 3 + [build.INT, build.PTR]
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


def snr_stats_centered_partial_batched_plain(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`snr_stats_centered_partial_batched`:
    the base form's three sums plus each line's shift v0."""
    red = 2 if axis == 1 else 1
    return snr_stats_centered_batched_plain(v, axis=axis) + (v.narrow(red, 0, 1).squeeze(red),)


def _launch_stats(kernel: str, v: torch.Tensor, axis: int, n_outs: int) -> Tuple[torch.Tensor, ...]:
    """Check and launch ``csrc/snr_stats.cu``: 3 outputs (B5) or 4 (B9)."""
    if v.numel() == 0:
        raise ValueError(f"{kernel}: empty lines have no statistics")
    b, r, c = v.shape
    if (axis == 1 and b * r > _MAX_GRID_X) or (axis == 0 and b > _MAX_GRID_Y):
        raise ValueError(f"{kernel}: shape {tuple(v.shape)} exceeds the launch grid")
    kept = r if axis == 1 else c
    outs = tuple(torch.empty((b, kept), dtype=torch.float32, device=v.device) for _ in range(n_outs))
    fn = build.entry("repro_snr_stats_centered", _ARGTYPES)
    build.launch(kernel, fn, v.device, v.data_ptr(), *(o.data_ptr() for o in outs[:3]),
                 build.ptr(outs[3] if n_outs == 4 else None), b, r, c, axis)
    return outs


def _check_view(kernel: str, v: torch.Tensor, axis: int) -> torch.device:
    if v.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"{kernel}: want a (B, R, C) tensor and axis 0|1, got shape {tuple(v.shape)}, "
                         f"axis {axis}")
    return build.check_operands(kernel, v=v)


def snr_stats_centered_batched(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, ...]:
    """v: (B, R, C) f32 -> (line_sum, shifted_line_sum, shifted_line_sumsq),
    each (B, kept), kept = R for ``axis=1`` and C for ``axis=0``. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if _check_view("snr_stats_centered_batched", v, axis).type == "cpu":
        return snr_stats_centered_batched_plain(v, axis=axis)
    outs = _launch_stats("snr_stats_centered_batched", v, axis, 3)
    snr_stats_centered_batched.launches += 1
    return outs


snr_stats_centered_batched.launches = 0


def snr_stats_centered_partial_batched(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, ...]:
    """v: (B, R, C) f32 -> (line_sum, shifted_line_sum, shifted_line_sumsq,
    line_first), each (B, kept): the partial-sums form for reduction lines
    split across ranks. Each shard shifts by its own first entry; emitting
    that shift lets the caller rebase every shard's sums to a common shift
    (``repro_torch.kernels.ref.rebase_centered_stats``) before summing them
    across ranks. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if _check_view("snr_stats_centered_partial_batched", v, axis).type == "cpu":
        return snr_stats_centered_partial_batched_plain(v, axis=axis)
    outs = _launch_stats("snr_stats_centered_partial_batched", v, axis, 4)
    snr_stats_centered_partial_batched.launches += 1
    return outs


snr_stats_centered_partial_batched.launches = 0


_PLAIN_ARGTYPES = [build.PTR] * 3 + [build.SIZE] * 3 + [build.INT, build.PTR]


def snr_stats_batched_plain(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`snr_stats_batched`: v*v rounded in f32
    as the TPU kernel squares, the sums in f64 as the CUDA kernel's run."""
    red = 2 if axis == 1 else 1
    return v.double().sum(red).float(), (v * v).double().sum(red).float()


def snr_stats_batched(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: (B, R, C) f32 -> (line_sum, line_sumsq), each (B, kept), kept = R
    for ``axis=1`` and C for ``axis=0``. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if _check_view("snr_stats_batched", v, axis).type == "cpu":
        return snr_stats_batched_plain(v, axis=axis)
    if v.numel() == 0:
        raise ValueError("snr_stats_batched: empty lines have no statistics")
    b, r, c = v.shape
    if (axis == 1 and b * r > _MAX_GRID_X) or (axis == 0 and b > _MAX_GRID_Y):
        raise ValueError(f"snr_stats_batched: shape {tuple(v.shape)} exceeds the launch grid")
    kept = r if axis == 1 else c
    s1, s2 = (torch.empty((b, kept), dtype=torch.float32, device=v.device) for _ in range(2))
    fn = build.entry("repro_snr_stats", _PLAIN_ARGTYPES)
    build.launch("snr_stats_batched", fn, v.device, v.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, r, c, axis)
    snr_stats_batched.launches += 1
    return s1, s2


snr_stats_batched.launches = 0


def snr_stats(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: (R, C) -> (row_sum (R,), row_sumsq (R,))."""
    s1, s2 = snr_stats_batched(v[None], axis=1)
    return s1[0], s2[0]
