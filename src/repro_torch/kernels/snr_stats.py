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
B8 ``snr_stats_batched`` (plain per-line sum and sum of squares, and its
2-D wrapper ``snr_stats``) replaces ``repro/kernels/snr_stats.py:126``
(body ``_snr_kernel`` :75, through ``_stats_call``); bound by bytes, 4 B
per element and 8 B per line. All three share one walk that splits the
view by bytes across the SMs: :func:`plan_split` (pure integer arithmetic,
tested on the CPU) chooses its grid, and the source note says how the
design meets the bound.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from . import build

_ARGTYPES = (build.PTR,) * 6 + (build.SIZE,) * 3 + (build.INT,) * 3 + (build.SIZE,) * 4 + (build.PTR,)
_PLAIN_ARGTYPES = (build.PTR,) * 4 + (build.SIZE,) * 3 + (build.INT,) * 3 + (build.SIZE,) * 4 + (build.PTR,)
_MAX_GRID_X = 2**31 - 1

# The split walk's geometry; the kernel's constants in csrc/snr_stats.cu match.
THREADS = 256              # threads of every block (8 warps)
WARPS = THREADS // 32
WARP_LINE_MAX = 4096       # axis-1 lines up to this many elements get a group of lanes each
GROUP_LOADS = 4            # WARP: lanes per line are cut until each lane has about this many loads
SEG_MIN = 16384            # elements a block streams once lines are split: 64 KB ...
SEG_MAX = 65536            # ... to 256 KB
SEG_QUANTUM = 1024         # axis-1 segments are multiples of one block-wide float4 sweep
WAVES = 4                  # blocks per SM the split aims for
TILE_VEC, TILE_SCALAR = 128, 32   # axis-0 columns per block: a float4, or a float, per lane
FORM_WARP, FORM_SPLIT, FORM_MAJOR = 0, 1, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The grid of the split walk over one (B, R, C) view. A line is cut
    into ``nseg`` segments of ``seg`` elements along its reduction axis (the
    last one shorter): block b sums line b // nseg's segment b % nseg
    (FORM_SPLIT), or a column tile's chunk of rows (FORM_MAJOR, tiles of
    TILE_VEC or TILE_SCALAR columns), or WARPS * 32 // group whole lines,
    ``group`` lanes each (FORM_WARP).
    ``nseg == 1`` writes the outputs directly, else the segments' f64 shares
    go to a (3, lines * nseg) workspace that a second launch of
    ``combine_blocks`` blocks sums in a fixed order."""
    form: int          # FORM_WARP, FORM_SPLIT (axis 1) or FORM_MAJOR (axis 0)
    vec: bool          # 16-byte loads (aligned view, inner size a multiple of 4)
    group: int         # FORM_WARP: lanes per line (a power of two <= 32); 32 otherwise
    batch: int
    rows: int
    cols: int
    seg: int
    nseg: int
    blocks: int

    @property
    def lines(self) -> int:
        return self.batch * (self.cols if self.form == FORM_MAJOR else self.rows)

    @property
    def combine_blocks(self) -> int:
        return 0 if self.nseg == 1 else _cdiv(self.lines, WARPS)


def _cut(length: int, piece: int, quantum: int) -> Tuple[int, int]:
    """(seg, nseg): lines of ``length`` cut into segments of about ``piece``
    elements, a multiple of ``quantum``."""
    nseg = _cdiv(length, piece)
    seg = min(length, _cdiv(_cdiv(length, nseg), quantum) * quantum)
    return seg, _cdiv(length, seg)


@functools.lru_cache(maxsize=None)
def plan_split(batch: int, rows: int, cols: int, axis: int, *, sms: int, aligned: bool) -> SplitPlan:
    """The split walk's grid for a (batch, rows, cols) f32 view reduced
    along ``axis`` on a card with ``sms`` SMs; ``aligned``: the view starts
    on a 16-byte boundary. Axis-1 lines up to WARP_LINE_MAX elements take a
    group of lanes each: a warp, or for short lines the power of two that
    leaves each lane about GROUP_LOADS loads; longer lines, and the rows of axis-0 column tiles, are cut
    into pieces of SEG_MIN to SEG_MAX elements, sized for about WAVES blocks
    per SM. Pure integer arithmetic: no CUDA call (and cached, as the
    wrapper asks for every launch)."""
    vec = aligned and cols % 4 == 0
    piece = min(max(_cdiv(batch * rows * cols, WAVES * sms), SEG_MIN), SEG_MAX)
    if axis == 1 and cols <= WARP_LINE_MAX:
        loads = _cdiv(cols // 4 if vec else cols, GROUP_LOADS)
        group = min(32, 1 << max(loads - 1, 0).bit_length())
        return SplitPlan(FORM_WARP, vec, group, batch, rows, cols, cols, 1, _cdiv(batch * rows, WARPS * 32 // group))
    if axis == 1:
        seg, nseg = _cut(cols, piece, SEG_QUANTUM)
        return SplitPlan(FORM_SPLIT, vec, 32, batch, rows, cols, seg, nseg, batch * rows * nseg)
    tile = TILE_VEC if vec else TILE_SCALAR
    seg, nseg = _cut(rows, max(piece // tile, 1), WARPS)
    return SplitPlan(FORM_MAJOR, vec, 32, batch, rows, cols, seg, nseg, batch * _cdiv(cols, tile) * nseg)


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


def _plan_outputs(kernel: str, v: torch.Tensor, axis: int, n_outs: int, n_sums: int):
    """The split walk's plan for ``v``, its ``n_outs`` line outputs and,
    for split lines, the (n_sums, lines * nseg) f64 workspace."""
    if v.numel() == 0:
        raise ValueError(f"{kernel}: empty lines have no statistics")
    b, r, c = v.shape
    plan = plan_split(b, r, c, axis, sms=build.sm_count(v.device), aligned=v.data_ptr() % 16 == 0)
    if max(plan.blocks, plan.combine_blocks) > _MAX_GRID_X:
        raise ValueError(f"{kernel}: shape {tuple(v.shape)} exceeds the launch grid")
    outs = torch.empty((n_outs, b, r if axis == 1 else c), dtype=torch.float32, device=v.device).unbind(0)
    part = (torch.empty((n_sums, plan.lines * plan.nseg), dtype=torch.float64, device=v.device)
            if plan.nseg > 1 else None)
    return plan, outs, part


def _launch_stats(kernel: str, v: torch.Tensor, axis: int, n_outs: int) -> Tuple[torch.Tensor, ...]:
    """Plan, check and launch ``csrc/snr_stats.cu``'s split walk: 3 outputs
    (B5) or 4 (B9)."""
    b, r, c = v.shape
    plan, outs, part = _plan_outputs(kernel, v, axis, n_outs, 3)
    build.launch(kernel, _entry("repro_snr_stats_centered", _ARGTYPES), v.device, v.data_ptr(),
                 *(o.data_ptr() for o in outs[:3]), build.ptr(outs[3] if n_outs == 4 else None), build.ptr(part),
                 b, r, c, plan.form, int(plan.vec), plan.group, plan.seg, plan.nseg, plan.blocks, plan.combine_blocks)
    return outs


@functools.lru_cache(maxsize=None)
def _entry(name: str, argtypes: tuple):
    return build.entry(name, argtypes)


def _meta_lines(v: torch.Tensor, axis: int, n: int) -> Tuple[torch.Tensor, ...]:
    """A dry run's ``n`` line outputs of a (B, R, C) view, each (B, kept)."""
    b, r, c = v.shape
    return tuple(build.meta_empty((b, r if axis == 1 else c)) for _ in range(n))


def _check_view(kernel: str, v: torch.Tensor, axis: int) -> torch.device:
    if v.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"{kernel}: want a (B, R, C) tensor and axis 0|1, got shape {tuple(v.shape)}, "
                         f"axis {axis}")
    return build.check_operands(kernel, v=v)


def snr_stats_centered_batched(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, ...]:
    """v: (B, R, C) f32 -> (line_sum, shifted_line_sum, shifted_line_sumsq),
    each (B, kept), kept = R for ``axis=1`` and C for ``axis=0``. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    device = _check_view("snr_stats_centered_batched", v, axis)
    if device.type == "cpu":
        return snr_stats_centered_batched_plain(v, axis=axis)
    if device.type == "meta":
        return build.on_meta(snr_stats_centered_batched, _meta_lines(v, axis, 3))
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
    device = _check_view("snr_stats_centered_partial_batched", v, axis)
    if device.type == "cpu":
        return snr_stats_centered_partial_batched_plain(v, axis=axis)
    if device.type == "meta":
        return build.on_meta(snr_stats_centered_partial_batched, _meta_lines(v, axis, 4))
    outs = _launch_stats("snr_stats_centered_partial_batched", v, axis, 4)
    snr_stats_centered_partial_batched.launches += 1
    return outs


snr_stats_centered_partial_batched.launches = 0


def snr_stats_batched_plain(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`snr_stats_batched`: v*v rounded in f32
    as the TPU kernel squares, the sums in f64 as the CUDA kernel's run."""
    red = 2 if axis == 1 else 1
    return v.double().sum(red).float(), (v * v).double().sum(red).float()


def snr_stats_batched(v: torch.Tensor, *, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: (B, R, C) f32 -> (line_sum, line_sumsq), each (B, kept), kept = R
    for ``axis=1`` and C for ``axis=0``. CUDA tensors launch the split walk's
    PLAIN form on :func:`plan_split`'s grid; CPU tensors take the plain
    version."""
    device = _check_view("snr_stats_batched", v, axis)
    if device.type == "cpu":
        return snr_stats_batched_plain(v, axis=axis)
    if device.type == "meta":
        return build.on_meta(snr_stats_batched, _meta_lines(v, axis, 2))
    b, r, c = v.shape
    plan, (s1, s2), part = _plan_outputs("snr_stats_batched", v, axis, 2, 2)
    build.launch("snr_stats_batched", _entry("repro_snr_stats", _PLAIN_ARGTYPES), v.device, v.data_ptr(),
                 s1.data_ptr(), s2.data_ptr(), build.ptr(part), b, r, c, plan.form, int(plan.vec), plan.group,
                 plan.seg, plan.nseg, plan.blocks, plan.combine_blocks)
    snr_stats_batched.launches += 1
    return s1, s2


snr_stats_batched.launches = 0


def snr_stats(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """v: (R, C) -> (row_sum (R,), row_sumsq (R,))."""
    s1, s2 = snr_stats_batched(v[None], axis=1)
    return s1[0], s2[0]


def snr_stats_centered(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """v: (R, C) -> (row_sum, shifted_row_sum, shifted_row_sumsq), each
    (R,): one call of :func:`snr_stats_centered_batched`
    (``repro/kernels/snr_stats.py:184``)."""
    return tuple(o[0] for o in snr_stats_centered_batched(v[None], axis=1))


def snr_stats_centered_partial(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """v: (R, C) -> (row_sum, shifted_row_sum, shifted_row_sumsq,
    row_first), each (R,): the partial-sums form for rows split across
    ranks, one call of :func:`snr_stats_centered_partial_batched`
    (``repro/kernels/snr_stats.py:192``)."""
    return tuple(o[0] for o in snr_stats_centered_partial_batched(v[None], axis=1))


def snr_stats_centered_major(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """v: (R, C) -> (col_sum, shifted_col_sum, shifted_col_sumsq), each
    (C,): the reduction along axis 0, one call of
    :func:`snr_stats_centered_batched` (``repro/kernels/snr_stats.py:200``)."""
    return tuple(o[0] for o in snr_stats_centered_batched(v[None], axis=0))
