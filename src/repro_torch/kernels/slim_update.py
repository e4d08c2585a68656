"""Per-leaf SlimAdam kernels on the batched canonical form (port of
``repro/kernels/slim_update.py``: ``slim_precond_batched`` and its 2-D
wrappers ``slim_precond`` / ``slim_precond_major``; the sharded psum pair
``slim_partial_stats_batched`` / ``slim_finalize_batched`` and their 2-D
wrappers ``slim_partial_stats`` / ``slim_finalize``).

Kernel: ``csrc/mega_slim.cu`` (``repro_slim_precond``, the per-leaf
instantiation of the megaplan group kernel with scalar bias corrections and
f32 or bf16 g) replaces the Pallas kernel at
``repro/kernels/slim_update.py:154`` (body ``_slim_precond_kernel`` :132,
``pallas_call`` :207). It is bound by bytes: 16 B per f32 element (14 B for
bf16 g) plus 8 B per line, 8 B more per line with ``with_snr``. It takes B1's
walk on the grid of :func:`repro_torch.kernels.megaplan.plan_slim` (long
lines and thin column strips split across the SMs). Its (2,) health
accumulator is the per-line health outputs reduced by one more small
launch, not the TPU kernel's in-order grid accumulation
(``slim_update.py:118-129``).

B7 ``slim_update_batched`` (and its 2-D wrappers ``slim_update`` /
``slim_update_major``), the parameter-writing SlimAdam, is the WRITE
instantiation of the same walk (``repro_slim_update`` in
``csrc/mega_slim.cu``), replacing the Pallas kernel at
``repro/kernels/slim_update.py:74`` (body ``_slim_kernel`` :56,
``pallas_call`` :103). It takes B4's grid from ``plan_slim`` (p counted in
the alignment), with pass 2 writing p' where B4 writes u. Bound by bytes:
p, g, m read and p', m' written, 20 B per f32 element, plus 8 B per line
(24 B where a split view's g outgrows the L2 and pass 2 reads it again).
Its step count is a Python int, so the bias corrections are host floats
and no launch forms them.

The psum pair, for a leaf whose reduction dims are split across ranks:

* B10 ``slim_partial_stats_batched`` — the PARTIAL instantiation of the
  split walk in ``csrc/mega_slim.cu`` (``repro_slim_partial_stats``),
  replacing ``repro/kernels/slim_update.py:260`` (body
  ``_slim_partial_kernel`` :244, ``pallas_call`` :304): m' and the line's
  partial sum of g^2, with the flags' outputs. Bound by bytes: 12 B per f32
  element (10 B with bf16 g) plus 4 B per line (12 B more with
  ``with_snr``). It takes B12's plan (``megaplan.slim_walk``) and kernels:
  ROWS where a line fits a piece, else one walk that writes m' and f64
  shares and a fixed-order combine, so B10 and B12 give equal bits on the
  same operands.
* B11 ``slim_finalize_batched`` — ``csrc/slim_finalize.cu``
  (``repro_slim_finalize_flat``), replacing
  ``repro/kernels/slim_update.py:329`` (``pallas_call`` :365 owner form,
  :374 ek form). Bound by bytes: 8 B per element plus O(kept). One flat
  walk over the view for both axes, on the grid :func:`plan_finalize`
  sizes from the shapes and the SM count (pure integer arithmetic, tested
  on the CPU); the bias corrections come from the step count inside the
  kernel (a 0-d int32 or int64 count on the card, read by pointer) or as
  host-rounded floats (a Python int), so a call is one launch and no other
  device work. B13 (``megaplan.mega_slim_finalize_batched``) runs the same
  walk with bias corrections given a line.
"""
from __future__ import annotations

import dataclasses
import functools
import operator

import torch

from . import build
from .fused_adam import G_DTYPES, P_DTYPES, bias_corrections, health_terms, host_bias_corrections, param_step
from .megaplan import PLAN_ARGTYPES, last_plans, mega_slim_update_batched_plain, slim_line_shape, slim_walk
from .snr_stats import centered_line_stats

_ARGTYPES = ([build.PTR, build.INT] + [build.PTR] * 12 + [build.SIZE] * 3 + [build.INT] + PLAN_ARGTYPES
             + [build.F32] * 6 + [build.PTR])


def slim_precond_batched_plain(g, m, v_line, bc1, bc2, *, axis, b1, b2, eps, with_snr: bool = False,
                               with_health: bool = False):
    """Plain PyTorch version of :func:`slim_precond_batched`: the group
    kernel's plain version with scalar bias corrections, and the health
    lines reduced to the leaf's (2,) accumulator."""
    g32 = g.float()
    outs = mega_slim_update_batched_plain(g32, m, v_line, bc1, bc2, axis=axis, b1=b1, b2=b2, eps=eps,
                                          with_snr=with_snr)
    return outs + (health_terms(g32),) if with_health else outs


def slim_precond_batched(g, m, v_line, *, axis: int, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                         count=1, with_snr: bool = False, with_health: bool = False):
    """Preconditioned batched SlimAdam update: (g, m, v_line) -> (u, m', v').

    g, m: (B, R, C), g f32 or bf16, m f32; v_line (B, R, 1) f32 for
    ``axis=1`` (reduce over C) or (B, 1, C) for ``axis=0`` (reduce over R).
    ``count`` (int, or an int 0-d tensor on g's device) gives the scalar
    bias corrections. ``with_snr`` appends (s1c, s2c), the line sums of g^2
    shifted by each line's first entry (``v_line``'s layout);
    ``with_health`` appends the leaf's (2,) ``[nonfinite_count,
    finite_sumsq]`` of g, always last. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if g.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"slim_precond_batched: want (B, R, C) and axis 0|1, got {tuple(g.shape)}, axis {axis}")
    line = slim_line_shape(g, axis)
    if m.shape != g.shape or v_line.shape != line:
        raise ValueError(f"slim_precond_batched: want m {tuple(g.shape)} and v_line {line}; got "
                         f"{tuple(m.shape)}, {tuple(v_line.shape)}")
    device = build.check_operands("slim_precond_batched", dtypes={"g": G_DTYPES}, g=g, m=m, v_line=v_line)
    bc1, bc2 = bias_corrections(b1, b2, torch.as_tensor(count, device=device))
    if device.type == "cpu":
        return slim_precond_batched_plain(g, m, v_line, bc1, bc2, axis=axis, b1=b1, b2=b2, eps=eps,
                                          with_snr=with_snr, with_health=with_health)
    if device.type == "meta":
        return build.on_meta(slim_precond_batched, (build.meta_empty(g.shape), build.meta_empty(g.shape))
                             + tuple(build.meta_empty(line) for _ in range(1 + 2 * with_snr))
                             + ((build.meta_empty((2,)),) if with_health else ()))
    walk, work = slim_walk("slim_precond_batched", g, m, axis, with_snr=with_snr, with_health=with_health)
    b, r, c = g.shape
    u = torch.empty(g.shape, dtype=torch.float32, device=device)
    m_out = torch.empty_like(u)
    v_out = torch.empty_like(v_line)
    snr = tuple(torch.empty_like(v_line) for _ in range(2)) if with_snr else (None, None)
    lines = tuple(torch.empty_like(v_line) for _ in range(2)) if with_health else (None, None)
    health = torch.empty(2, dtype=torch.float32, device=device) if with_health else None
    n_red = c if axis == 1 else r
    fn = build.entry("repro_slim_precond", _ARGTYPES)
    build.launch("slim_precond_batched", fn, device, g.data_ptr(), int(g.dtype == torch.bfloat16),
                 *(t.data_ptr() for t in (m, v_line, bc1, bc2, u, m_out, v_out)),
                 *map(build.ptr, (*snr, *lines, health)),
                 b, r, c, axis, *walk, 1.0 / n_red, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    slim_precond_batched.launches += 1
    return (u, m_out, v_out) + (snr if with_snr else ()) + ((health,) if with_health else ())


slim_precond_batched.launches = 0


def slim_precond(g, m, v_row, **kw):
    """2-D minor form: g, m (R, C); v_row (R, 1) reduced over C. Returns
    (u, m', v_row') (plus the flags' outputs with their batch dim dropped)."""
    outs = slim_precond_batched(g[None], m[None], v_row[None], axis=1, **kw)
    return tuple(o if o.ndim == 1 else o[0] for o in outs)


def slim_precond_major(g, m, v_col, **kw):
    """2-D major form: g, m (R, C); v_col (1, C) reduced over R. Returns
    (u, m', v_col') (plus the flags' outputs with their batch dim dropped)."""
    outs = slim_precond_batched(g[None], m[None], v_col[None], axis=0, **kw)
    return tuple(o if o.ndim == 1 else o[0] for o in outs)


# ---------------------------------------------------------------------------
# The parameter-writing form (B7)
# ---------------------------------------------------------------------------

_UPDATE_ARGTYPES = ([build.PTR, build.INT, build.PTR, build.INT] + [build.PTR] * 5 + [build.SIZE] * 3
                    + [build.INT] + PLAN_ARGTYPES + [build.F32] * 10 + [build.PTR])


def slim_update_batched_plain(p, g, m, v_line, *, axis, lr, b1, b2, eps, wd, bc1, bc2):
    """Plain PyTorch version of :func:`slim_update_batched`: the precondition
    form's plain version, then p' = p - lr * (u + wd * p)."""
    u, m_new, v_new = mega_slim_update_batched_plain(g.float(), m, v_line, bc1, bc2, axis=axis, b1=b1, b2=b2,
                                                     eps=eps)
    return param_step(p, u, lr=lr, wd=wd), m_new, v_new


def slim_update_batched(p, g, m, v_line, *, axis: int, lr: float, b1: float = 0.9, b2: float = 0.95,
                        eps: float = 1e-8, wd: float = 0.0, count: int = 1):
    """Batched SlimAdam step that writes the parameters, on the (B, R, C)
    canonical form: (p, g, m, v_line) -> (p', m', v').

    p, g, m: (B, R, C), p and g f32 or bf16, m f32; v_line (B, R, 1) f32 for
    ``axis=1`` (reduce over C) or (B, 1, C) for ``axis=0`` (reduce over R).
    p' has p's dtype. ``count`` is the step count (an int). CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if p.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"slim_update_batched: want (B, R, C) and axis 0|1, got {tuple(p.shape)}, axis {axis}")
    line = slim_line_shape(p, axis)
    if not (g.shape == m.shape == p.shape) or v_line.shape != line:
        raise ValueError(f"slim_update_batched: want g, m {tuple(p.shape)} and v_line {line}; got "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, {tuple(v_line.shape)}")
    device = build.check_operands("slim_update_batched", dtypes={"p": P_DTYPES, "g": G_DTYPES}, p=p, g=g, m=m,
                                  v_line=v_line)
    bc1, bc2 = host_bias_corrections(b1, b2, count)
    if device.type == "cpu":
        return slim_update_batched_plain(p, g, m, v_line, axis=axis, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd,
                                         bc1=bc1, bc2=bc2)
    if device.type == "meta":
        return build.on_meta(slim_update_batched, (build.meta_empty(p.shape, p.dtype), build.meta_empty(p.shape),
                                                   build.meta_empty(line)))
    walk, work = slim_walk("slim_update_batched", g, m, axis, with_snr=False, with_health=False, p=p)
    b, r, c = p.shape
    p_out = torch.empty_like(p)
    m_out = torch.empty(p.shape, dtype=torch.float32, device=device)
    v_out = torch.empty_like(v_line)
    n_red = c if axis == 1 else r
    fn = build.entry("repro_slim_update", _UPDATE_ARGTYPES)
    build.launch("slim_update_batched", fn, device, p.data_ptr(), int(p.dtype == torch.bfloat16), g.data_ptr(),
                 int(g.dtype == torch.bfloat16), m.data_ptr(), v_line.data_ptr(), p_out.data_ptr(),
                 m_out.data_ptr(), v_out.data_ptr(), b, r, c, axis, *walk, 1.0 / n_red, lr, wd, bc1, bc2, b1,
                 1.0 - b1, b2, 1.0 - b2, eps)
    slim_update_batched.launches += 1
    return p_out, m_out, v_out


slim_update_batched.launches = 0


def slim_update(p, g, m, v_row, **kw):
    """2-D minor form: p, g, m (R, C); v_row (R, 1) reduced over C. Returns
    (p', m', v_row')."""
    return tuple(o[0] for o in slim_update_batched(p[None], g[None], m[None], v_row[None], axis=1, **kw))


def slim_update_major(p, g, m, v_col, **kw):
    """2-D major form: p, g, m (R, C); v_col (1, C) reduced over R. Returns
    (p', m', v_col')."""
    return tuple(o[0] for o in slim_update_batched(p[None], g[None], m[None], v_col[None], axis=0, **kw))


# ---------------------------------------------------------------------------
# The sharded psum pair (B10, B11)
# ---------------------------------------------------------------------------

_PARTIAL_ARGTYPES = ([build.PTR, build.INT] + [build.PTR] * 9 + [build.SIZE] * 3 + [build.INT] + PLAN_ARGTYPES
                     + [build.SIZE] + [build.F32] * 2 + [build.PTR])


def slim_partial_stats_batched_plain(g, m, *, axis, b1, with_snr: bool = False, with_health: bool = False):
    """Plain PyTorch version of :func:`slim_partial_stats_batched`, in the
    kernel's operation order."""
    red = 2 if axis == 1 else 1
    g32 = g.float()
    g2 = g32 * g32
    out = (b1 * m + (1 - b1) * g32, torch.sum(g2, dim=red, keepdim=True))
    if with_snr:
        out = out + centered_line_stats(g2, red)
    return out + (health_terms(g32),) if with_health else out


def slim_partial_stats_batched(g, m, *, axis: int, b1: float = 0.9, with_snr: bool = False,
                               with_health: bool = False):
    """Pass 1 of the psum pair on the (B, R, C) canonical form of a rank's
    shard: (g, m) -> (m', part). g f32 or bf16, m f32; ``part`` is the line
    sum of g^2 over the shard's slice of each line, (B, R, 1) for ``axis=1``
    and (B, 1, C) for ``axis=0``, ready for the cross-rank sum. With
    ``with_snr`` also (s1c, s2c, first): the line sums of g^2 shifted by the
    slice's first entry, and that shift (what
    ``repro_torch.kernels.ref.rebase_centered_stats`` needs); with
    ``with_health`` the shard's (2,) ``[nonfinite_count, finite_sumsq]``,
    always last. CUDA tensors launch the kernel on ``plan_slim``'s grid
    (kept in ``megaplan.last_plans``); CPU tensors take the plain version."""
    if g.ndim != 3 or axis not in (0, 1) or m.shape != g.shape:
        raise ValueError(f"slim_partial_stats_batched: want g, m (B, R, C) and axis 0|1, got "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, axis {axis}")
    device = build.check_operands("slim_partial_stats_batched", dtypes={"g": G_DTYPES}, g=g, m=m)
    if device.type == "cpu":
        return slim_partial_stats_batched_plain(g, m, axis=axis, b1=b1, with_snr=with_snr, with_health=with_health)
    if device.type == "meta":
        line = slim_line_shape(g, axis)
        return build.on_meta(slim_partial_stats_batched, (build.meta_empty(g.shape),)
                             + tuple(build.meta_empty(line) for _ in range(1 + 3 * with_snr))
                             + ((build.meta_empty((2,)),) if with_health else ()))
    walk, work = slim_walk("slim_partial_stats_batched", g, m, axis, with_snr=with_snr, with_health=with_health)
    line = slim_line_shape(g, axis)
    m_out = torch.empty(g.shape, dtype=torch.float32, device=device)
    part = torch.empty(line, dtype=torch.float32, device=device)
    snr = tuple(torch.empty_like(part) for _ in range(3)) if with_snr else (None,) * 3
    lines = tuple(torch.empty_like(part) for _ in range(2)) if with_health else (None, None)
    health = torch.empty(2, dtype=torch.float32, device=device) if with_health else None
    b, r, c = g.shape
    fn = build.entry("repro_slim_partial_stats", _PARTIAL_ARGTYPES)
    build.launch("slim_partial_stats_batched", fn, device, g.data_ptr(), int(g.dtype == torch.bfloat16),
                 m.data_ptr(), m_out.data_ptr(), part.data_ptr(), *map(build.ptr, (*snr, *lines, health)),
                 b, r, c, axis, *walk, last_plans["slim_partial_stats_batched"].combine_blocks, b1, 1.0 - b1)
    slim_partial_stats_batched.launches += 1
    return (m_out, part) + (snr if with_snr else ()) + ((health,) if with_health else ())


slim_partial_stats_batched.launches = 0


def slim_finalize_batched_plain(m_new, v_line, bc1, bc2, *, b2, eps, ek=None):
    """Plain PyTorch version of :func:`slim_finalize_batched` (and of the
    group form, with line bias corrections), in the kernel's operation
    order."""
    v_new = v_line if ek is None else b2 * v_line + (1 - b2) * ek
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return u if ek is None else (u, v_new)


def check_finalize(kernel: str, m_new, v_line, ek, axis: int) -> torch.device:
    """What the finalize kernels (``csrc/slim_finalize.cu``) take."""
    if m_new.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"{kernel}: want m' (B, R, C) and axis 0|1, got {tuple(m_new.shape)}, axis {axis}")
    line = slim_line_shape(m_new, axis)
    if v_line.shape != line or (ek is not None and ek.shape != line):
        raise ValueError(f"{kernel}: want lines {line}, got {tuple(v_line.shape)}"
                         + (f", {tuple(ek.shape)}" if ek is not None else ""))
    lines = {"v_line": v_line} if ek is None else {"v_line": v_line, "ek": ek}
    return build.check_operands(kernel, m_new=m_new, **lines)


# The flat walk's geometry; kFlatThreads, kFlatUnroll and kFlatBlocksPerSm
# in csrc/slim_finalize.cu match.
FLAT_THREADS = 256
FLAT_UNROLL = 2            # vectors a thread keeps in flight
FLAT_BLOCKS_PER_SM = 4     # what the walk's __launch_bounds__ guarantees
WIDE = 2**31               # views of this many elements or more index in 64 bits
COUNT_DTYPES = (torch.int32, torch.int64)
_FLAT_ARGTYPES = ([build.PTR] * 8 + [build.INT] + [build.F32] * 6 + [build.SIZE] * 3 + [build.INT] * 3
                  + [build.SIZE, build.PTR])


@dataclasses.dataclass(frozen=True)
class FinalizePlan:
    """The grid of one B11 or B13 call on a (B, R, C) view: ``blocks``
    blocks of FLAT_THREADS threads walk tiles of FLAT_THREADS x FLAT_UNROLL
    vectors of ``vec`` elements, block i taking tiles i, i + blocks, ...;
    vector j of a tile is thread j % FLAT_THREADS's (j // FLAT_THREADS)-th
    load."""
    batch: int
    rows: int
    cols: int
    axis: int
    vec: int        # 4 (float4) or 1
    blocks: int
    wide: bool      # 64-bit indices

    @property
    def vectors(self) -> int:
        return self.batch * self.rows * self.cols // self.vec

    @property
    def tile(self) -> int:
        return FLAT_THREADS * FLAT_UNROLL

    def describe(self) -> str:
        """The walk's vectors and blocks, as the logs print them."""
        return f"flat, {'float4' if self.vec == 4 else 'scalar'}, {self.blocks} blocks"


@functools.lru_cache(maxsize=None)
def plan_finalize(b: int, r: int, c: int, axis: int, sms: int, *, aligned: bool = True) -> FinalizePlan:
    """The flat walk's grid for a (B=b, R=r, C=c) view on a card with
    ``sms`` SMs. float4 vectors where c % 4 == 0 and the buffers are
    16-byte aligned (a float4 then never spans two rows, so on axis 1 it
    lies in one line and on axis 0 in 4 adjacent lines). A grid of one
    block a tile up to FLAT_BLOCKS_PER_SM blocks an SM, beyond which the
    blocks walk further tiles. Pure integer arithmetic: it reads no
    tensor and makes no CUDA call (and is cached, as the wrappers ask for
    every launch)."""
    if min(b, r, c) < 1 or axis not in (0, 1) or sms < 1:
        raise ValueError(f"plan_finalize: want a non-empty (B, R, C), axis 0|1 and sms >= 1, got "
                         f"{(b, r, c)}, axis {axis}, sms {sms}")
    vec = 4 if c % 4 == 0 and aligned else 1
    vectors = b * r * c // vec
    blocks = min(-(-vectors // (FLAT_THREADS * FLAT_UNROLL)), FLAT_BLOCKS_PER_SM * sms)
    return FinalizePlan(b, r, c, axis, vec, blocks, b * r * c >= WIDE)


def check_count(kernel: str, count, device: torch.device):
    """The step count as B11 takes it: a Python int, or a 0-d int32 or
    int64 tensor on the operands' device (the optimizer state's count)."""
    if not isinstance(count, torch.Tensor):
        return operator.index(count)
    if count.ndim != 0 or count.dtype not in COUNT_DTYPES or count.device != device:
        raise TypeError(f"{kernel}: want an int or a 0-d int32/int64 count on {device}, got {count.dtype} "
                        f"{tuple(count.shape)} on {count.device}")
    return count


def finalize_plan(m_new, axis: int, lines) -> FinalizePlan:
    """``plan_finalize``'s grid for a call on the card. ``lines``: the line
    operands (v, ek and B13's bias corrections; None where absent), read as
    float4 on axis 0, where they count in the alignment; u and v' are
    fresh, so aligned."""
    read = (m_new, *lines) if axis == 0 else (m_new,)
    aligned = all(t.data_ptr() % 16 == 0 for t in read if t is not None)
    return plan_finalize(*m_new.shape, axis, build.sm_count(m_new.device), aligned=aligned)


def launch_finalize_flat(plan: FinalizePlan, m_new, v_line, ek, count, *, b1: float, b2: float, eps: float,
                         bc_lines=None, kernel: str = "slim_finalize_batched"):
    """Launch ``repro_slim_finalize_flat`` on ``plan``; returns u, and v'
    with ``ek``. The bias corrections: ``bc_lines`` (B13's (bc1, bc2), a
    value a line, shaped like ``v_line``; ``count`` and ``b1`` unused), or
    from ``count``: an int (host-rounded) or a 0-d int32 or int64 tensor on
    the card (read by the kernel)."""
    u = torch.empty_like(m_new)
    v_out = torch.empty_like(v_line) if ek is not None else None
    on_card = isinstance(count, torch.Tensor)
    host = bc_lines is None and not on_card
    bc1, bc2 = host_bias_corrections(b1, b2, count) if host else (1.0, 1.0)
    fn = build.entry("repro_slim_finalize_flat", _FLAT_ARGTYPES)
    build.launch(kernel, fn, m_new.device, m_new.data_ptr(), v_line.data_ptr(), build.ptr(ek),
                 *map(build.ptr, bc_lines or (None, None)), u.data_ptr(), build.ptr(v_out),
                 count.data_ptr() if on_card else None, int(on_card and count.dtype == torch.int64), bc1, bc2, b1,
                 b2, 1.0 - b2, eps, plan.batch, plan.rows, plan.cols, plan.axis, plan.vec, int(plan.wide),
                 plan.blocks)
    return u if ek is None else (u, v_out)


def slim_finalize_batched(m_new, v_line, *, axis: int, ek=None, b1: float = 0.9, b2: float = 0.95,
                          eps: float = 1e-8, count=1):
    """Pass 2 of the psum pair: m' (B, R, C) from
    :func:`slim_partial_stats_batched` -> u. With ``ek`` (the cross-rank
    completed line mean of g^2, in ``v_line``'s layout) ``v_line`` is the
    stored moment and this returns ``(u, v')``; with ``ek=None`` ``v_line``
    is the completed new moment (the owner-slice flow, where the all-reduce
    delivered it) and this returns u. ``count`` (an int, or a 0-d int32 or
    int64 tensor on m's device) gives the scalar bias corrections. CUDA
    tensors launch the kernel (one launch, nothing else on the device);
    CPU tensors take the plain version."""
    device = check_finalize("slim_finalize_batched", m_new, v_line, ek, axis)
    count = check_count("slim_finalize_batched", count, device)
    if device.type == "cpu":
        bc1, bc2 = (bias_corrections(b1, b2, count) if isinstance(count, torch.Tensor)
                    else host_bias_corrections(b1, b2, count))
        return slim_finalize_batched_plain(m_new, v_line, bc1, bc2, b2=b2, eps=eps, ek=ek)
    if device.type == "meta":
        u = build.meta_empty(m_new.shape)
        return build.on_meta(slim_finalize_batched, u if ek is None else (u, build.meta_empty(v_line.shape)))
    plan = finalize_plan(m_new, axis, (v_line, ek))
    out = launch_finalize_flat(plan, m_new, v_line, ek, count, b1=b1, b2=b2, eps=eps)
    slim_finalize_batched.launches += 1
    return out


slim_finalize_batched.launches = 0


def slim_partial_stats(g, m, *, axis: int = 1, **kw):
    """2-D wrapper of :func:`slim_partial_stats_batched`: g, m (R, C) ->
    (m', part, ...) with lines (R, 1) (axis 1) or (1, C) (axis 0); the (2,)
    health output keeps its shape."""
    outs = slim_partial_stats_batched(g[None], m[None], axis=axis, **kw)
    return tuple(o if o.ndim == 1 else o[0] for o in outs)


def slim_finalize(m_new, v_line, *, axis: int = 1, ek=None, **kw):
    """2-D wrapper of :func:`slim_finalize_batched`: u, or (u, v') with
    ``ek``."""
    out = slim_finalize_batched(m_new[None], v_line[None], axis=axis, ek=None if ek is None else ek[None], **kw)
    return out[0] if ek is None else (out[0][0], out[1][0])
