"""Per-leaf SlimAdam precondition on the batched canonical form (port of
``repro/kernels/slim_update.py``: ``slim_precond_batched`` and its 2-D
wrappers ``slim_precond`` / ``slim_precond_major``).

Kernel: ``csrc/mega_slim.cu`` (``repro_slim_precond``, the per-leaf
instantiation of the megaplan group kernel with scalar bias corrections and
f32 or bf16 g) replaces the Pallas kernel at
``repro/kernels/slim_update.py:154`` (body ``_slim_precond_kernel`` :132,
``pallas_call`` :207). It is bound by bytes: 16 B per f32 element (12 B for
bf16 g) plus 8 B per line, 8 B more per line with ``with_snr``. Its (2,)
health accumulator is the per-line health outputs reduced by a second small
launch, not the TPU kernel's in-order grid accumulation
(``slim_update.py:118-129``). The parameter-writing ``slim_update_batched``
(B7) and the sharded pair (B10, B11) are not ported yet.
"""
from __future__ import annotations

import torch

from . import build
from .fused_adam import G_DTYPES, bias_corrections, health_terms
from .megaplan import check_slim_grid, mega_slim_update_batched_plain, slim_line_shape

_ARGTYPES = ([build.PTR, build.INT] + [build.PTR] * 12 + [build.SIZE] * 3 + [build.INT] + [build.F32] * 6
             + [build.PTR])


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
    check_slim_grid("slim_precond_batched", g, axis)
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
                 b, r, c, axis, 1.0 / n_red, b1, 1.0 - b1, b2, 1.0 - b2, eps)
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
