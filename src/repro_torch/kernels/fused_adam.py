"""Per-leaf dense Adam precondition (port of ``repro/kernels/fused_adam.py``:
``bias_corrections``, ``health_terms`` and ``adam_precond``).

Kernel: ``csrc/adam_precond.cu`` replaces the Pallas kernel at
``repro/kernels/fused_adam.py:129`` (body ``_adam_precond_kernel`` :108,
``pallas_call`` :166). It is bound by bytes: 24 B per element for f32 g
(22 B for bf16 g), plus 8 B of health output. The source note says how the
design follows from that, and how the (2,) health accumulator is reduced
without the TPU's in-order grid.

B6 ``fused_adam``, the parameter-writing AdamW, is the same elementwise pass
(``repro_fused_adam`` in ``csrc/adam_precond.cu``) with a parameter write,
replacing the Pallas kernel at ``repro/kernels/fused_adam.py:58`` (body
``_adam_kernel`` :42, ``pallas_call`` :79). Bound by bytes: p, g, m, v read
and p', m', v' written, 28 B per f32 element (7 passes). Its step count is
a Python int, as in the JAX entry points, so the bias corrections are host
floats (rounded in f32 as :func:`bias_corrections` rounds them) and no
launch forms them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

# Threads a block and the grid cap of csrc/adam_precond.cu: the grid (and so
# the health partials' order) is a function of the leaf's size alone.
_THREADS = 256
_MAX_BLOCKS = 132 * 16
_ARGTYPES = ([build.PTR, build.INT] + [build.PTR] * 9 + [build.SIZE] * 2 + [build.F32] * 5 + [build.PTR])
G_DTYPES = (torch.float32, torch.bfloat16)
P_DTYPES = (torch.float32, torch.bfloat16)
_FUSED_ARGTYPES = [build.PTR, build.INT, build.PTR, build.INT] + [build.PTR] * 5 + [build.SIZE] * 2 \
    + [build.F32] * 9 + [build.PTR]


def elementwise_blocks(n: int) -> int:
    """The grid of B3 and B6 for ``n`` elements: 256-thread blocks, one
    four-element vector a thread, at most 16 blocks an SM of 132; the
    blocks then stride over the rest."""
    return max(1, min(-(-n // (4 * _THREADS)), _MAX_BLOCKS))


def bias_corrections(b1: float, b2: float, count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^t, 1 - b2^t) as 0-d f32 tensors on the count's device, in f32
    as the JAX package computes them (``repro/kernels/fused_adam.py:29``)."""
    c = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=c.device)
    return (one - torch.full_like(c, b1) ** c, one - torch.full_like(c, b2) ** c)


def host_bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """:func:`bias_corrections` for a step count known on the host (the
    parameter-writing kernels' static ``count``), as Python floats holding
    the f32-rounded values."""
    bc1, bc2 = bias_corrections(b1, b2, torch.tensor(int(count)))
    return float(bc1), float(bc2)


def param_step(p: torch.Tensor, u: torch.Tensor, *, lr: float, wd: float) -> torch.Tensor:
    """p' = p - lr * (u + wd * p) in f32 (the wd term only when wd != 0, as
    the JAX kernels add it), cast to p's dtype."""
    p32 = p.float()
    upd = u + wd * p32 if wd else u
    return (p32 - lr * upd).to(p.dtype)


def health_terms(g: torch.Tensor) -> torch.Tensor:
    """``[nonfinite_count, finite_masked_sumsq]`` of one gradient tensor, a
    (2,) f32 tensor: the plain version of the kernels' (2,) accumulator.
    The sum of squares is masked to the finite entries so the global grad
    norm stays usable on a step where some entries are NaN/Inf; it runs in
    f64 as the kernels' partials do."""
    g32 = g.float()
    fin = torch.isfinite(g32)
    nf = (~fin).sum().float()
    ss = torch.where(fin, g32 * g32, 0.0).double().sum().float()
    return torch.stack([nf, ss])


def adam_precond_plain(g, m, v, bc1, bc2, *, b1, b2, eps, with_health: bool = False):
    """Plain PyTorch version of :func:`adam_precond`, in the kernel's
    operation order."""
    g32 = g.float()
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * g32 * g32
    out = ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps), m_new, v_new)
    return out + (health_terms(g32),) if with_health else out


def adam_precond(g, m, v, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, count=1,
                 with_health: bool = False):
    """Preconditioned Adam update only: (g, m, v) -> (u, m', v'), all f32, for
    one (R, C) leaf; g f32 or bf16, m and v f32. ``count`` (an int, or an
    int 0-d tensor on g's device: optimizer state, never read to the host)
    gives the scalar bias corrections. ``with_health`` appends the leaf's
    (2,) ``[nonfinite_count, finite_sumsq]`` of g. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if g.ndim != 2 or m.shape != g.shape or v.shape != g.shape:
        raise ValueError(f"adam_precond: want g, m, v of one (R, C) shape; got "
                         f"{[tuple(t.shape) for t in (g, m, v)]}")
    device = build.check_operands("adam_precond", dtypes={"g": G_DTYPES}, g=g, m=m, v=v)
    bc1, bc2 = bias_corrections(b1, b2, torch.as_tensor(count, device=device))
    if device.type == "cpu":
        return adam_precond_plain(g, m, v, bc1, bc2, b1=b1, b2=b2, eps=eps, with_health=with_health)
    if device.type == "meta":
        outs = tuple(build.meta_empty(g.shape) for _ in range(3)) + ((build.meta_empty((2,)),) if with_health else ())
        return build.on_meta(adam_precond, outs) if g.numel() else outs
    outs = tuple(torch.empty(g.shape, dtype=torch.float32, device=device) for _ in range(3))
    n = g.numel()
    if n == 0:
        return outs + ((torch.zeros(2, device=device),) if with_health else ())
    blocks = elementwise_blocks(n)
    health = torch.empty(2, dtype=torch.float32, device=device) if with_health else None
    partial = torch.empty(2 * blocks, dtype=torch.float64, device=device) if with_health else None
    fn = build.entry("repro_adam_precond", _ARGTYPES)
    build.launch("adam_precond", fn, device, g.data_ptr(), int(g.dtype == torch.bfloat16),
                 *(t.data_ptr() for t in (m, v, bc1, bc2, *outs)),
                 build.ptr(partial), build.ptr(health),
                 n, blocks, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    adam_precond.launches += 1
    return outs + ((health,) if with_health else ())


adam_precond.launches = 0


def fused_adam_plain(p, g, m, v, *, lr, b1, b2, eps, wd, bc1, bc2):
    """Plain PyTorch version of :func:`fused_adam`, in the kernel's
    operation order; ``bc1``/``bc2`` are the bias corrections."""
    u, m_new, v_new = adam_precond_plain(g, m, v, bc1, bc2, b1=b1, b2=b2, eps=eps)
    return param_step(p, u, lr=lr, wd=wd), m_new, v_new


def fused_adam(p, g, m, v, *, lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.0,
               count: int = 1):
    """AdamW that writes the parameters: (p, g, m, v) -> (p', m', v') for one
    leaf of any shape. p and g are f32 or bf16, m and v f32; p' has p's
    dtype, m' and v' are f32. ``count`` is the step count (an int).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"fused_adam: want p, g, m, v of one shape; got "
                         f"{[tuple(t.shape) for t in (p, g, m, v)]}")
    device = build.check_operands("fused_adam", dtypes={"p": P_DTYPES, "g": G_DTYPES}, p=p, g=g, m=m, v=v)
    bc1, bc2 = host_bias_corrections(b1, b2, count)
    if device.type == "cpu":
        return fused_adam_plain(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, bc1=bc1, bc2=bc2)
    if device.type == "meta":
        outs = (build.meta_empty(p.shape, p.dtype), build.meta_empty(p.shape), build.meta_empty(p.shape))
        return build.on_meta(fused_adam, outs) if p.numel() else outs
    p_out = torch.empty_like(p)
    m_out = torch.empty(p.shape, dtype=torch.float32, device=device)
    v_out = torch.empty_like(m_out)
    n = p.numel()
    if n == 0:
        return p_out, m_out, v_out
    blocks = elementwise_blocks(n)
    fn = build.entry("repro_fused_adam", _FUSED_ARGTYPES)
    build.launch("fused_adam", fn, device, p.data_ptr(), int(p.dtype == torch.bfloat16), g.data_ptr(),
                 int(g.dtype == torch.bfloat16), m.data_ptr(), v.data_ptr(), p_out.data_ptr(), m_out.data_ptr(),
                 v_out.data_ptr(), n, blocks, lr, wd, bc1, bc2, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    fused_adam.launches += 1
    return p_out, m_out, v_out


fused_adam.launches = 0
