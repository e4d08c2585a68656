"""Mamba-1 selective scan, forward (port of ``repro/kernels/ssm_scan.py``
``ssm_scan``).

Kernel: ``csrc/ssm_scan.cu`` replaces the Pallas kernel at
``repro/kernels/ssm_scan.py:58`` (body ``_ssm_kernel`` :27, ``pallas_call``
:77). At the model's shapes it is bound by its exponentials (one per
timestep, channel and state) more than by its bytes; the source note says
how one thread per (row, channel) carries the state in registers across the
whole sequence, where the TPU kernel carried it across a sequential grid
axis.

In the model (``repro_torch.models.ssm.selective_scan``) it takes the place
of the JAX package's chunked associative scan: it sums in sequential order,
so the two agree to f32 rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

_IN_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [build.PTR, build.INT] + [build.PTR] * 8 + [build.SIZE] * 3 + [build.INT, build.PTR]


def _check(x, dt, a, b_t, c_t, d_skip, h0) -> torch.device:
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError(f"ssm_scan: want x (B, S, D) and a (D, N); got {tuple(x.shape)}, {tuple(a.shape)}")
    bsz, s, d = x.shape
    n = a.shape[1]
    want = {"dt": (bsz, s, d), "a": (d, n), "b_t": (bsz, s, n), "c_t": (bsz, s, n), "d_skip": (d,),
            "h0": (bsz, d, n)}
    got = {"dt": dt, "a": a, "b_t": b_t, "c_t": c_t, "d_skip": d_skip, "h0": h0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssm_scan: {name} is {tuple(got[name].shape)}, want {shape}")
    if not (x.dtype == b_t.dtype == c_t.dtype):
        raise TypeError(f"ssm_scan: x, b_t and c_t must share a dtype, got {x.dtype}, {b_t.dtype}, {c_t.dtype}")
    return build.check_operands("ssm_scan", dtypes={"x": _IN_DTYPES, "b_t": _IN_DTYPES, "c_t": _IN_DTYPES},
                                x=x, dt=dt, a=a, b_t=b_t, c_t=c_t, d_skip=d_skip, h0=h0)


def ssm_scan_plain(x, dt, a, b_t, c_t, d_skip, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ssm_scan`: the sequential recurrence
    of ``_ssm_kernel`` (``repro/kernels/ssm_scan.py:36-46``), one timestep
    at a time, in f32 and in the kernel's operation order."""
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = b_t.float(), c_t.float()
    dsk = d_skip.float()
    h = h0.float().clone()
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dtf[:, t, :, None] * af)                       # (B, D, N)
        h = decay * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1) + dsk * xf[:, t])
    return torch.stack(ys, dim=1), h


def ssm_scan(x, dt, a, b_t, c_t, d_skip, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); dt: (B, S, D) f32; a: (D, N) f32; b_t, c_t: (B, S, N);
    d_skip: (D,) f32; h0: (B, D, N) f32. x, b_t and c_t are f32 or bf16, one
    dtype for the three. Returns (y (B, S, D) f32, h_final (B, D, N) f32),
    as ``repro/kernels/ssm_scan.py:58-67`` does. CUDA tensors launch the
    kernel (1 <= N <= 16); CPU tensors take the plain version."""
    device = _check(x, dt, a, b_t, c_t, d_skip, h0)
    if device.type == "cpu":
        return ssm_scan_plain(x, dt, a, b_t, c_t, d_skip, h0)
    bsz, s, d = x.shape
    n = a.shape[1]
    if not (1 <= n <= 16 and 1 <= bsz <= 65535):
        raise ValueError(f"ssm_scan: the kernel takes N in 1..16 and 1..65535 rows, got N={n}, B={bsz}")
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=device)
    h_out = torch.empty((bsz, d, n), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return y, h0.clone()
    fn = build.entry("repro_ssm_scan", _ARGTYPES)
    build.launch("ssm_scan", fn, device, x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(), a.data_ptr(),
                 b_t.data_ptr(), c_t.data_ptr(), d_skip.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                 bsz, s, d, n)
    ssm_scan.launches += 1
    return y, h_out


ssm_scan.launches = 0
