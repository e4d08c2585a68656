"""Mamba-1 selective-state-space block, the falcon-mamba mixer (port of
``repro/models/ssm.py``: the forward, its backward, decode and cache, and
the channel-sharded tensor-parallel form on a process mesh,
:func:`_ssm_explicit_tp`).

The JAX package computes the recurrence as a chunked associative scan with a
hand-written VJP; here it is :func:`selective_scan`, whose forward runs the
hand-written selective scan kernel (``repro_torch.kernels.ssm_scan``) for
CUDA tensors, keeping the state at the start of every 16-step tile when a
gradient is wanted (as the JAX forward keeps ``h_bounds``), and whose
backward runs the hand-written backward kernel (``ssm_scan_bwd``), which
replays each tile once from its kept state and runs the reverse recurrence.
The two packages agree to f32 rounding. One forward kernel serves the
training-shaped forward and the one-token decode step (S = 1, the state
from the cache).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import ssm_scan, ssm_scan_bwd, ssm_scan_bwd_plain, ssm_scan_plain
from ..sharding import logical
from .common import ParamSpec, constant_init, normal_init, ones_init, uniform_init, zeros_init

SCAN_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def _a_log_init():
    def init(gen, shape, dtype):
        # S4D-real init: A = -(1..d_state) per channel
        d_inner, d_state = shape
        a = torch.arange(1, d_state + 1, dtype=torch.float32, device=gen.device).expand(d_inner, d_state)
        return torch.log(a).to(dtype)

    return init


def _dt_proj_init(rank: int):
    """U(-rank^-1/2, rank^-1/2)."""
    return uniform_init(rank ** -0.5)


def ssm_specs(cfg: SSMConfig, *, w_init, out_init):
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "d_inner"), "ssm_in", w_init,
                             fan_in=("embed",), fan_out=("d_inner",)),
        "conv_w": ParamSpec((di, cfg.d_conv), ("d_inner", "conv_w"), "ssm_conv", normal_init(0.02)),
        "conv_b": ParamSpec((di,), ("d_inner",), "bias", zeros_init()),
        "x_proj": ParamSpec((di, r + 2 * n), ("d_inner", "dt_rank"), "ssm_x", w_init,
                            fan_in=("d_inner",), fan_out=("dt_rank",)),
        "dt_proj": ParamSpec((r, di), ("dt_rank", "d_inner"), "ssm_dt", _dt_proj_init(r),
                             fan_in=("dt_rank",), fan_out=("d_inner",)),
        "dt_bias": ParamSpec((di,), ("d_inner",), "bias", constant_init(math.log(math.e - 1) * 0.01 + 0.0)),
        "a_log": ParamSpec((di, n), ("d_inner", "state"), "ssm_a", _a_log_init()),
        "d_skip": ParamSpec((di,), ("d_inner",), "ssm_d", ones_init()),
        "out_proj": ParamSpec((di, d), ("d_inner", "embed"), "ssm_out", out_init,
                              fan_in=("d_inner",), fan_out=("embed",)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, history: Optional[torch.Tensor] = None):
    """Depthwise causal conv by shifted adds, its K taps summed in f32 in
    order (``repro/models/ssm.py:86-89``). x: (B, S, di); w: (di, K);
    ``history``: (B, K-1, di) previous inputs (decode). Returns (out in x's
    dtype, the new history)."""
    bsz, s, di = x.shape
    k = w.shape[1]
    if history is None:
        history = torch.zeros((bsz, k - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([history.to(x.dtype), x], dim=1)  # (B, S+K-1, di)
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s, :].float() * wf[:, i]
    out = out + b.float()
    new_hist = xp[:, -(k - 1):, :] if k > 1 else history
    return out.to(x.dtype), new_hist


class _SelectiveScan(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` around the scan
    (``repro/models/ssm.py:139-242``): the forward is kernel B15 (or its
    plain twin); when a gradient is wanted it saves its inputs and the
    state at the start of every 16-step tile, which B15 stores as it passes
    (as the JAX forward keeps ``h_bounds``); the backward is the backward
    kernel ``ssm_scan_bwd`` (or its plain twin), which replays each tile
    once from its kept state. Without a gradient (the eval forward, the
    decode step) B15 runs without the store. Gradients come back in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, dt, a, b_t, c_t, d_skip, h0, impl, grad):
        keep = grad and any(ctx.needs_input_grad[:7])
        states = None
        if impl == "kernel" and keep:
            y, h_final, states = ssm_scan(x, dt, a, b_t, c_t, d_skip, h0, keep_bounds=True)
        elif impl == "kernel":
            y, h_final = ssm_scan(x, dt, a, b_t, c_t, d_skip, h0)
        else:
            y, h_final = ssm_scan_plain(x, dt, a, b_t, c_t, d_skip, h0)
        if keep:
            ctx.save_for_backward(x, dt, a, b_t, c_t, d_skip, h0, states)
        ctx.impl = impl
        ctx.set_materialize_grads(False)
        return y.to(x.dtype), h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, a, b_t, c_t, d_skip, h0, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        if dh_final is not None:
            dh_final = dh_final.float().contiguous()
        if ctx.impl == "kernel":
            grads = ssm_scan_bwd(x, dt, a, b_t, c_t, d_skip, h0, dy, dh_final, states=states)
        else:
            grads = ssm_scan_bwd_plain(x, dt, a, b_t, c_t, d_skip, h0, dy, dh_final)
        like = (x, dt, a, b_t, c_t, d_skip, h0)
        return tuple(g.to(t.dtype) for g, t in zip(grads, like)) + (None, None)


def selective_scan(x, dt, a, b_t, c_t, d_skip, h0, *, impl: str = "kernel"):
    """x, dt: (B, S, di); a: (di, N); b_t, c_t: (B, S, N); h0: (B, di, N).
    Returns (y (B, S, di) in x's dtype, h_final (B, di, N) f32), as
    ``repro/models/ssm.py:140`` (whose ``chunk`` argument sizes the JAX
    scan's chunks; the kernels plan their own). CUDA tensors run kernel B15
    forward and ``ssm_scan_bwd`` backward, CPU tensors their plain twins;
    ``impl="plain"`` picks the twins on any device, an explicit choice for
    comparisons. Differentiable in every tensor argument: ``a``'s gradient
    reaches ``a_log`` through ``-exp`` and ``dt``'s reaches ``dt_proj`` and
    ``dt_bias`` through ``softplus`` by autograd. B15 keeps its tile states
    only when grad mode is on and an operand requires a gradient (inside
    ``Function.forward`` grad mode is off, so that is decided here)."""
    if impl not in SCAN_IMPLS:
        raise ValueError(f"impl must be one of {SCAN_IMPLS}, got {impl!r}")
    dt = dt.float().contiguous()
    a = a.float().contiguous()
    d_skip = d_skip.float().contiguous()
    h0 = h0.float().contiguous()
    ops = (x.contiguous(), dt, a, b_t.contiguous(), c_t.contiguous(), d_skip, h0)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ops)
    return _SelectiveScan.apply(*ops, impl, grad)


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner), activation dtype
    h: torch.Tensor     # (B, d_inner, d_state), f32


def init_ssm_cache(batch: int, cfg: SSMConfig, dtype=torch.float32, device=None) -> SSMCache:
    return SSMCache(conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
                    h=torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device))


def _ssm_inner(p, x: torch.Tensor, cfg: SSMConfig, conv_hist, h0, impl: str = "kernel"):
    """Shared forward core. x: (B, S, D). Returns (out, new conv history,
    final state). Weights are read through
    :func:`repro_torch.sharding.logical.weight` (whole)."""
    w = lambda name: logical.weight(p, name)   # noqa: E731
    xz = torch.einsum("bsd,de->bse", x, w("in_proj").to(x.dtype))
    xb, z = xz.chunk(2, dim=-1)
    xb, new_hist = _causal_conv(xb, w("conv_w"), w("conv_b"), conv_hist)
    xb = F.silu(xb)

    proj = torch.einsum("bsd,dr->bsr", xb, w("x_proj").to(xb.dtype))
    r = cfg.rank
    dt_lr, b_t, c_t = torch.split(proj, [r, cfg.d_state, cfg.d_state], dim=-1)
    dt = torch.einsum("bsr,rd->bsd", dt_lr, w("dt_proj").to(xb.dtype))
    dt = F.softplus(dt.float() + w("dt_bias").float())
    a = -torch.exp(w("a_log").float())

    y, h_final = selective_scan(xb, dt, a, b_t, c_t, w("d_skip"), h0, impl=impl)
    y = y * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, w("out_proj").to(x.dtype))
    return out, new_hist, h_final


def _ssm_whole(p, x: torch.Tensor, cfg: SSMConfig, impl: str) -> torch.Tensor:
    h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.d_state), dtype=torch.float32, device=x.device)
    out, _, _ = _ssm_inner(p, x, cfg, None, h0, impl)
    return out


def ssm_forward(p, x: torch.Tensor, cfg: SSMConfig, *, impl: str = "kernel") -> torch.Tensor:
    """The mixer over a whole sequence, from a zero state. x: (B, S, D). On
    a process mesh with ``tp > 1`` model ranks, x is the residual stream in
    the forward's layout: the channel-sharded region where JAX takes its
    own (the sequence cut over ``model``, ``d_inner`` divisible), else JAX's
    fallback (the mixer whole, this rank's part kept)."""
    lay = logical.active_layout()
    if lay.tp > 1:
        ok = lay.sp and cfg.d_inner % lay.tp == 0
        logical.region("ssm", ok)
        if ok:
            return _ssm_explicit_tp(p, x, cfg, lay, impl)
        return lay.whole(lambda xf: _ssm_whole(logical.gathered(p), xf, cfg, impl), x)
    return _ssm_whole(p, x, cfg, impl)


def _ssm_shard_in(p, x_full: torch.Tensor, cfg: SSMConfig, i: int, n: int, hist=None, xz=None):
    """Model rank ``i`` of ``n``'s channels up to the low-rank product: (its
    conv'd x, its z, its f32 partial of x_proj's product, its new conv
    history (B, K-1, d_inner/n) from ``hist``, the rank's history or None
    for a zero start). in_proj's x and z columns are JAX's ``[x_k | z_k]``
    reorder, two column ranges of the whole weight
    (:func:`repro_torch.sharding.logical.weight`). A stored shard of in_proj
    over ``model`` is a contiguous block of its ``2 * d_inner`` columns
    (model rank 0 of 2 holds the x half), so the weight is gathered whole
    over its axes and cut: the exchange GSPMD makes for JAX's reorder, as an
    all-gather whose backward reduce-scatters the gradient back to the
    stored block. ``xz``: ``x_full @ in_proj`` over all ``2 * d_inner``
    columns where the caller has it instead (the decode step gathers each
    rank's product with its stored block)."""
    di = cfg.d_inner
    di_l = di // n
    lo = i * di_l
    dtype = x_full.dtype
    ch = {0: (lo, di_l)}
    if xz is None:
        w_in = logical.weight(p, "in_proj", {1: ((lo, di_l), (di + lo, di_l))}).to(dtype)
        xb = torch.einsum("bsd,de->bse", x_full, w_in.narrow(1, 0, di_l))
        z = torch.einsum("bsd,de->bse", x_full, w_in.narrow(1, di_l, di_l))
    else:
        xb, z = xz.narrow(-1, lo, di_l), xz.narrow(-1, di + lo, di_l)
    xb, new_hist = _causal_conv(xb, logical.weight(p, "conv_w", ch), logical.weight(p, "conv_b", ch), hist)
    xb = F.silu(xb)
    return xb, z, torch.einsum("bsd,dr->bsr", xb.float(), logical.weight(p, "x_proj", ch).float()), new_hist


def _ssm_shard_out(p, xb, z, proj, cfg: SSMConfig, i: int, n: int, impl: str, dtype, h0=None):
    """Model rank ``i`` of ``n``'s channels from the completed low-rank
    product ``proj`` (f32): dt, the selective scan on its channels from
    ``h0`` (the rank's state (B, d_inner/n, N) f32, None for zeros), the
    gate, and its partial sum of out_proj (in ``dtype``). Returns (the
    partial sum, the final state)."""
    r, st = cfg.rank, cfg.d_state
    di_l = cfg.d_inner // n
    ch = lambda name, dim=0: logical.weight(p, name, {dim: (i * di_l, di_l)})   # noqa: E731
    dt_lr, b_t, c_t = torch.split(proj, [r, st, st], dim=-1)
    dt = torch.einsum("bsr,rd->bsd", dt_lr.to(xb.dtype), ch("dt_proj", 1).to(xb.dtype))
    dt = F.softplus(dt.float() + ch("dt_bias").float())
    a = -torch.exp(ch("a_log").float())
    if h0 is None:
        h0 = torch.zeros((xb.shape[0], di_l, st), dtype=torch.float32, device=xb.device)
    y, h_final = selective_scan(xb, dt, a, b_t.to(xb.dtype), c_t.to(xb.dtype), ch("d_skip"), h0, impl=impl)
    y = y * F.silu(z)
    return logical.dot("bsd,de->bse", y, p, "out_proj", {0: (i * di_l, di_l)}, dtype=dtype).to(dtype), h_final


def _ssm_explicit_tp(p, x: torch.Tensor, cfg: SSMConfig, lay, impl: str) -> torch.Tensor:
    """The channel-sharded mixer (``repro/models/ssm.py:288``): one
    all-gather of the sequence over ``model`` in; this rank's
    ``d_inner/tp`` channels of every channel-wise weight
    (:func:`_ssm_shard_in`); x_proj's low-rank product in f32, completed by
    an all-reduce over ``model``; the selective scan (kernel B15 forward,
    ``ssm_scan_bwd`` backward) on the rank's channels and out_proj's partial
    sums (:func:`_ssm_shard_out`), reduce-scattered back along the
    sequence."""
    from ..launch.mesh import all_gather, psum, psum_scatter

    mesh = lay.mesh
    x_full = all_gather(x, mesh, "model", 1)
    xb, z, part, _ = _ssm_shard_in(p, x_full, cfg, lay.idx, lay.tp)
    out_part, _ = _ssm_shard_out(p, xb, z, psum(part, mesh, "model"), cfg, lay.idx, lay.tp, impl, x.dtype)
    return psum_scatter(out_part, mesh, "model", 1)


def ssm_decode(p, x: torch.Tensor, cache: SSMCache, cfg: SSMConfig, *,
               impl: str = "kernel") -> Tuple[torch.Tensor, SSMCache]:
    """x: (B, 1, D): one O(1) state-space decode step. Returns (out, the new
    cache); the given cache is not written. In the decode layout with
    ``tp > 1`` model ranks the cache is this rank's channels where ``tp``
    divides ``d_inner``: :func:`_ssm_decode_tp`."""
    lay = logical.active_layout()
    if lay.decode and lay.tp > 1:
        return _ssm_decode_tp(p, x, cache, cfg, lay, impl)
    out, new_hist, h_final = _ssm_inner(p, x, cfg, cache.conv, cache.h, impl)
    return out, SSMCache(conv=new_hist, h=h_final)


def _ssm_decode_tp(p, x: torch.Tensor, cache: SSMCache, cfg: SSMConfig, lay, impl: str):
    """One decode step in the decode layout on ``tp`` model ranks. With
    ``d_inner`` over ``model`` (the parallel form): this rank's stored block
    of in_proj's ``2 * d_inner`` columns times the whole token
    (:func:`repro_torch.sharding.logical.dot`: no weight is gathered),
    all-gathered over ``model``, gives the x and z columns of its channels;
    the conv from its history (B, K-1, d_inner/tp); x_proj's f32 partial
    completed by a ``psum``; kernel B15's one-token form on its channels
    from its state (B, d_inner/tp, N); out_proj's partial sum completed by a
    ``psum``. Otherwise (the fallback, counted) the mixer
    runs whole from whole weights on the whole cache every rank holds."""
    from ..launch.mesh import all_gather, psum

    di, n, i, mesh = cfg.d_inner, lay.tp, lay.idx, lay.mesh
    lo, di_l = lay.block("d_inner", di)
    par = di_l < di
    lay.count("ssm", par)
    if not par:
        out, new_hist, h_final = _ssm_inner(p, x, cfg, cache.conv, cache.h, impl)
        return out, SSMCache(conv=new_hist, h=h_final)
    if cache.h.shape[1] != di_l:
        raise ValueError(f"ssm_decode: the rank's state holds {cache.h.shape[1]} channels, its block is {di_l}")
    blk = 2 * di // n
    xz = all_gather(logical.dot("bsd,de->bse", x, p, "in_proj", {1: (i * blk, blk)}), mesh, "model", 2)
    xb, z, proj, new_hist = _ssm_shard_in(p, x, cfg, i, n, cache.conv, xz)
    out, h_final = _ssm_shard_out(p, xb, z, psum(proj, mesh, "model"), cfg, i, n, impl, x.dtype, cache.h)
    return psum(out, mesh, "model"), SSMCache(conv=new_hist, h=h_final)
