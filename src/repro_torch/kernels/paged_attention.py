"""Ragged paged attention over a fused K/V page pool, for decode and chunked
prefill (port of ``repro/kernels/paged_attention.py`` ``paged_attention``).

Kernel: ``csrc/paged_attention.cu`` replaces the Pallas kernel at
``repro/kernels/paged_attention.py:143`` (body ``_paged_kernel`` :70,
``pallas_call`` :172). It is bound by bytes: each live K/V page row is read
once and the arithmetic is about 2 flops per byte. The source note says how
the design follows from that.

Layouts are JAX's: q ``(B, C, H, hd)`` holding the queries at absolute
positions ``lengths - C .. lengths - 1``; pool ``(n_pages, page, 2 * KV,
hd)`` with K of group g on head row ``2g`` and V on ``2g + 1``; table
``(B, max_pages)`` int32 page ids (0 is the null page); lengths ``(B,)``
int32 (0 marks an inactive row, whose output is exactly 0). Query head h
reads group ``h // (H // KV)``.

A CUDA operand launches the kernel, or raises for geometry the kernel does
not take; there is no VMEM gate as in JAX and no route from a CUDA tensor to
the plain version. CPU operands take :func:`paged_attention_plain`.
"""
from __future__ import annotations

import math

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 32           # query heads per KV group: a block holds <= 32 query rows
_FLOATS = (torch.float32, torch.bfloat16)
_DTYPES = {"q": _FLOATS, "pool": _FLOATS, "table": (torch.int32,), "lengths": (torch.int32,)}
_ARGTYPES = ([build.PTR, build.INT, build.PTR, build.INT, build.PTR, build.PTR, build.PTR]
             + [build.INT] * 8 + [build.PTR])


def _geometry(q: torch.Tensor, pool: torch.Tensor, table: torch.Tensor, lengths: torch.Tensor):
    if q.ndim != 4 or pool.ndim != 4 or table.ndim != 2 or lengths.ndim != 1:
        raise ValueError(f"paged_attention: want q (B, C, H, hd), pool (pages, page, 2KV, hd), table (B, max_pages), "
                         f"lengths (B,); got {tuple(q.shape)}, {tuple(pool.shape)}, {tuple(table.shape)}, "
                         f"{tuple(lengths.shape)}")
    b, c, h, hd = q.shape
    _, page, kv2, hd2 = pool.shape
    if hd2 != hd or kv2 % 2 or kv2 == 0 or h % (kv2 // 2):
        raise ValueError(f"paged_attention: pool {tuple(pool.shape)} does not fit q {tuple(q.shape)}")
    if table.shape[0] != b or lengths.shape[0] != b:
        raise ValueError(f"paged_attention: table {tuple(table.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not have q's {b} rows")
    return b, c, h, hd, page, kv2 // 2


def paged_attention_plain(q: torch.Tensor, pool: torch.Tensor, table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (port of ``paged_attention_ref``): gather every
    table page densely and run a full masked f32 softmax. Returns
    (B, C, H, hd) in q's dtype."""
    b, c, h, hd, page, kv = _geometry(q, pool, table, lengths)
    rep = h // kv
    gathered = pool[table.long()].float()           # (B, max_pages, page, 2KV, hd)
    s_max = table.shape[1] * page
    k = gathered[:, :, :, 0::2, :].reshape(b, s_max, kv, hd)
    v = gathered[:, :, :, 1::2, :].reshape(b, s_max, kv, hd)
    qg = q.float().reshape(b, c, kv, rep, hd) / math.sqrt(hd)
    s = torch.einsum("bckrd,bpkd->bckrp", qg, k)
    q_abs = lengths.long()[:, None] - c + torch.arange(c, device=q.device)[None, :]    # (B, C)
    mask = (torch.arange(s_max, device=q.device)[None, None, :] <= q_abs[:, :, None])[:, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    s = s - s.amax(dim=-1, keepdim=True)
    pexp = torch.where(mask, torch.exp(s), 0.0)
    num = torch.einsum("bckrp,bpkd->bckrd", pexp, v)
    den = torch.clamp(pexp.sum(dim=-1), min=1e-30)
    return (num / den[..., None]).reshape(b, c, h, hd).to(q.dtype)


def paged_attention(q: torch.Tensor, pool: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Ragged paged attention. q: (B, C, H, hd) f32|bf16; pool: (n_pages,
    page, 2*KV, hd) f32|bf16; table: (B, max_pages) int32; lengths: (B,)
    int32. Returns (B, C, H, hd) in q's dtype, computed in f32. CUDA
    operands launch the kernel; CPU operands take the plain version."""
    b, c, h, hd, page, kv = _geometry(q, pool, table, lengths)
    device = build.check_operands("paged_attention", dtypes=_DTYPES, q=q, pool=pool, table=table, lengths=lengths)
    if device.type == "cpu":
        return paged_attention_plain(q, pool, table, lengths)
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} not supported by the kernel (one of {HEAD_DIMS})")
    if h // kv > MAX_REP:
        raise ValueError(f"paged_attention: {h // kv} query heads per KV group exceed the kernel's {MAX_REP}")
    if min(b, c, table.shape[1], pool.shape[0]) == 0:
        raise ValueError(f"paged_attention: empty operand q {tuple(q.shape)}, table {tuple(table.shape)}, "
                         f"pool {tuple(pool.shape)}")
    if pool.data_ptr() % 16:
        raise ValueError("paged_attention: the pool must start on a 16-byte boundary (the kernel reads 16-byte rows)")
    if b * c >= 2**31 or pool.shape[0] >= 2**31:
        raise ValueError("paged_attention: operands too large for the kernel's 32-bit counts")
    out = torch.empty_like(q)
    fn = build.entry("repro_paged_attention", _ARGTYPES)
    build.launch("paged_attention", fn, device, q.data_ptr(), int(q.dtype == torch.bfloat16), pool.data_ptr(),
                 int(pool.dtype == torch.bfloat16), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 b, c, h, kv, hd, page, table.shape[1], pool.shape[0])
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
