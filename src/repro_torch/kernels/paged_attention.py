"""Ragged paged attention over a fused K/V page pool, for decode and chunked
prefill (port of ``repro/kernels/paged_attention.py`` ``paged_attention``).

Kernel: ``csrc/paged_attention.cu`` replaces the Pallas kernel at
``repro/kernels/paged_attention.py:143`` (body ``_paged_kernel`` :70,
``pallas_call`` :172). Decode is bound by bytes (each live K/V page row is
read once, about 2 flops per byte), prefill by operations. The kernel splits
each (row, KV group, query tile) into pieces of whole pages so a call runs
several blocks per SM; :func:`plan_paged` (pure integer arithmetic on shapes
and the SM count, tested on the CPU) chooses the pieces, and the source note
says how the design meets each bound. A split call is two CUDA launches:
the walk, then a combine that merges the pieces' partials in piece order.
An unsplit call is one. Either counts as one launch of the wrapper.

Layouts are JAX's: q ``(B, C, H, hd)`` holding the queries at absolute
positions ``lengths - C .. lengths - 1``; pool ``(n_pages, page, 2 * KV,
hd)`` with K of group g on head row ``2g`` and V on ``2g + 1``; table
``(B, max_pages)`` int32 page ids (0 is the null page); lengths ``(B,)``
int32 (0 marks an inactive row, whose output is exactly 0). Query head h
reads group ``h // (H // KV)``.

A CUDA operand launches the kernel, or raises for geometry the kernel does
not take; there is no VMEM gate as in JAX and no route from a CUDA tensor to
the plain version. CPU operands take :func:`paged_attention_plain`.
:func:`paged_fits` answers JAX's VMEM question for a geometry, as a query
with the JAX contract; nothing on the kernel's path consults it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 32           # query heads per KV group: a block holds <= 64 query rows
_FLOATS = (torch.float32, torch.bfloat16)
_DTYPES = {"q": _FLOATS, "pool": _FLOATS, "table": (torch.int32,), "lengths": (torch.int32,)}
_ARGTYPES = ([build.PTR, build.INT, build.PTR, build.INT, build.PTR, build.PTR, build.PTR, build.PTR]
             + [build.INT] * 13 + [build.PTR])
MAX_GRID_X = 2**31 - 1

# The kernel's geometry; the constants of csrc/paged_attention.cu match.
THREADS = 128          # threads of a combine block
ROW_TILES = (4, 16, 64)  # query-row slots of a CUDA-core block
MMA_ROWS = 64          # query-row slots of a tensor-core block (4 warps x 16)
WAVES = 6              # blocks per SM the split aims for, over full table rows
MIN_PIECE_KEYS = 64    # a piece walks at least this many keys (2 ring stages)
FORM_CORES, FORM_MMA = 0, 1

# The JAX package's VMEM policy (``repro/kernels/tiling.py``), kept for
# paged_fits: the per-call working-set budget and the f32 compute itemsize it
# charges every element at, and the full-size page lines the Pallas kernel
# keeps live (current page, the next in flight, one compute copy).
VMEM_BUDGET = 8 << 20
COMPUTE_ITEMSIZE = 4
PAGED_ATTN_BUFS = 3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """The grid of one paged-attention call. Block ``((b * qtiles + t) *
    kv + g) * pieces + k`` computes query tokens ``[t * tokens, (t + 1) *
    tokens)`` of row b (``rows`` query-row slots: tokens x the group's
    heads) against group g's keys on pages ``[k * pages, (k + 1) *
    pages)``, up to the tile's causal limit. ``pieces == 1`` writes the
    output directly; otherwise each piece writes its partial ``(acc, m, l)``
    and ``combine_blocks`` blocks of a second launch merge them in piece
    order."""
    form: int          # FORM_CORES (f32 on the CUDA cores) or FORM_MMA (bf16 tensor cores)
    rows: int
    tokens: int
    qtiles: int
    pages: int
    pieces: int
    blocks: int
    combine_blocks: int

    @property
    def launches(self) -> int:
        """CUDA launches of one call."""
        return 2 if self.combine_blocks else 1


def paged_fits(chunk: int, n_heads: int, head_dim: int, page_size: int, kv2: int, *,
               itemsize: int = COMPUTE_ITEMSIZE) -> bool:
    """Whether one instance of the JAX package's Pallas kernel fits
    :data:`VMEM_BUDGET`: ``PAGED_ATTN_BUFS`` page lines plus the q and acc
    blocks and the two (C, H) softmax stats, all at ``itemsize`` bytes (the
    JAX ``paged_fits``). A query only: the CUDA kernel plans its own grid
    (:func:`plan_paged`) and raises for a geometry it cannot take; it never
    gives way to the plain version."""
    page_line = page_size * kv2 * head_dim
    qacc = chunk * n_heads * head_dim
    stats = chunk * n_heads
    return (PAGED_ATTN_BUFS * page_line + 2 * qacc + 2 * stats) * itemsize <= VMEM_BUDGET


@functools.lru_cache(maxsize=None)
def plan_paged(b: int, c: int, kv: int, rep: int, hd: int, page: int, max_pages: int,
               q_dtype: torch.dtype, pool_dtype: torch.dtype, *, sms: int) -> PagedPlan:
    """The grid for q ``(b, c, kv * rep, hd)`` over ``max_pages``-page table
    rows of ``page`` positions, on a card with ``sms`` SMs. Bf16 q and pool
    with more than one query token take the tensor-core form (64 query rows
    a block), everything else the CUDA-core form with the fewest of
    ROW_TILES slots that hold the chunk's rows. The key axis is cut into
    ``pieces`` of whole pages, about WAVES blocks per SM if every table row
    were full, no piece under MIN_PIECE_KEYS keys. It reads shapes only, so
    the wrapper needs no host sync (``lengths`` stays on the device), and
    is cached, as the wrapper asks for every launch."""
    mma = q_dtype == pool_dtype == torch.bfloat16 and c > 1
    if mma:
        form, rows = FORM_MMA, MMA_ROWS
    else:
        form, rows = FORM_CORES, next(r for r in ROW_TILES if r >= min(c * rep, ROW_TILES[-1]))
    tokens = min(c, rows // rep)
    qtiles = _cdiv(c, tokens)
    tiles = b * kv * qtiles
    pieces = max(1, min(_cdiv(WAVES * sms, tiles), _cdiv(max_pages * page, MIN_PIECE_KEYS)))
    pages = _cdiv(max_pages, pieces)
    pieces = _cdiv(max_pages, pages)
    combine = 0 if pieces == 1 else _cdiv(b * c * kv * rep * (hd // 4), THREADS)
    return PagedPlan(form, rows, tokens, qtiles, pages, pieces, tiles * pieces, combine)


def plan_of(q: torch.Tensor, pool: torch.Tensor, table: torch.Tensor, lengths: torch.Tensor) -> PagedPlan:
    """The plan of a call on these CUDA operands (shapes, dtypes and the
    card's SM count; no value is read)."""
    b, c, h, hd, page, kv = _geometry(q, pool, table, lengths)
    return plan_paged(b, c, kv, h // kv, hd, page, table.shape[1], q.dtype, pool.dtype,
                      sms=build.sm_count(q.device))


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
    int32. Returns (B, C, H, hd) in q's dtype, computed in f32 (bf16 q and
    pool with C > 1: bf16 products on the tensor cores, f32 sums). CUDA
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
    if q.data_ptr() % 16:
        raise ValueError("paged_attention: q must start on a 16-byte boundary (the kernel reads 4-element vectors)")
    plan = plan_of(q, pool, table, lengths)
    if (b * c * h >= 2**31 or pool.shape[0] >= 2**31 or plan.pieces * plan.pages * page >= 2**31
            or max(plan.blocks, plan.combine_blocks) > MAX_GRID_X):
        raise ValueError("paged_attention: operands too large for the kernel's 32-bit counts")
    out = torch.empty_like(q)
    part = (torch.empty(plan.pieces * b * c * h * (hd + 2), dtype=torch.float32, device=device)
            if plan.pieces > 1 else None)
    fn = build.entry("repro_paged_attention", _ARGTYPES)
    build.launch("paged_attention", fn, device, q.data_ptr(), int(q.dtype == torch.bfloat16), pool.data_ptr(),
                 int(pool.dtype == torch.bfloat16), table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 build.ptr(part), b, c, h, kv, hd, page, table.shape[1], pool.shape[0], plan.form, plan.rows,
                 plan.tokens, plan.pages, plan.pieces)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
