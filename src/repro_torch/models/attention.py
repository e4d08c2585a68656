"""Attention: the training forward, the legacy decode step and the paged
serving path (port of ``repro/models/attention.py``: dense path, RoPE, GQA,
``KVCache`` and ``attention_decode``, paged decode and chunked prefill).

Projections are stored 3-D, ``(embed, heads, head_dim)``, exactly as in the
JAX model, so SlimAdam's head-stacked dims and the megaplan groups match.
Sequences up to ``dense_threshold`` take the O(S^2) dense attention, as the
JAX model does; the flash path above it is not ported yet and raises.

The paged path keeps each layer's KV cache in a page pool of the fused layout
``(n_pages, page, 2 * KV, hd)`` (K on even, V on odd head rows) and reduces
through :func:`repro_torch.kernels.paged_attention.paged_attention`. Where
the JAX functions return a new pool, these write the new rows into the given
pool in place (``index_put_``), so serving holds one pool set and no copy.

The legacy decode step keeps a dense ``(B, S_max, KV, hd)`` cache per layer
(:class:`KVCache`) and attends over all of it, masked beyond the fill
length, as the JAX function does; it writes the new position in place. The
int8 form (``kv_quant``) is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from ..kernels.paged_attention import paged_attention, paged_attention_plain
from .common import ParamSpec, apply_rotary, rotary_embedding

NEG_INF = -1e30
ATTN_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    rope: bool = True
    rope_base: float = 10000.0
    qkv_bias: bool = False
    dense_threshold: int = 2048  # the O(S^2) path runs only up to this length


def attention_specs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, *,
                    qkv_bias: bool = False, o_init, w_init):
    if qkv_bias:
        raise NotImplementedError("qkv biases are not ported yet")
    return {
        "wq": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", "head_dim"), "attn_q",
                        w_init, fan_in=("embed",), fan_out=("heads", "head_dim")),
        "wk": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"), "attn_k",
                        w_init, fan_in=("embed",), fan_out=("kv_heads", "head_dim")),
        "wv": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"), "attn_v",
                        w_init, fan_in=("embed",), fan_out=("kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, head_dim, d_model), ("heads", "head_dim", "embed"), "attn_o",
                        o_init, fan_in=("heads", "head_dim"), fan_out=("embed",)),
    }


def _project_qkv(p, x: torch.Tensor, rope_sincos=None):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), weights cast to
    x's dtype at use; rope rotates q and k when ``rope_sincos`` is given."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if rope_sincos is not None:
        sin, cos = rope_sincos
        q = apply_rotary(q, sin, cos)
        k = apply_rotary(k, sin, cos)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV * n_rep, hd): query head h reads group h // n_rep."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def dense_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """O(S^2) attention: f32 scores and softmax, NEG_INF causal mask,
    probabilities cast to v's dtype for the value product."""
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attention_forward(p, x: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """Full-sequence forward (training)."""
    s = x.shape[1]
    if s > cfg.dense_threshold:
        raise NotImplementedError(f"sequence {s} > dense_threshold {cfg.dense_threshold}: "
                                  "the flash-attention path is not ported yet")
    rope_sincos = None
    if cfg.rope:
        rope_sincos = rotary_embedding(torch.arange(s, device=x.device), cfg.head_dim, cfg.rope_base)
    q, k, v = _project_qkv(p, x, rope_sincos)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = dense_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), causal=cfg.causal)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Legacy decode path: a dense cache per request row
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-attention-layer decode cache. k/v: (B, S_max, KV, hd); index: 0-d
    int32 tensor, the fill length. (The JAX cache's int8 scales belong to
    ``kv_quant``, which is not ported.)"""

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor


def init_kv_cache(batch: int, max_seq: int, n_kv: int, head_dim: int, dtype=torch.bfloat16, *, quant: bool = False,
                  device=None) -> KVCache:
    if quant:
        raise NotImplementedError("the int8 KV cache (kv_quant) is not ported yet")
    return KVCache(k=torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype, device=device),
                   v=torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype, device=device),
                   index=torch.zeros((), dtype=torch.int32, device=device))


def attention_decode(p, x: torch.Tensor, cache: KVCache, cfg: AttnConfig) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, D); the cache holds ``index`` previous
    positions. Writes the new K/V at position ``index`` into the cache's
    tensors in place, then attends over positions ``<= index`` in f32
    (grouped queries against the whole cache, masked beyond). Returns
    (y (B, 1, D), the cache with ``index + 1``)."""
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"attention_decode takes one token per row, got {s1}")
    pos = cache.index.long()
    rope_sincos = None
    if cfg.rope:
        rope_sincos = rotary_embedding(pos[None], cfg.head_dim, cfg.rope_base)
    q, k_new, v_new = _project_qkv(p, x, rope_sincos)
    cache.k.index_copy_(1, pos[None], k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, pos[None], v_new.to(cache.v.dtype))

    n_rep = cfg.n_heads // cfg.n_kv_heads
    s_max = cache.k.shape[1]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    qg = q.reshape(b, 1, cfg.n_kv_heads, n_rep, cfg.head_dim).float() * scale
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache.k.float())
    valid = torch.arange(s_max, device=x.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cache.v.float())
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, cache._replace(index=cache.index + 1)


# ---------------------------------------------------------------------------
# Paged serving path
# ---------------------------------------------------------------------------


def _fused_kv_rows(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """k, v: (N, KV, hd) -> (N, 2*KV, hd) with K on even and V on odd head
    rows, so one write fills both halves of a page row."""
    n, kv, hd = k.shape
    return torch.stack([k, v], dim=2).reshape(n, 2 * kv, hd)


def _attend(q, pool, table, lengths, attn_impl: str):
    if attn_impl == "kernel":
        return paged_attention(q, pool, table, lengths)
    if attn_impl == "plain":
        return paged_attention_plain(q, pool, table, lengths)
    raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")


def attention_paged_decode(p, x: torch.Tensor, pool: torch.Tensor, table: torch.Tensor,
                           lengths: torch.Tensor, active: torch.Tensor, cfg: AttnConfig,
                           *, attn_impl: str = "kernel") -> torch.Tensor:
    """One-token paged decode. x: (B, 1, D); pool: (pages, P, 2KV, hd);
    table: (B, max_pages) int32; lengths: (B,) int32 positions already
    stored. Writes the new token's K/V at position ``lengths`` into ``pool``
    (inactive rows go to the reserved null page 0, which no live row's table
    points at), then attends over ``lengths + 1`` positions. Returns y
    (B, 1, D). ``attn_impl="plain"`` is the explicit choice of the kernel's
    plain twin, for comparisons only."""
    b = x.shape[0]
    pos = lengths.long()
    rope_sincos = None
    if cfg.rope:
        rope_sincos = rotary_embedding(pos[:, None], cfg.head_dim, cfg.rope_base)
    q, k_new, v_new = _project_qkv(p, x, rope_sincos)

    page_size = pool.shape[1]
    rows = torch.arange(b, device=x.device)
    page = torch.where(active, table[rows, pos // page_size].long(), torch.zeros_like(pos))
    pool.index_put_((page, pos % page_size), _fused_kv_rows(k_new[:, 0], v_new[:, 0]).to(pool.dtype))

    kv_len = torch.where(active, pos + 1, torch.zeros_like(pos)).to(torch.int32)
    out = _attend(q, pool, table, kv_len, attn_impl)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"].to(x.dtype))


def attention_paged_prefill(p, x: torch.Tensor, pool: torch.Tensor, table_row: torch.Tensor,
                            pos0: int, n_valid: int, cfg: AttnConfig,
                            *, attn_impl: str = "kernel") -> torch.Tensor:
    """One chunk of paged prefill for one request. x: (1, C, D) holding the
    prompt tokens at absolute positions ``pos0 .. pos0 + C - 1``; chunk
    indices >= ``n_valid`` are padding: their K/V go to the null page and
    their outputs are garbage nobody reads (the caller samples at index
    ``n_valid - 1``). The causal mask ``k_abs <= q_abs`` keeps every valid
    query inside the row's live pages. Writes into ``pool`` in place and
    returns y (1, C, D)."""
    c = x.shape[1]
    positions = pos0 + torch.arange(c, device=x.device)
    rope_sincos = None
    if cfg.rope:
        rope_sincos = rotary_embedding(positions, cfg.head_dim, cfg.rope_base)
    q, k_new, v_new = _project_qkv(p, x, rope_sincos)

    page_size = pool.shape[1]
    max_pages = table_row.shape[1]
    pidx = torch.clamp(positions // page_size, 0, max_pages - 1)
    valid = torch.arange(c, device=x.device) < n_valid
    page = torch.where(valid, table_row[0, pidx].long(), torch.zeros_like(pidx))
    pool.index_put_((page, positions % page_size), _fused_kv_rows(k_new[0], v_new[0]).to(pool.dtype))

    kv_len = torch.full((1,), pos0 + c, dtype=torch.int32, device=x.device)
    out = _attend(q, pool, table_row, kv_len, attn_impl)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"].to(x.dtype))
