"""Attention: the training forward, the legacy decode step and the paged
serving path (port of ``repro/models/attention.py``: the dense path, RoPE,
GQA, qkv biases, the chunked and flash paths, ``KVCache`` with its int8 form
and ``attention_decode``, paged decode and chunked prefill).

Projections are stored 3-D, ``(embed, heads, head_dim)``, exactly as in the
JAX model, so SlimAdam's head-stacked dims and the megaplan groups match.
Sequences up to ``dense_threshold`` take the O(S^2) dense attention; longer
ones take :func:`flash_attention`, the JAX model's online softmax over KV
blocks with a hand-written backward that recomputes each block's
probabilities from the saved log-sum-exp. JAX computes attention in plain
``jnp``, not in a Pallas kernel, so the port's is plain torch in the same
order of operations (not ``F.scaled_dot_product_attention``, another
computation).

The paged path keeps each layer's KV cache in a page pool of the fused layout
``(n_pages, page, 2 * KV, hd)`` (K on even, V on odd head rows) and reduces
through :func:`repro_torch.kernels.paged_attention.paged_attention`. Where
the JAX functions return a new pool, these write the new rows into the given
pool in place (``index_put_``), so serving holds one pool set and no copy.

The legacy decode step keeps a dense ``(B, S_max, KV, hd)`` cache per layer
(:class:`KVCache`) and attends over all of it, masked beyond the fill
length, as the JAX function does; it writes the new position in place. Its
int8 form (``kv_quant``) stores each position's K and V rows as int8 with
an f32 scale a row and folds the scales into the score and value terms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from ..kernels.paged_attention import paged_attention, paged_attention_plain
from ..sharding import logical
from .common import ParamSpec, apply_rotary, rotary_embedding, zeros_init

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
    kv_block: int = 1024         # the flash path's KV block (the largest divisor of S up to it)
    dense_threshold: int = 2048  # the O(S^2) path runs only up to this length


def attention_specs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int, *,
                    qkv_bias: bool = False, o_init, w_init):
    specs = {
        "wq": ParamSpec((d_model, n_heads, head_dim), ("embed", "heads", "head_dim"), "attn_q",
                        w_init, fan_in=("embed",), fan_out=("heads", "head_dim")),
        "wk": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"), "attn_k",
                        w_init, fan_in=("embed",), fan_out=("kv_heads", "head_dim")),
        "wv": ParamSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", "head_dim"), "attn_v",
                        w_init, fan_in=("embed",), fan_out=("kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, head_dim, d_model), ("heads", "head_dim", "embed"), "attn_o",
                        o_init, fan_in=("heads", "head_dim"), fan_out=("embed",)),
    }
    if qkv_bias:
        specs["bq"] = ParamSpec((n_heads, head_dim), ("heads", "head_dim"), "attn_qkv_bias", zeros_init())
        specs["bk"] = ParamSpec((n_kv_heads, head_dim), ("kv_heads", "head_dim"), "attn_qkv_bias", zeros_init())
        specs["bv"] = ParamSpec((n_kv_heads, head_dim), ("kv_heads", "head_dim"), "attn_qkv_bias", zeros_init())
    return specs


def _project_qkv(p, x: torch.Tensor, rope_sincos=None, q_heads=None, kv_heads=None):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), weights cast to
    x's dtype at use; the qkv biases (where the model has them) are added
    before rope rotates q and k (when ``rope_sincos`` is given). The
    products go through :func:`repro_torch.sharding.logical.dot`;
    ``q_heads``/``kv_heads`` (start, count) project only those query or KV
    heads."""
    qc = {1: q_heads} if q_heads else None
    kc = {1: kv_heads} if kv_heads else None
    q = logical.dot("bsd,dhk->bshk", x, p, "wq", qc)
    k = logical.dot("bsd,dhk->bshk", x, p, "wk", kc)
    v = logical.dot("bsd,dhk->bshk", x, p, "wv", kc)
    if "bq" in p:
        qb = {0: q_heads} if q_heads else None
        kb = {0: kv_heads} if kv_heads else None
        q = q + logical.weight(p, "bq", qb).to(x.dtype)
        k = k + logical.weight(p, "bk", kb).to(x.dtype)
        v = v + logical.weight(p, "bv", kb).to(x.dtype)
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


def _block_scores(qf, k_i, i: int, kv_block: int, q_abs, causal: bool):
    """f32 scores (B, H, Sq, block) of the scaled queries against key block
    ``i``, NEG_INF where a key lies after its query (causal)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_i.float())
    if causal:
        k_abs = i * kv_block + torch.arange(k_i.shape[1], device=qf.device)[None, :]
        s = torch.where(q_abs >= k_abs, s, NEG_INF)
    return s


def _online_softmax(q, k, v, *, causal: bool, kv_block: int):
    """The KV-block scan of the JAX model's chunked and flash paths: a
    running (max, denominator, numerator) in f32 over the blocks in order.
    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd). Returns (m, l, acc), each
    (B, H, Sq[, hd])."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qf = q.float() * (1.0 / math.sqrt(hd))
    q_abs = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for i, (k_i, v_i) in enumerate(zip(k.split(kv_block, dim=1), v.split(kv_block, dim=1))):
        s = _block_scores(qf, k_i, i, kv_block, q_abs, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_i.float())
        m = m_new
    return m, l, acc


def chunked_attention(q, k, v, *, causal: bool, kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax attention, O(S * kv_block) live memory in the forward.
    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd); Sk must divide into blocks of
    ``min(kv_block, Sk)``. Autograd differentiates the scan as written (it
    keeps every block's probabilities); :func:`flash_attention` does not."""
    sk = k.shape[1]
    kv_block = min(kv_block, sk)
    if sk % kv_block:
        raise ValueError(f"seq {sk} not divisible by kv_block {kv_block}")
    _, l, acc = _online_softmax(q, k, v, causal=causal, kv_block=kv_block)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _largest_block(s: int, pref: int) -> int:
    """Largest divisor of s that is <= pref (VLM sequences are text plus
    patches, e.g. 4352, which power-of-two blocks do not divide)."""
    if s <= pref:
        return s
    for b in range(min(pref, s), 0, -1):
        if s % b == 0:
            return b
    return 1


class _FlashAttention(torch.autograd.Function):
    """The JAX model's ``flash_attention`` custom VJP. The forward keeps the
    output and the f32 log-sum-exp (B, H, Sq) beside its inputs, not the
    per-block probabilities; the backward walks the KV blocks again in order,
    recomputes each block's probabilities from the log-sum-exp, accumulates
    dq in f32 and yields dk, dv a block each."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_block: int):
        m, l, acc = _online_softmax(q, k, v, causal=causal, kv_block=kv_block)
        l = torch.clamp(l, min=1e-30)
        out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_block = causal, kv_block
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        causal, kv_block = ctx.causal, ctx.kv_block
        sq, hd = q.shape[1], q.shape[3]
        sk = k.shape[1]
        scale = 1.0 / math.sqrt(hd)
        qf = q.float() * scale
        do = d_out.float().transpose(1, 2)                  # (B, H, Sq, hd)
        delta = (do * out.float().transpose(1, 2)).sum(dim=-1)
        q_abs = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
        dk, dv = [], []
        for i, (k_i, v_i) in enumerate(zip(k.split(kv_block, dim=1), v.split(kv_block, dim=1))):
            s = _block_scores(qf, k_i, i, kv_block, q_abs, causal)
            p = torch.exp(s - lse[..., None])               # recomputed, O(block)
            dv.append(torch.einsum("bhqk,bhqd->bkhd", p, do))
            dp = torch.einsum("bhqd,bkhd->bhqk", do, v_i.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_i.float()) * scale
            dk.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
        return (dq.to(q.dtype), torch.cat(dk, dim=1).to(k.dtype), torch.cat(dv, dim=1).to(v.dtype), None, None)


def flash_attention(q, k, v, causal: bool = True, kv_block: int = 1024) -> torch.Tensor:
    """Attention over KV blocks of ``kv_block`` keys with the flash backward.
    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd), Sk a multiple of ``kv_block``.
    Returns (B, Sq, H, hd) in q's dtype."""
    if k.shape[1] % kv_block:
        raise ValueError(f"seq {k.shape[1]} not divisible by kv_block {kv_block}")
    return _FlashAttention.apply(q, k, v, causal, kv_block)


def attention_forward(p, x: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """Full-sequence forward (training): dense attention up to
    ``dense_threshold`` positions, the flash path above it. On a process
    mesh with ``tp > 1`` model ranks, x is the residual stream in the
    forward's layout: the tensor-parallel region where JAX takes its own
    (the sequence cut over ``model``, heads divisible, no qkv biases), else
    JAX's fallback (the region whole, this rank's part kept)."""
    lay = logical.active_layout()
    if lay.tp > 1:
        ok = lay.sp and cfg.n_heads % lay.tp == 0 and not cfg.qkv_bias
        logical.region("attn", ok)
        if ok:
            return _attention_explicit_tp(p, x, cfg, lay)
        return lay.whole(lambda xf: _attention(logical.gathered(p), xf, cfg), x)
    return _attention(p, x, cfg)


def _full_attention(q, k, v, cfg: AttnConfig) -> torch.Tensor:
    s = q.shape[1]
    if s <= cfg.dense_threshold:
        return dense_attention(q, k, v, causal=cfg.causal)
    return flash_attention(q, k, v, cfg.causal, _largest_block(s, cfg.kv_block))


def _attention_shard(p, x_full: torch.Tensor, cfg: AttnConfig, i: int, n: int) -> torch.Tensor:
    """Model rank ``i`` of ``n``'s partial sum of the out-projection (in x's
    dtype): its ``h/n`` query heads (:func:`repro_torch.sharding.logical
    .weight`: narrows of whole weights, or stored shards gathered over
    ``data``), rope on the whole sequence's positions, dense or flash
    attention by ``dense_threshold``. With ``kv % n == 0`` the rank projects
    its own KV heads; otherwise K/V are projected whole (their stored spec
    then drops ``model``) and each query head takes its group
    ``(i * h_l + arange(h_l)) * kv // h``."""
    dtype = x_full.dtype
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h_l = h // n
    s = x_full.shape[1]
    kv_sharded = kv % n == 0
    kv_cut = {1: (i * (kv // n), kv // n)} if kv_sharded else {}
    wk, wv = logical.weight(p, "wk", kv_cut), logical.weight(p, "wv", kv_cut)
    q = torch.einsum("bsd,dhk->bshk", x_full, logical.weight(p, "wq", {1: (i * h_l, h_l)}).to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x_full, wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x_full, wv.to(dtype))
    if cfg.rope:
        sin, cos = rotary_embedding(torch.arange(s, device=x_full.device), hd, cfg.rope_base)
        q, k = apply_rotary(q, sin, cos), apply_rotary(k, sin, cos)
    if kv_sharded:
        k, v = _repeat_kv(k, h_l // k.shape[2]), _repeat_kv(v, h_l // v.shape[2])
    else:
        groups = (i * h_l + torch.arange(h_l, device=x_full.device)) * kv // h
        k, v = k.index_select(2, groups), v.index_select(2, groups)
    out = _full_attention(q, k, v, cfg)
    return torch.einsum("bshk,hkd->bsd", out, logical.weight(p, "wo", {0: (i * h_l, h_l)}).to(dtype)).to(dtype)


def _attention_explicit_tp(p, x: torch.Tensor, cfg: AttnConfig, lay) -> torch.Tensor:
    """Megatron-SP tensor parallelism (``repro/models/attention.py:263``):
    one all-gather of the sequence over ``model`` in, this rank's partial
    sum (:func:`_attention_shard`), reduce-scattered back along the
    sequence."""
    from ..launch.mesh import all_gather, psum_scatter

    x_full = all_gather(x, lay.mesh, "model", 1)
    return psum_scatter(_attention_shard(p, x_full, cfg, lay.idx, lay.tp), lay.mesh, "model", 1)


def _attention(p, x: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    s = x.shape[1]
    rope_sincos = None
    if cfg.rope:
        rope_sincos = rotary_embedding(torch.arange(s, device=x.device), cfg.head_dim, cfg.rope_base)
    q, k, v = _project_qkv(p, x, rope_sincos)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    return torch.einsum("bshk,hkd->bsd", _full_attention(q, k, v, cfg), p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Legacy decode path: a dense cache per request row
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-attention-layer decode cache. k/v: (B, S_max, KV, hd); index: 0-d
    int32 tensor, the fill length. With ``quant=True`` k/v are int8 and
    k_scale/v_scale (B, S_max, KV) f32 hold each row's scale, halving the
    cache's bytes against bf16; otherwise the scales are (1,) placeholders."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    index: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


def init_kv_cache(batch: int, max_seq: int, n_kv: int, head_dim: int, dtype=torch.bfloat16, *, quant: bool = False,
                  device=None) -> KVCache:
    shape = (batch, max_seq, n_kv, head_dim)
    scales = (batch, max_seq, n_kv) if quant else (1,)
    return KVCache(k=torch.zeros(shape, dtype=torch.int8 if quant else dtype, device=device),
                   v=torch.zeros(shape, dtype=torch.int8 if quant else dtype, device=device),
                   k_scale=torch.zeros(scales, dtype=torch.float32, device=device),
                   v_scale=torch.zeros(scales, dtype=torch.float32, device=device),
                   index=torch.zeros((), dtype=torch.int32, device=device))


def _quantize_kv(x: torch.Tensor):
    """x: (B, S, KV, hd) -> (int8 values, (B, S, KV) f32 scales): each row
    over hd scaled by its max |x| / 127, rounded half to even."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def attention_decode(p, x: torch.Tensor, cache: KVCache, cfg: AttnConfig) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x (B, 1, D); the cache holds ``index`` previous
    positions. Writes the new K/V at position ``index`` into the cache's
    tensors in place (an int8 cache: the quantized rows and their scales),
    then attends over positions ``<= index`` in f32 (grouped queries against
    the whole cache, masked beyond; an int8 cache's scales multiply the
    scores and the probabilities). Returns (y (B, 1, D), the cache with
    ``index + 1``). In the decode layout with ``tp > 1`` model ranks the
    cache is this rank's block of positions: :func:`_attention_decode_tp`."""
    b, s1, _ = x.shape
    if s1 != 1:
        raise ValueError(f"attention_decode takes one token per row, got {s1}")
    lay = logical.active_layout()
    if lay.decode and lay.tp > 1:
        return _attention_decode_tp(p, x, cache, cfg, lay)
    pos = cache.index.long()
    rope_sincos = None
    if cfg.rope:
        rope_sincos = rotary_embedding(pos[None], cfg.head_dim, cfg.rope_base)
    q, k_new, v_new = _project_qkv(p, x, rope_sincos)
    _write_kv(cache, k_new, v_new, pos, 0, None)
    out = _attend_cache(q, cache, pos, 0, None).to(x.dtype)
    y = logical.dot("bshk,hkd->bsd", out, p, "wo")
    return y, cache._replace(index=cache.index + 1)


def _write_kv(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, pos: torch.Tensor, start: int,
              owner) -> None:
    """Write the new K/V rows (an int8 cache: the quantized rows and their
    scales) at global position ``pos`` of a cache whose positions start at
    ``start``, in place. ``owner``: None (the cache holds ``pos``), or a
    bool tensor saying whether this rank's block holds it (the write then
    leaves a block that does not hold it unchanged)."""
    at = (pos - start).clamp(0, cache.k.shape[1] - 1)[None]

    def put(buf, new):
        buf.index_copy_(1, at, new if owner is None else torch.where(owner, new, buf.index_select(1, at)))

    if cache.quantized:
        k_q, k_s = _quantize_kv(k_new)
        v_q, v_s = _quantize_kv(v_new)
        for buf, new in ((cache.k, k_q), (cache.v, v_q), (cache.k_scale, k_s), (cache.v_scale, v_s)):
            put(buf, new)
    else:
        put(cache.k, k_new.to(cache.k.dtype))
        put(cache.v, v_new.to(cache.v.dtype))


def _attend_cache(q: torch.Tensor, cache: KVCache, pos: torch.Tensor, start: int, mesh) -> torch.Tensor:
    """One query a row, q (B, 1, H, hd), against the cache's positions
    ``start ..`` up to ``pos`` (masked beyond) in f32: grouped queries; an
    int8 cache's scales multiply the scores and the probabilities. ``mesh``:
    None (the cache whole), or the mesh whose ``model`` ranks hold the
    cache's blocks in order: each block's (unnormalised output, max, sum)
    are all-gathered and combined (:func:`_lse_combine`). Returns the f32
    output (B, 1, H, hd)."""
    b, _, h, hd = q.shape
    kv = cache.k.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, hd).float() * (1.0 / math.sqrt(hd))
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, cache.k.float())
    if cache.quantized:
        scores = scores * cache.k_scale.transpose(1, 2)[:, :, None, None, :]
    valid = start + torch.arange(cache.k.shape[1], device=q.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    if mesh is None:
        probs = torch.softmax(scores, dim=-1)
        if cache.quantized:
            probs = probs * cache.v_scale.transpose(1, 2)[:, :, None, None, :]
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cache.v.float())
    else:
        from ..launch.mesh import all_gather

        m = scores.amax(dim=-1, keepdim=True)
        e = torch.where(valid, torch.exp(scores - m), 0.0)
        den = e.sum(dim=-1, keepdim=True)
        if cache.quantized:
            e = e * cache.v_scale.transpose(1, 2)[:, :, None, None, :]
        acc = torch.einsum("bgrqk,bkgd->bgrqd", e, cache.v.float())
        out = _lse_combine(all_gather(torch.cat([acc, m, den], dim=-1)[None], mesh, "model", 0), hd)
        out = out.permute(0, 3, 1, 2, 4)
    return out.reshape(b, 1, h, hd)


def _heads_of_ranks(parts: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """(tp, B, 1, heads, hd) gathered over ``model`` -> (B, 1, tp * n, hd):
    heads ``lo .. lo + n`` of every rank's part, in rank (= global head)
    order."""
    t, b = parts.shape[:2]
    return parts[..., lo:lo + n, :].permute(1, 2, 0, 3, 4).reshape(b, 1, t * n, parts.shape[-1])


def _lse_combine(parts: torch.Tensor, hd: int) -> torch.Tensor:
    """The model ranks' blocks of one attention, (tp, ..., hd + 2): each
    block's unnormalised f32 output, running max and sum. Combined by
    log-sum-exp in rank order, so every rank gets the same bits. A block
    whose positions all lie beyond the query (max NEG_INF, sum 0) adds
    nothing."""
    m = parts[..., hd:hd + 1].amax(dim=0)
    acc = den = None
    for part in parts:
        w = torch.exp(part[..., hd:hd + 1] - m)
        a, d = part[..., :hd] * w, part[..., hd + 1:] * w
        acc, den = (a, d) if acc is None else (acc + a, den + d)
    return acc / den


def _attention_decode_tp(p, x: torch.Tensor, cache: KVCache, cfg: AttnConfig, lay) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode in the decode layout on ``tp`` model ranks, the
    cache this rank's block of ``lay.seq_kv`` positions (``seq_kv`` over
    ``model``; whole on every rank where ``tp`` does not divide them). With
    the heads divisible (the parallel form): q, k and v for this rank's
    heads (``wk``/``wv`` cut on KV heads where ``kv % tp == 0``, else
    whole, as :func:`_attention_shard`), from the stored shards as they lie
    (:func:`repro_torch.sharding.logical.dot`: no weight is gathered), then
    one all-gather over ``model`` gives every rank every head. Otherwise
    (the fallback, counted) every rank projects every head. The owner of position
    ``index`` writes its K/V rows (an int8 cache: the quantized rows and
    scales) into its block; each rank attends its block for every head in
    f32, masked by global position; on a split cache one all-gather of the
    blocks' (output, max, sum) and a log-sum-exp combine in rank order
    (:func:`_lse_combine`) complete it. ``wo`` is row-parallel on the
    rank's heads, completed by a ``psum``."""
    from ..launch.mesh import all_gather, psum

    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n, i, mesh = lay.tp, lay.idx, lay.mesh
    par = h % n == 0
    lay.count("attn", par)
    h_l = h // n if par else h
    kv_split = par and kv % n == 0
    kv_l = kv // n if kv_split else kv
    pos = cache.index.long()
    rope_sincos = rotary_embedding(pos[None], hd, cfg.rope_base) if cfg.rope else None
    q, k_new, v_new = _project_qkv(p, x, rope_sincos, (i * h_l, h_l) if par else None,
                                   (i * kv_l, kv_l) if kv_split else None)
    if par:
        parts = all_gather((torch.cat([q, k_new, v_new], dim=2) if kv_split else q)[None], mesh, "model", 0)
        q = _heads_of_ranks(parts, 0, h_l)
        if kv_split:
            k_new, v_new = _heads_of_ranks(parts, h_l, kv_l), _heads_of_ranks(parts, h_l + kv_l, kv_l)

    total = lay.seq_kv or cache.k.shape[1]
    start, blk = lay.block("seq_kv", total)
    if cache.k.shape[1] != blk:
        raise ValueError(f"attention_decode: the rank's cache holds {cache.k.shape[1]} positions, its block of "
                         f"{total} is {blk}")
    split = blk != total
    _write_kv(cache, k_new, v_new, pos, start, ((pos >= start) & (pos < start + blk)) if split else None)
    out = _attend_cache(q, cache, pos, start, mesh if split else None).to(x.dtype)
    if par:
        y = psum(logical.dot("bshk,hkd->bsd", out.narrow(2, i * h_l, h_l), p, "wo", {0: (i * h_l, h_l)}), mesh,
                 "model")
    else:
        y = logical.dot("bshk,hkd->bsd", out, p, "wo")
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
