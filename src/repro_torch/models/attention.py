"""Attention, training forward (port of the dense path of
``repro/models/attention.py``).

Projections are stored 3-D, ``(embed, heads, head_dim)``, exactly as in the
JAX model, so SlimAdam's head-stacked dims and the megaplan groups match.
Sequences up to ``dense_threshold`` take the O(S^2) dense attention, as the
JAX model does; the flash path above it is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .common import ParamSpec

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    rope: bool = True
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


def _project_qkv(p, x: torch.Tensor):
    """x: (B, S, D) -> q, k, v: (B, S, H, hd), weights cast to x's dtype at use."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    return q, k, v


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
    if cfg.rope or cfg.n_kv_heads != cfg.n_heads:
        raise NotImplementedError("rotary embeddings and grouped KV heads are not ported yet")
    if s > cfg.dense_threshold:
        raise NotImplementedError(f"sequence {s} > dense_threshold {cfg.dense_threshold}: "
                                  "the flash-attention path is not ported yet")
    q, k, v = _project_qkv(p, x)
    out = dense_attention(q, k, v, causal=cfg.causal)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
