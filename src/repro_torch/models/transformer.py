"""Decoder backbone (port of ``repro/models/transformer.py``: the training
forward and the paged serving steps for the ``pattern=(attn, dense)``
family, gpt_small and smollm_135m).

The parameter tree is JAX's, leaf for leaf: dotted names
(``blocks.slot_0.attn.wq``), layers stacked along a leading ``layers`` axis
(``wq`` is ``(n_layers, d, heads, head_dim)``), and JAX's sorted tree order.
SlimAdam's rules, reduced-moment shapes, megaplan groups and savings all
depend on that, so :class:`Transformer` holds one ``nn.Parameter`` per JAX
leaf and the forward indexes layer ``l`` out of the stacked tensors.
Activations run in ``cfg.dtype`` (bf16 at full size) with the f32
parameters cast at use, as the JAX model does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import (
    AttnConfig,
    attention_forward,
    attention_paged_decode,
    attention_paged_prefill,
    attention_specs,
)
from .common import (
    ParamSpec,
    init_params,
    layer_norm,
    meta_tree,
    mitchell_residual_init,
    normal_init,
    ones_init,
    rms_norm,
    stack_specs,
)
from .mlp_moe import mlp_forward, mlp_specs


@dataclasses.dataclass(frozen=True)
class LayerSlot:
    mixer: Optional[str]  # 'attn' (ported) | 'mamba'
    ffn: Optional[str]    # 'dense' (ported) | 'moe'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    pattern: Tuple[LayerSlot, ...] = (LayerSlot("attn", "dense"),)
    causal: bool = True
    tie_embeddings: bool = True
    pos: str = "rope"                    # 'rope' | 'learned'
    max_position: int = 8192
    norm: str = "rmsnorm"                # 'rmsnorm' | 'layernorm'
    gated_mlp: bool = True
    qkv_bias: bool = False
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    init_scheme: str = "mitchell"
    attn_dense_threshold: int = 2048

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"n_layers {self.n_layers} is not a multiple of the pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                          head_dim=self.hd, causal=self.causal, rope=(self.pos == "rope"),
                          qkv_bias=self.qkv_bias, dense_threshold=self.attn_dense_threshold)

    def _inits(self):
        if self.init_scheme != "mitchell":
            raise NotImplementedError(f"init_scheme {self.init_scheme!r} is not ported yet")
        w = normal_init(0.02)
        return w, mitchell_residual_init(0.02, self.n_layers), normal_init(0.02)

    def _norm_specs(self):
        return {"scale": ParamSpec((self.d_model,), ("embed",), "norm", ones_init(), dtype=self.param_dtype)}

    def slot_specs(self, slot: LayerSlot) -> Dict[str, Any]:
        if slot != LayerSlot("attn", "dense"):
            raise NotImplementedError(f"layer slot {slot} is not ported yet")
        w_init, resid_init, _ = self._inits()
        return {
            "mixer_norm": self._norm_specs(),
            "attn": attention_specs(self.d_model, self.n_heads, self.n_kv_heads, self.hd,
                                    qkv_bias=self.qkv_bias, o_init=resid_init, w_init=w_init),
            "ffn_norm": self._norm_specs(),
            "mlp": mlp_specs(self.d_model, self.d_ff, gated=self.gated_mlp, w_init=w_init,
                             down_init=resid_init),
        }

    def specs(self) -> Dict[str, Any]:
        w_init, _, emb_init = self._inits()
        dt = self.param_dtype
        specs: Dict[str, Any] = {
            "embed": ParamSpec((self.vocab_size, self.d_model), ("vocab", "embed"), "token_embedding",
                               emb_init, fan_in=("vocab",), fan_out=("embed",), dtype=dt),
        }
        if self.pos == "learned":
            specs["pos_embed"] = ParamSpec((self.max_position, self.d_model), ("pos", "embed"),
                                           "pos_embedding", emb_init, dtype=dt)
        specs["blocks"] = {f"slot_{i}": stack_specs(self.slot_specs(slot), self.n_periods)
                           for i, slot in enumerate(self.pattern)}
        specs["final_norm"] = self._norm_specs()
        if not self.tie_embeddings:
            specs["lm_head"] = ParamSpec((self.d_model, self.vocab_size), ("embed", "vocab"), "lm_head",
                                         w_init, fan_in=("embed",), fan_out=("vocab",), dtype=dt)
        return specs

    def param_count(self) -> int:
        return sum(int(torch.Size(s.shape).numel()) for s in _spec_leaves(self.specs()))

    def init(self, gen: torch.Generator, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        spec = self.specs()
        return init_params(spec, gen, device), meta_tree(spec)


def _spec_leaves(tree):
    for v in tree.values():
        yield from (_spec_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], None)


def _sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, Any]:
    """The nested view ``{'attn': {'wq': ...}, ...}`` of the leaves under
    ``prefix``, so the block code reads like the JAX model."""
    out: Dict[str, Any] = {}
    for name, t in params.items():
        if name.startswith(prefix):
            node = out
            *path, leaf = name[len(prefix):].split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t
    return out


def _unstack(tree, n: int):
    """Per-layer views of the stacked leaves, one ``unbind`` per leaf (its
    backward stacks the layer gradients once, where indexing layer by layer
    would build a full-size gradient per layer)."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for l in range(n):
            out[l][k] = parts[l]
    return out


def _slot_forward(cfg: ModelConfig, p, x):
    x = x + attention_forward(p["attn"], _norm(cfg, p["mixer_norm"], x), cfg.attn_cfg())
    return x + mlp_forward(p["mlp"], _norm(cfg, p["ffn_norm"], x), gated=cfg.gated_mlp)


def forward(cfg: ModelConfig, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
    """Training forward. batch: {'tokens': (B, S) int}. Returns (logits
    (B, S, vocab) in cfg.dtype, aux loss 0) like the JAX forward."""
    tokens = batch["tokens"].long()
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][: tokens.shape[1]][None].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, _ in enumerate(cfg.pattern):
        for p in _unstack(_sub(params, f"blocks.slot_{i}."), cfg.n_periods):
            if remat:
                x = checkpoint(_slot_forward, cfg, p, x, use_reentrant=False)
            else:
                x = _slot_forward(cfg, p, x)
    logits = _logits(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


class Transformer(nn.Module):
    """The model as an ``nn.Module``: one parameter per JAX leaf, in tree
    order (``names``), plus the ``meta`` dict the optimizer rules read."""

    def __init__(self, cfg: ModelConfig, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        tensors, self.meta = cfg.init(gen, device)
        self.names = tuple(tensors)
        self.leaves = nn.ParameterList([nn.Parameter(t) for t in tensors.values()])

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        """``{dotted name: parameter}`` in tree order."""
        return dict(zip(self.names, self.leaves))

    @torch.no_grad()
    def load_params(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Overwrite every parameter in place (e.g. with JAX-initialised
        values from :func:`repro_torch.convert.params_from_numpy`)."""
        if set(tensors) != set(self.names):
            raise ValueError(f"parameter names differ: {sorted(set(tensors) ^ set(self.names))[:5]}")
        for name, p in self.params.items():
            if tuple(tensors[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(tensors[name].shape)} != {tuple(p.shape)}")
            p.copy_(tensors[name])

    def forward(self, batch: Dict[str, torch.Tensor]):
        return forward(self.cfg, self.params, batch)


# ---------------------------------------------------------------------------
# Paged decode (serving fast path)
#
# KV lives in per-slot page pools shared by every in-flight request and
# addressed through a per-slot-row page table (repro_torch.serve.kvpool owns
# the host-side allocation; repro_torch.kernels.paged_attention does the
# ragged reduction). Admitting or retiring a request costs no device
# allocation. The steps write each layer's new K/V into its pool in place.
# ---------------------------------------------------------------------------


class PagedState(NamedTuple):
    """Device state for the paged decode path.

    pools:   {'slot_i': (n_periods, n_pages, page, 2*KV, hd)} per attn slot
    table:   (B, max_pages) int32 page ids; entry 0 = reserved null page
    lengths: (B,) int32 positions already stored per batch row
    active:  (B,) bool — inactive rows write to the null page and attend
             over 0 positions (their logits are garbage nobody samples)
    """

    pools: Dict[str, torch.Tensor]
    table: torch.Tensor
    lengths: torch.Tensor
    active: torch.Tensor


def supports_paged(cfg: ModelConfig) -> bool:
    """The paged fast path covers attention-only stacks (the port has no
    other mixer yet)."""
    return (all(s.mixer in ("attn", None) for s in cfg.pattern)
            and any(s.mixer == "attn" for s in cfg.pattern))


def init_paged_pools(cfg: ModelConfig, n_pages: int, page_size: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """One fused-layout page pool per attention slot, stacked over periods.
    Page 0 of every pool is the reserved null page (target of inactive and
    padded writes; never read, because those rows report length 0)."""
    return {f"slot_{i}": torch.zeros((cfg.n_periods, n_pages, page_size, 2 * cfg.n_kv_heads, cfg.hd),
                                     dtype=dtype, device=device)
            for i, slot in enumerate(cfg.pattern) if slot.mixer == "attn"}


def _paged_stack(cfg: ModelConfig, params: Dict[str, torch.Tensor], pools: Dict[str, torch.Tensor], x,
                 attn_step):
    """x through every period and slot of the stack, periods outer as in the
    JAX scan: ``attn_step(p_attn, x_normed, layer_pool)`` for the mixer, then
    the slot's MLP."""
    slots = [(_unstack(_sub(params, f"blocks.slot_{i}."), cfg.n_periods), pools.get(f"slot_{i}"), slot)
             for i, slot in enumerate(cfg.pattern)]
    for period in range(cfg.n_periods):
        for per_layer, pool, slot in slots:
            p = per_layer[period]
            if slot.mixer == "attn":
                x = x + attn_step(p["attn"], _norm(cfg, p["mixer_norm"], x), pool[period])
            if slot.ffn == "dense":
                x = x + mlp_forward(p["mlp"], _norm(cfg, p["ffn_norm"], x), gated=cfg.gated_mlp)
    return x


def _logits(cfg: ModelConfig, params, x):
    x = _norm(cfg, _sub(params, "final_norm."), x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    return x @ head.to(cfg.dtype).T


@torch.no_grad()
def paged_decode_step(cfg: ModelConfig, params: Dict[str, torch.Tensor], state: PagedState,
                      tokens: torch.Tensor, *, attn_impl: str = "kernel"):
    """One new token for every active batch row. tokens: (B, 1) int.

    Returns (logits (B, 1, vocab), ok (B,) bool, new PagedState); the pools
    are written in place and lengths advance on active rows only. ``ok`` is
    the on-device logit health tap: per-row all-finite flags, so the engine
    retires a poisoned row without scanning the vocabulary on the host.
    ``attn_impl="plain"`` runs attention through the kernel's plain twin, an
    explicit choice for comparisons; the engine never makes it.
    """
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.pos == "learned":
        posv = torch.clamp(state.lengths.long(), 0, cfg.max_position - 1)
        x = x + params["pos_embed"][posv][:, None].to(cfg.dtype)
    attn = cfg.attn_cfg()
    x = _paged_stack(cfg, params, state.pools, x, lambda p, h, pool: attention_paged_decode(
        p, h, pool, state.table, state.lengths, state.active, attn, attn_impl=attn_impl))
    logits = _logits(cfg, params, x)
    ok = torch.isfinite(logits.float()).flatten(1).all(dim=1)
    return logits, ok, PagedState(pools=state.pools, table=state.table,
                                  lengths=state.lengths + state.active.to(torch.int32), active=state.active)


@torch.no_grad()
def paged_prefill_chunk(cfg: ModelConfig, params: Dict[str, torch.Tensor], pools: Dict[str, torch.Tensor],
                        table_row: torch.Tensor, pos0: int, n_valid: int, tokens: torch.Tensor,
                        *, attn_impl: str = "kernel"):
    """Prefill one chunk of one request's prompt through the paged kernel.

    tokens: (1, C) int at absolute positions ``pos0 .. pos0 + C - 1``; chunk
    indices >= ``n_valid`` are padding (K/V routed to the null page).
    Returns (logits (1, C, vocab), ok () bool, pools), the pools written in
    place; the caller samples at chunk index ``n_valid - 1`` of the final
    chunk, and ``ok`` is the health tap of exactly that row.
    """
    c = tokens.shape[1]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    if cfg.pos == "learned":
        posv = torch.clamp(pos0 + torch.arange(c, device=x.device), 0, cfg.max_position - 1)
        x = x + params["pos_embed"][posv][None].to(cfg.dtype)
    attn = cfg.attn_cfg()
    x = _paged_stack(cfg, params, pools, x, lambda p, h, pool: attention_paged_prefill(
        p, h, pool, table_row, pos0, n_valid, attn, attn_impl=attn_impl))
    logits = _logits(cfg, params, x)
    ok = torch.isfinite(logits[0, n_valid - 1].float()).all()
    return logits, ok, pools
