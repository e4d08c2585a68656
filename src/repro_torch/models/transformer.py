"""Decoder and encoder backbone (port of ``repro/models/transformer.py``:
the training forward, the legacy decode step with its ``DecodeCache``, and
the paged serving steps), for layer slots of an attention or Mamba mixer
with a dense, MoE or no FFN: the dense ``(attn, dense)`` stacks (gpt_small,
smollm_135m, qwen15_32b with its qkv biases, command_r_35b, deepseek_67b),
falcon_mamba_7b ``(mamba, None)``, olmoe_1b_7b and qwen3_moe_30b_a3b
``(attn, moe)``, and jamba_v01_52b's hybrid period of Mamba and attention
mixers over dense and MoE FFNs.

Three input kinds, as in JAX: tokens through the embedding (with learned
positions, and with the VLM's ``frontend_embeds`` prepended:
internvl2_26b), patches through ``input_proj`` (vit_small), or frame
embeddings fed as they are (hubert_xlarge); the last two are non-causal
encoders with an untied ``lm_head`` and no decode step.

The parameter tree is JAX's, leaf for leaf: dotted names
(``blocks.slot_0.attn.wq``), layers stacked along a leading ``layers`` axis
(``wq`` is ``(n_layers, d, heads, head_dim)``), and JAX's sorted tree order.
SlimAdam's rules, reduced-moment shapes, megaplan groups and savings all
depend on that, so :class:`Transformer` holds one ``nn.Parameter`` per JAX
leaf and the forward indexes layer ``l`` out of the stacked tensors.
Activations run in ``cfg.dtype`` (bf16 at full size) with the f32
parameters cast at use, as the JAX model does. The MoE layers' auxiliary
losses are summed over the layers into the forward's second output.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (
    AttnConfig,
    attention_decode,
    attention_forward,
    attention_paged_decode,
    attention_paged_prefill,
    attention_specs,
    init_kv_cache,
)
from .common import (
    ParamModel,
    ParamSpec,
    abstract_params,
    init_params,
    layer_norm,
    meta_tree,
    mitchell_residual_init,
    normal_init,
    ones_init,
    rms_norm,
    stack_specs,
    torch_default_init,
)
from .mlp_moe import MoEConfig, mlp_forward, mlp_specs, moe_forward, moe_specs
from .ssm import SSMConfig, init_ssm_cache, ssm_decode, ssm_forward, ssm_specs

# The layer slots ported: (mixer, ffn). A slot without a mixer is not.
PORTED_SLOTS = tuple((mixer, ffn) for mixer in ("attn", "mamba") for ffn in ("dense", "moe", None))


@dataclasses.dataclass(frozen=True)
class LayerSlot:
    mixer: Optional[str]  # 'attn' | 'mamba' | None (not ported)
    ffn: Optional[str]    # 'dense' | 'moe' | None


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
    pos: str = "rope"                    # 'rope' | 'learned' | 'none'
    max_position: int = 8192             # learned-position table size
    embed_inputs: bool = True            # False: the model takes (B, S, D) embeddings (the audio stub)
    extra_embed_len: int = 0             # VLM: frontend embeddings prepended to the tokens
    input_proj_dim: int = 0              # > 0: a learned projection of raw patch features
    norm: str = "rmsnorm"                # 'rmsnorm' | 'layernorm'
    gated_mlp: bool = True
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256                 # the JAX chunked scan's chunk; the scan kernels do not use it
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    init_scheme: str = "mitchell"        # 'mitchell' | 'normal' | 'torch_default'
    attn_kv_block: int = 1024
    attn_dense_threshold: int = 2048
    kv_quant: bool = False               # int8 KV cache (the legacy serving loop): halves the cache's bytes

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
                          qkv_bias=self.qkv_bias, kv_block=self.attn_kv_block,
                          dense_threshold=self.attn_dense_threshold)

    def ssm_cfg(self) -> SSMConfig:
        return SSMConfig(d_model=self.d_model, d_inner=self.ssm_expand * self.d_model, d_state=self.ssm_state,
                         d_conv=self.ssm_conv)

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, top_k=self.top_k, d_model=self.d_model, d_ff=self.d_ff,
                         gated=self.gated_mlp)

    def _inits(self):
        """(weights, residual-stream writers, embeddings) initializers of
        ``init_scheme``: 'mitchell', 'normal' (mitchell without the 1/depth
        residual scaling) or 'torch_default' (paper §4.3)."""
        if self.init_scheme == "torch_default":
            w = torch_default_init()
            return w, w, w
        w = normal_init(0.02)
        if self.init_scheme == "normal":
            return w, w, normal_init(0.02)
        if self.init_scheme != "mitchell":
            raise ValueError(f"unknown init_scheme {self.init_scheme!r}")
        return w, mitchell_residual_init(0.02, self.n_layers), normal_init(0.02)

    def _norm_specs(self):
        return {"scale": ParamSpec((self.d_model,), ("embed",), "norm", ones_init(), dtype=self.param_dtype)}

    def slot_specs(self, slot: LayerSlot) -> Dict[str, Any]:
        if (slot.mixer, slot.ffn) not in PORTED_SLOTS:
            raise NotImplementedError(f"layer slot {slot} is not ported yet")
        w_init, resid_init, _ = self._inits()

        def with_dtype(tree):
            return {k: dataclasses.replace(s, dtype=self.param_dtype) for k, s in tree.items()}

        specs: Dict[str, Any] = {"mixer_norm": self._norm_specs()}
        if slot.mixer == "attn":
            specs["attn"] = with_dtype(attention_specs(self.d_model, self.n_heads, self.n_kv_heads, self.hd,
                                                       qkv_bias=self.qkv_bias, o_init=resid_init, w_init=w_init))
        else:
            specs["ssm"] = with_dtype(ssm_specs(self.ssm_cfg(), w_init=w_init, out_init=resid_init))
        if slot.ffn == "dense":
            specs["ffn_norm"] = self._norm_specs()
            specs["mlp"] = with_dtype(mlp_specs(self.d_model, self.d_ff, gated=self.gated_mlp, w_init=w_init,
                                                down_init=resid_init))
        elif slot.ffn == "moe":
            specs["ffn_norm"] = self._norm_specs()
            specs["moe"] = with_dtype(moe_specs(self.moe_cfg(), w_init=w_init, down_init=resid_init))
        return specs

    def specs(self) -> Dict[str, Any]:
        w_init, _, emb_init = self._inits()
        dt = self.param_dtype
        specs: Dict[str, Any] = {}
        if self.embed_inputs:
            specs["embed"] = ParamSpec((self.vocab_size, self.d_model), ("vocab", "embed"), "token_embedding",
                                       emb_init, fan_in=("vocab",), fan_out=("embed",), dtype=dt)
        if self.pos == "learned":
            specs["pos_embed"] = ParamSpec((self.max_position, self.d_model), ("pos", "embed"),
                                           "pos_embedding", emb_init, dtype=dt)
        if self.input_proj_dim:
            specs["input_proj"] = ParamSpec((self.input_proj_dim, self.d_model), ("patch", "embed"), "patch_embed",
                                            w_init, fan_in=("patch",), fan_out=("embed",), dtype=dt)
        specs["blocks"] = {f"slot_{i}": stack_specs(self.slot_specs(slot), self.n_periods)
                           for i, slot in enumerate(self.pattern)}
        specs["final_norm"] = self._norm_specs()
        if not self.tie_embeddings or not self.embed_inputs:
            specs["lm_head"] = ParamSpec((self.d_model, self.vocab_size), ("embed", "vocab"), "lm_head",
                                         w_init, fan_in=("embed",), fan_out=("vocab",), dtype=dt)
        return specs

    def param_count(self) -> int:
        return sum(int(torch.Size(s.shape).numel()) for s in _spec_leaves(self.specs()))

    def init(self, gen: torch.Generator, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        spec = self.specs()
        return init_params(spec, gen, device), meta_tree(spec)

    def abstract(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """(parameters as ``meta`` tensors, meta): shapes and dtypes of a
        model of any size, nothing allocated."""
        spec = self.specs()
        return abstract_params(spec), meta_tree(spec)


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


def _ffn(cfg: ModelConfig, slot: LayerSlot, p, x, with_aux: bool = True):
    """The slot's FFN residual block: (x, the MoE's aux loss, or None
    without an MoE or with ``with_aux=False``, as the decode steps ask)."""
    if slot.ffn == "dense":
        return x + mlp_forward(p["mlp"], _norm(cfg, p["ffn_norm"], x), gated=cfg.gated_mlp), None
    if slot.ffn == "moe":
        y, aux = moe_forward(p["moe"], _norm(cfg, p["ffn_norm"], x), cfg.moe_cfg(), with_aux=with_aux)
        return x + y, aux
    return x, None


def _slot_forward(cfg: ModelConfig, slot: LayerSlot, p, x, ssm_impl: str = "kernel"):
    """One layer slot: the mixer's residual block, then the FFN's. Returns
    (x, the MoE's f32 aux loss or None without one)."""
    if slot.mixer == "attn":
        x = x + attention_forward(p["attn"], _norm(cfg, p["mixer_norm"], x), cfg.attn_cfg())
    elif slot.mixer == "mamba":
        x = x + ssm_forward(p["ssm"], _norm(cfg, p["mixer_norm"], x), cfg.ssm_cfg(), impl=ssm_impl)
    return _ffn(cfg, slot, p, x)


def _layers(cfg: ModelConfig, params: Dict[str, torch.Tensor]):
    """(period, slot index, slot, that layer's parameters) in the JAX scan's
    order: periods outer, the pattern's slots inner."""
    slots = [(_unstack(_sub(params, f"blocks.slot_{i}."), cfg.n_periods), slot) for i, slot in enumerate(cfg.pattern)]
    for period in range(cfg.n_periods):
        for i, (per_layer, slot) in enumerate(slots):
            yield period, i, slot, per_layer[period]


def _embed(cfg: ModelConfig, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The model's input (B, S_total, D) in cfg.dtype from the batch: token
    embeddings (plus learned positions; the VLM's ``frontend_embeds``
    prepended), ``patches @ input_proj`` plus learned positions, or
    ``frontend_embeds`` as they are."""
    if cfg.embed_inputs:
        tokens = batch["tokens"].long()
        x = params["embed"][tokens].to(cfg.dtype)
        if cfg.pos == "learned":
            x = x + params["pos_embed"][: tokens.shape[1]][None].to(cfg.dtype)
        if cfg.extra_embed_len:
            x = torch.cat([batch["frontend_embeds"].to(cfg.dtype), x], dim=1)
        return x
    if cfg.input_proj_dim:
        x = torch.einsum("bsp,pd->bsd", batch["patches"].to(cfg.dtype), params["input_proj"].to(cfg.dtype))
        if cfg.pos == "learned":
            x = x + params["pos_embed"][: x.shape[1]][None].to(cfg.dtype)
        return x
    return batch["frontend_embeds"].to(cfg.dtype)


def forward(cfg: ModelConfig, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], *,
            ssm_impl: str = "kernel"):
    """Training forward. batch: {'tokens': (B, S) int} (with
    'frontend_embeds' (B, P, D) for a VLM), {'patches': (B, S, P)} or
    {'frontend_embeds': (B, S, D)}, by the model's input kind. Returns
    (logits (B, S_total, vocab) in cfg.dtype, the f32 aux loss summed over
    the layers) like the JAX forward.
    ``ssm_impl="plain"`` runs the Mamba layers' scan through the kernel's
    plain twin, an explicit choice for comparisons."""
    x = _embed(cfg, params, batch)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, _, slot, p in _layers(cfg, params):
        if remat:
            x, a = checkpoint(_slot_forward, cfg, slot, p, x, ssm_impl, use_reentrant=False)
        else:
            x, a = _slot_forward(cfg, slot, p, x, ssm_impl)
        if a is not None:
            aux = aux + a
    return _logits(cfg, params, x), aux


class Transformer(ParamModel):
    """The decoder as an ``nn.Module``: one parameter per JAX leaf, in tree
    order (``names``), plus the ``meta`` dict the optimizer rules read."""

    def forward(self, batch: Dict[str, torch.Tensor]):
        return forward(self.cfg, self.params, batch)


# ---------------------------------------------------------------------------
# Decode (the legacy serving loop)
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """The legacy loop's per-request caches. ``slots``: per mixer slot, a
    :class:`KVCache` or :class:`SSMCache` whose tensors are stacked over the
    periods (leading dim ``n_periods``) and updated in place by
    :func:`decode_step`; ``step``: tokens consumed so far."""

    slots: Dict[str, Any]
    step: int


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device=None) -> DecodeCache:
    """Zeroed caches for ``batch`` rows of up to ``max_seq`` positions: KV
    caches in ``dtype`` for attention slots; for Mamba slots the conv
    history in ``dtype`` and the state in f32, as the JAX cache keeps them."""
    slots: Dict[str, Any] = {}
    for i, slot in enumerate(cfg.pattern):
        if slot.mixer == "attn":
            c = init_kv_cache(batch, max_seq, cfg.n_kv_heads, cfg.hd, dtype, quant=cfg.kv_quant, device=device)
        elif slot.mixer == "mamba":
            c = init_ssm_cache(batch, cfg.ssm_cfg(), dtype, device=device)
        else:
            continue
        slots[f"slot_{i}"] = type(c)(*(t[None].repeat((cfg.n_periods,) + (1,) * t.ndim) for t in c))
    return DecodeCache(slots=slots, step=0)


def abstract_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16) -> DecodeCache:
    """:func:`init_decode_cache`'s shapes and dtypes on the ``meta`` device:
    nothing is allocated, so a full-size cell's cache can be sized."""
    return init_decode_cache(cfg, batch, max_seq, dtype, device="meta")


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Dict[str, torch.Tensor], cache: DecodeCache, tokens: torch.Tensor, *,
                ssm_impl: str = "kernel"):
    """One new token per row. tokens: (B, 1) int. The caches hold
    ``cache.step`` positions. Returns (logits (B, 1, vocab), the cache with
    ``step + 1``); each layer's cache tensors are written in place. A model
    without an embedding takes (B, 1, D) embeddings as ``tokens``, as in
    JAX. ``ssm_impl="plain"`` runs the scan's plain twin, for comparisons."""
    x = params["embed"][tokens.long()].to(cfg.dtype) if cfg.embed_inputs else tokens
    if cfg.pos == "learned":
        x = x + params["pos_embed"][cache.step][None, None].to(cfg.dtype)
    for period, i, slot, p in _layers(cfg, params):
        if slot.mixer in ("attn", "mamba"):
            stacked = cache.slots[f"slot_{i}"]
            c = type(stacked)(*(t[period] for t in stacked))
            h = _norm(cfg, p["mixer_norm"], x)
            if slot.mixer == "attn":
                y, nc = attention_decode(p["attn"], h, c, cfg.attn_cfg())
            else:
                y, nc = ssm_decode(p["ssm"], h, c, cfg.ssm_cfg(), impl=ssm_impl)
            x = x + y
            for buf, new in zip(c, nc):
                if new.data_ptr() != buf.data_ptr():
                    buf.copy_(new)
        x, _ = _ffn(cfg, slot, p, x, with_aux=False)
    logits = _logits(cfg, params, x)
    return logits, DecodeCache(slots=cache.slots, step=cache.step + 1)


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
    """The paged fast path covers token-in, token-out attention-only stacks.
    SSM mixers carry recurrent (not positional) state and the pages hold no
    int8 form, so those serve through the legacy decode loop; the encoders
    (no embedding) have no decode step at all."""
    return (cfg.embed_inputs and not cfg.kv_quant and all(s.mixer in ("attn", None) for s in cfg.pattern)
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
    the slot's FFN (dense or MoE)."""
    for period, i, slot, p in _layers(cfg, params):
        if slot.mixer == "attn":
            x = x + attn_step(p["attn"], _norm(cfg, p["mixer_norm"], x), pools[f"slot_{i}"][period])
        x, _ = _ffn(cfg, slot, p, x, with_aux=False)
    return x


def _logits(cfg: ModelConfig, params, x):
    """The final norm, then the tied embedding (a token model that ties) or
    ``lm_head``."""
    x = _norm(cfg, _sub(params, "final_norm."), x)
    if cfg.tie_embeddings and cfg.embed_inputs:
        return x @ params["embed"].to(cfg.dtype).T
    return x @ params["lm_head"].to(cfg.dtype)


@torch.no_grad()
def paged_decode_step(cfg: ModelConfig, params: Dict[str, torch.Tensor], state: PagedState,
                      tokens: torch.Tensor, *, attn_impl: str = "kernel"):
    """One new token for every active batch row. tokens: (B, 1) int.

    Returns (logits (B, 1, vocab), ok (B,) bool, new PagedState); the pools
    are written in place and lengths advance on active rows only. ``ok`` is
    the on-device logit health tap: per-row all-finite flags, so the engine
    retires a poisoned row without scanning the vocabulary on the host.
    ``attn_impl="plain"`` runs attention through the kernel's plain twin:
    an explicit choice for comparisons, and the engine's degraded step after
    an injected ``serve.kernel`` failure (``repro_torch.serve.engine``).
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
