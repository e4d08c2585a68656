"""Decoder backbone (port of ``repro/models/transformer.py``, training forward
for the ``pattern=(attn, dense)`` family: gpt_small).

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
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import AttnConfig, attention_forward, attention_specs
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
    pos: str = "rope"                    # 'learned' is ported; 'rope' is not yet
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
    x = _norm(cfg, _sub(params, "final_norm."), x)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    logits = x @ head.to(cfg.dtype).T
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
