"""Compression-rule derivation (port of ``repro/core/rules.py``; paper §5).

A rule for one parameter is ``None`` (keep full second moments) or a tuple of
logical axis names to average the squared gradients over. Rules and
positional dims are flat dicts keyed by dotted parameter name.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

from .labels import flatten_with_names

Rule = Optional[Tuple[str, ...]]

DEFAULT_CUTOFF = 1.0  # SNR >~ 1 <=> signal dominates noise (paper §3)


def derive_rules(avg_snr: Mapping[str, Mapping[str, float]], meta: Any, *,
                 cutoff: float = DEFAULT_CUTOFF) -> Dict[str, Rule]:
    """SNR-guided rules: the argmax-SNR candidate if it reaches ``cutoff``.
    ``avg_snr`` is ``SNRTracker.averaged()``."""
    rules: Dict[str, Rule] = {}
    for name, m in flatten_with_names(meta):
        cands = m.candidate_ks()
        if not cands:  # vector-like: paper leaves uncompressed
            rules[name] = None
            continue
        scores = avg_snr.get(name, {})
        best_label, best_val = None, -math.inf
        for label in cands:
            v = float(scores.get(label, -math.inf))
            if v > best_val:
                best_label, best_val = label, v
        rules[name] = cands[best_label] if best_label is not None and best_val >= cutoff else None
    return rules


# Paper Table 3 (recommended compression dimensions per layer role), resolved
# per tensor through the meta's candidate sets; absent roles stay dense.
_TABLE3: Dict[str, Optional[str]] = {
    "attn_q": "fan_in", "attn_k": "fan_in", "attn_v": "fan_out", "attn_o": "fan_out",
    "mlp_up": "fan_out", "mlp_gate": "fan_out", "mlp_down": "fan_out",
    # Token embedding: compress the embedding dim, never the token dim.
    "token_embedding": "fan_out", "lm_head": "fan_in",
    "patch_embed": "fan_in", "head": "fan_in", "conv": "fan_in",
    "norm": None, "bias": None, "attn_qkv_bias": None, "pos_embedding": None,
    "moe_router": None,
    "ssm_in": "fan_out", "ssm_out": "fan_out", "ssm_x": "fan_in", "ssm_dt": "fan_in",
    "ssm_conv": None, "ssm_a": None, "ssm_d": None, "frontend": None,
}


def table3_rules(meta: Any, *, overrides: Optional[Mapping[str, Optional[str]]] = None) -> Dict[str, Rule]:
    """Static rules from paper Table 3, keyed by dotted param name."""
    table = dict(_TABLE3)
    if overrides:
        table.update(overrides)
    rules: Dict[str, Rule] = {}
    for name, m in flatten_with_names(meta):
        cands = m.candidate_ks()
        label = table.get(m.role)
        rules[name] = cands[label] if cands and label in cands else None
    return rules


def rules_to_dims(rules: Mapping[str, Rule], meta: Any) -> Dict[str, Tuple[int, ...]]:
    """Resolve logical-axis rules to positional reduction dims per param."""
    return {name: (m.dims_of(rules[name]) if rules.get(name) else ())
            for name, m in flatten_with_names(meta)}


def rules_as_tree(rules: Mapping[str, Rule], params: Any, meta: Any) -> Dict[str, Tuple[int, ...]]:
    """``{name: positional dims}`` in the params' tree order (the port's
    trees are flat dicts, so the "tree" is that dict)."""
    dims = rules_to_dims(rules, meta)
    return {name: dims[name] for name, _ in flatten_with_names(params)}


def second_moment_savings(params: Any, meta: Any, rules: Mapping[str, Rule]) -> Dict[str, float]:
    """Fraction of Adam's second-moment entries eliminated (paper Fig. 10 top).
    ``params`` leaves need only a ``.shape``."""
    total = kept = 0
    for (name, p), (_, m) in zip(flatten_with_names(params), flatten_with_names(meta)):
        shape = tuple(p.shape)
        n = math.prod(shape)
        total += n
        r = rules.get(name)
        if not r:
            kept += n
            continue
        dims = set(m.dims_of(r))
        kept += math.prod(s for i, s in enumerate(shape) if i not in dims)
    return {"total_second_moments": float(total), "stored_second_moments": float(kept),
            "saved_fraction": 1.0 - kept / max(total, 1)}
