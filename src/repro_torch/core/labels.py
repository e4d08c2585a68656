"""Parameter metadata: logical axes + paper layer roles (port of
``repro/core/labels.py``).

Models emit, beside their parameters, a flat ``{dotted name: ParamMeta}``
dict in tree order. ``repro_torch.core.rules`` reads the compression
candidates from it; ``repro_torch.core.snr`` reads the same candidates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Sequence, Tuple

# Axes that enumerate independent modules (depth, experts): the paper's
# mean-sharing never crosses them.
STRUCTURAL_AXES = frozenset({"layers", "experts"})

ROLES = (
    "token_embedding", "lm_head", "pos_embedding",
    "attn_q", "attn_k", "attn_v", "attn_o", "attn_qkv_bias",
    "mlp_up", "mlp_gate", "mlp_down", "moe_router", "norm", "bias",
    "ssm_in", "ssm_out", "ssm_x", "ssm_dt", "ssm_conv", "ssm_a", "ssm_d",
    "patch_embed", "frontend", "head", "conv",
)


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    """Static metadata for one parameter tensor."""

    axes: Tuple[str, ...]            # logical axis name per dim (len == ndim)
    role: str                        # one of ROLES
    # Axes acting as the paper's fan_in / fan_out (W: fan_in -> fan_out);
    # compression candidates are fan_in, fan_out and their union.
    fan_in: Tuple[str, ...] = ()
    fan_out: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown role {self.role!r}")
        for ax in self.fan_in + self.fan_out:
            if ax not in self.axes:
                raise ValueError(f"candidate axis {ax!r} not in axes {self.axes}")
            if ax in STRUCTURAL_AXES:
                raise ValueError(f"structural axis {ax!r} cannot be a compression candidate")

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def is_vector_like(self) -> bool:
        """Paper: vector-like moments (norm scales, biases) stay uncompressed."""
        return len([a for a in self.axes if a not in STRUCTURAL_AXES]) <= 1

    def dims_of(self, names: Sequence[str]) -> Tuple[int, ...]:
        """Resolve logical axis names to positional dims for this tensor."""
        return tuple(i for i, a in enumerate(self.axes) if a in set(names))

    def candidate_ks(self) -> Mapping[str, Tuple[str, ...]]:
        """Compression-candidate axis sets, keyed by the paper's K labels."""
        out: dict[str, Tuple[str, ...]] = {}
        if self.is_vector_like:
            return out
        if self.fan_in:
            out["fan_in"] = tuple(self.fan_in)
        if self.fan_out:
            out["fan_out"] = tuple(self.fan_out)
        if self.fan_in and self.fan_out:
            out["both"] = tuple(self.fan_in) + tuple(self.fan_out)
        return out


def path_str(path) -> str:
    """Dotted rendering of a key path: each part a dict key (``.key``), a
    sequence index (``.idx``), an attribute name (``.name``) or a plain
    key, as the JAX package renders its key paths."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return ".".join(parts)


def _walk(tree: Any, prefix: Tuple[str, ...]):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk(v, prefix + tuple(str(k).split(".")))
    else:
        yield prefix, tree


def flatten_with_names(tree: Any) -> List[Tuple[str, Any]]:
    """[(dotted name, leaf)] in JAX's tree order: keys sorted level by level,
    i.e. by the tuple of path parts. Takes nested dicts or flat dicts with
    dotted keys (both give the same order). Unlike the JAX original it
    returns no treedef: the port's trees are flat dicts in this order."""
    leaves = sorted(_walk(tree, ()), key=lambda kv: kv[0])
    return [(".".join(path), leaf) for path, leaf in leaves]


def validate_meta(params: Any, meta: Any) -> None:
    """Check the metadata tree matches the parameter tree leaf for leaf
    (nested dicts or flat dotted-name dicts): the same names, a ParamMeta
    per leaf, one axis per dimension."""
    p_named, m_named = flatten_with_names(params), flatten_with_names(meta)
    p_names, m_names = [n for n, _ in p_named], [n for n, _ in m_named]
    if p_names != m_names:
        raise ValueError(f"param/meta tree mismatch; differing leaves: {sorted(set(p_names) ^ set(m_names))[:10]}")
    for (name, p), (_, m) in zip(p_named, m_named):
        if not isinstance(m, ParamMeta):
            raise TypeError(f"{name}: meta leaf is {type(m)}, want ParamMeta")
        if len(m.axes) != len(p.shape):
            raise ValueError(f"{name}: meta axes {m.axes} vs param ndim {len(p.shape)} (shape {tuple(p.shape)})")
