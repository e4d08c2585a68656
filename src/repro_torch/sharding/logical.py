"""Logical-axis sharding: one rule table maps model axis names to mesh axes
(port of ``repro/sharding/logical.py``).

Models name each parameter dim with a logical axis ('embed', 'mlp',
'heads', ...; ``ParamMeta.axes``). A :class:`ShardingContext` installed
with :func:`use_sharding` resolves them to :class:`PartitionSpec`s for its
mesh; the trainer reads it to shard the optimizer state and the SNR pass.

Divisibility guard: a logical axis whose dim does not divide the mapped
mesh-axis size falls back to replication for that dim, so one rule table
serves every architecture.

The port's forward runs whole on each rank over its slice of the batch, so
the activation rules (``act_*``, ``seq_sp``) resolve but nothing applies
them: :func:`constrain` is a no-op. Tensor parallelism of the forward is a
later slice.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from .shardspec import PartitionSpec as P

MeshAxes = Union[None, str, Tuple[str, ...]]

_ctx = threading.local()


def default_rules(mesh) -> Dict[str, MeshAxes]:
    """The production rule table (FSDP x TP x EP (+ pod DP))."""
    has_pod = "pod" in mesh.axis_names
    batch: MeshAxes = ("pod", "data") if has_pod else ("data",)
    return {
        # activations
        "batch": batch,
        "seq": None,
        "seq_sp": "model",
        "seq_kv": "model",
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        # parameters
        "embed": "data",      # FSDP axis
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "experts": "model",   # EP
        "layers": None,
        "d_inner": "model",
        "state": None,
        "conv_w": None,
        "dt_rank": None,
        "frame": None,
        "patch": None,
        "pos": None,
    }


class ShardingContext:
    """A mesh (``repro_torch.launch.mesh.Mesh`` or a device-free
    ``SpecMesh``) plus the rule table, ``default_rules`` updated by
    ``rules``."""

    def __init__(self, mesh, rules: Optional[Mapping[str, MeshAxes]] = None):
        self.mesh = mesh
        self.rules = dict(default_rules(mesh))
        if rules:
            self.rules.update(rules)

    def spec_for(self, logical_axes: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None,
                 *, allow_pad: bool = False) -> P:
        """PartitionSpec for logical axes, with the divisibility fallback
        (``allow_pad`` keeps an uneven split where the dim is at least the
        axis size, as the JAX package allows for intermediates)."""
        entries = []
        used: set = set()
        for i, name in enumerate(logical_axes):
            mesh_axes = self.rules.get(name) if name else None
            if mesh_axes is None:
                entries.append(None)
                continue
            axes_t = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            # a mesh axis may appear at most once in a PartitionSpec
            axes_t = tuple(a for a in axes_t if a not in used and a in self.mesh.axis_names)
            if not axes_t:
                entries.append(None)
                continue
            size = math.prod(int(self.mesh.shape[a]) for a in axes_t)
            if shape is not None and shape[i] % size != 0:
                if allow_pad and shape[i] >= size:
                    used.update(axes_t)
                    entries.append(axes_t if len(axes_t) > 1 else axes_t[0])
                else:
                    entries.append(None)
                continue
            used.update(axes_t)
            entries.append(axes_t if len(axes_t) > 1 else axes_t[0])
        return P(*entries)


def current() -> Optional[ShardingContext]:
    return getattr(_ctx, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    prev = getattr(_ctx, "ctx", None)
    _ctx.ctx = ctx
    try:
        yield ctx
    finally:
        _ctx.ctx = prev


def constrain(x: Any, *logical_axes: Optional[str]) -> Any:
    """The JAX package's activation sharding constraint. A no-op in the
    port: each rank's forward runs whole on its slice of the batch."""
    return x


def param_specs(meta: Mapping[str, Any], params: Mapping[str, Any]) -> Dict[str, P]:
    """``{name: PartitionSpec}`` for a parameter dict from its ``{name:
    ParamMeta}`` dict, under the active context (``P()`` without one)."""
    ctx = current()
    return {k: (ctx.spec_for(meta[k].axes, tuple(p.shape)) if ctx is not None else P())
            for k, p in params.items()}
