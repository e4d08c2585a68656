"""Parameter specs, initializers and norms (port of ``repro/models/common.py``).

Every parameter is declared by a :class:`ParamSpec` carrying its logical axes
and paper role, which feed ``repro_torch.core`` (rules, SNR). Initializers
draw from a ``torch.Generator`` on the generator's device and are moved to
the target device afterwards: a CPU generator gives the same weights on
every device, and a CUDA generator initialises a large model on the card
without a host copy. They do not reproduce JAX's random bits: tests carry
JAX parameters across with ``repro_torch.convert`` and compare the port's
own init by statistics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.labels import ParamMeta, flatten_with_names

Initializer = Callable[[torch.Generator, Tuple[int, ...], torch.dtype], torch.Tensor]


def normal_init(std: float = 0.02) -> Initializer:
    def init(gen, shape, dtype):
        return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)

    return init


def uniform_init(bound: float) -> Initializer:
    """U(-bound, bound)."""
    def init(gen, shape, dtype):
        return ((torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0) * bound).to(dtype)

    return init


def mitchell_residual_init(std: float, n_layers: int) -> Initializer:
    """Mitchell init for residual-stream writers: std / sqrt(2 * n_layers)."""
    return normal_init(std / math.sqrt(2.0 * max(n_layers, 1)))


def torch_default_init() -> Initializer:
    """PyTorch's nn.Linear default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), with
    fan_in the product of all dims but the last (matrices are stored
    (in..., out))."""
    def init(gen, shape, dtype):
        fan_in = max(1, math.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        return uniform_init(1.0 / math.sqrt(fan_in))(gen, shape, dtype)

    return init


def ones_init() -> Initializer:
    return lambda gen, shape, dtype: torch.ones(shape, dtype=dtype, device=gen.device)


def zeros_init() -> Initializer:
    return lambda gen, shape, dtype: torch.zeros(shape, dtype=dtype, device=gen.device)


def constant_init(v: float) -> Initializer:
    return lambda gen, shape, dtype: torch.full(shape, v, dtype=dtype, device=gen.device)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    role: str
    init: Initializer
    fan_in: Tuple[str, ...] = ()
    fan_out: Tuple[str, ...] = ()
    dtype: torch.dtype = torch.float32

    def meta(self) -> ParamMeta:
        return ParamMeta(axes=self.axes, role=self.role, fan_in=self.fan_in, fan_out=self.fan_out)


def init_params(spec_tree: Any, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Materialize ``{dotted name: tensor}`` in tree order from a (nested)
    ParamSpec dict, drawing leaves in that order from ``gen``."""
    return {name: s.init(gen, s.shape, s.dtype).to(device)
            for name, s in flatten_with_names(spec_tree)}


def abstract_params(spec_tree: Any) -> Dict[str, torch.Tensor]:
    """``{dotted name: tensor}`` in tree order on the ``meta`` device: each
    leaf's shape and dtype, nothing allocated (a 67 B model's tree costs no
    memory)."""
    return {name: torch.empty(s.shape, dtype=s.dtype, device="meta") for name, s in flatten_with_names(spec_tree)}


def meta_tree(spec_tree: Any) -> Dict[str, ParamMeta]:
    return {name: s.meta() for name, s in flatten_with_names(spec_tree)}


class ParamModel(nn.Module):
    """A model config's parameters as an ``nn.Module``: one parameter per
    JAX leaf of ``cfg.init``, in tree order (``names``), plus the ``meta``
    dict the optimizer rules read. Subclasses add the forward."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
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


def stack_specs(spec_tree: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Prepend a stacked 'layers' axis of size n to every spec."""

    def stack(s):
        if isinstance(s, dict):
            return {k: stack(v) for k, v in s.items()}

        def init(gen, shape, dtype, s=s):
            # Filled layer by layer: the same values as stacking the draws,
            # without holding them twice (a 7B model's stacked in_proj is 17 GB).
            out = torch.empty((n,) + tuple(s.shape), dtype=dtype, device=gen.device)
            for i in range(n):
                out[i] = s.init(gen, s.shape, dtype)
            return out

        return ParamSpec(shape=(n,) + s.shape, axes=("layers",) + s.axes, role=s.role, init=init,
                         fan_in=s.fan_in, fan_out=s.fan_out, dtype=s.dtype)

    return stack(spec_tree)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int, base: float = 10000.0):
    """Returns (sin, cos) of shape (..., head_dim/2), f32 angles."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                            device=positions.device) / head_dim))
    angles = positions.float()[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D/2) broadcast over heads. The
    split-halves rotation in f32, cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[..., :, None, :]
    cos = cos[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)
