"""Carry parameters between the JAX package and the port.

The port's parameter dict uses the JAX tree's dotted names, shapes and order,
so conversion is a per-leaf copy; tests use it to start both packages from
the same weights and to compare them like with like.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.labels import flatten_with_names


def params_from_numpy(arrays: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """JAX parameters flattened by dotted name (``{name: array}``) -> the
    port's ``{name: tensor}`` on ``device``, in tree order."""
    return {name: torch.from_numpy(np.array(a, copy=True)).to(device)
            for name, a in flatten_with_names(dict(arrays))}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse: ``{name: tensor}`` -> ``{name: numpy array}`` (host copies)."""
    return {name: t.detach().cpu().numpy() for name, t in flatten_with_names(dict(params))}
