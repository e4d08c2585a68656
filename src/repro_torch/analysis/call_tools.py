"""Device-free introspection of the port's entry points (the counterpart of
``repro/analysis/jaxpr_tools.py``).

JAX traces an entry into a jaxpr and counts its ``pallas_call`` equations;
the port runs eagerly, so its dry run is a call on ``meta`` tensors: shapes
and dtypes, nothing allocated, no kernel and no plain version run. Each
kernel wrapper counts such a call in its ``meta_calls`` where its CUDA
branch would launch (``kernels.build.on_meta``), so the counts of one call
of an entry on ``meta`` are the wrapper calls the card would make for the
same shapes, one a call (as ``count_pallas_launches`` counts one a
``pallas_call``). A wrapper call may be more than one CUDA launch: a
SPLIT or MAJOR walk of the slim and SNR kernels is two (the walk, then its
second pass or combine), a split B14 call two, a B15 call with chunks up to
three, the scan's backward two.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from .. import kernels


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    if hasattr(tree, "_fields"):             # a NamedTuple state
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def to_meta(tree: Any) -> Any:
    """``tree`` with every tensor replaced by a ``meta`` tensor of its shape
    and dtype (tuples, lists, dicts and NamedTuples rebuilt around them)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_meta(t) for t in tree)
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    return tree


def kernel_call_counts(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """{wrapper name: calls} of one call ``fn(*args, **kwargs)`` whose tensor
    arguments all lie on ``meta``: the kernel calls the card would make for
    those shapes. Raises if a tensor argument lies elsewhere or the call
    launched a kernel. The wrappers' counters are read before and after,
    not reset."""
    off = sorted({str(t.device) for t in _tensors((args, kwargs)) if t.device.type != "meta"})
    if off:
        raise ValueError(f"kernel_call_counts: tensor arguments on {off}; a dry run takes meta tensors only")
    calls0, launches0 = kernels.meta_call_counts(), kernels.launch_counts()
    with torch.no_grad():
        fn(*args, **kwargs)
    calls1, launches1 = kernels.meta_call_counts(), kernels.launch_counts()
    launched = {k: launches1[k] - launches0[k] for k in launches1 if launches1[k] != launches0[k]}
    if launched:
        raise RuntimeError(f"kernel_call_counts: the dry run launched kernels {launched}")
    return {k: calls1[k] - calls0[k] for k in calls1 if calls1[k] != calls0[k]}


def count_kernel_calls(fn: Callable, *args, **kwargs) -> int:
    """Kernel wrapper calls of one call of ``fn`` on ``meta`` tensors: the
    port's ``count_pallas_launches`` (``repro/analysis/jaxpr_tools.py:43``)."""
    return sum(kernel_call_counts(fn, *args, **kwargs).values())


def entry_signature(fn: Callable, *args, **kwargs) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every output tensor of one call of ``fn`` on
    ``meta`` tensors, flattened in order (None outputs dropped): the port's
    ``entry_signature`` (``jax.eval_shape``)."""
    off = sorted({str(t.device) for t in _tensors((args, kwargs)) if t.device.type != "meta"})
    if off:
        raise ValueError(f"entry_signature: tensor arguments on {off}; a dry run takes meta tensors only")
    with torch.no_grad():
        out = fn(*args, **kwargs)
    return [(tuple(t.shape), t.dtype) for t in _tensors(out)]
