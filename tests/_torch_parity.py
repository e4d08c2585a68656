"""Helpers shared by the ``test_torch_*`` parity tests: the same numpy inputs
go through the JAX package and its PyTorch port (both on the CPU)."""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.labels import flatten_with_names as jax_flatten

# JAX's CPU thread pool and PyTorch's intra-op pool compete inside one test
# process; at these small shapes two PyTorch threads run several times
# faster than one per core.
torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def jax_params(seed: int = 0, arch: str = "gpt_small"):
    """A reduced architecture as the JAX package (and its Trainer)
    initialises it: (config, params pytree, meta pytree, {dotted name: numpy
    array}). Cached per seed and arch, as eager JAX init costs seconds;
    callers must not mutate the arrays."""
    cfg = jax_reduced(arch)
    params, meta = cfg.init(jax.random.PRNGKey(seed))
    arrays = {name: np.asarray(leaf) for name, leaf in jax_flatten(params)[0]}
    return cfg, params, meta, arrays


def flat_numpy(tree):
    """A JAX pytree (or a port dict) as {dotted name: numpy array}."""
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor) for v in tree.values()):
        return {k: v.detach().cpu().numpy() for k, v in tree.items()}
    return {name: np.asarray(leaf) for name, leaf in jax_flatten(tree)[0]}


def assert_close(actual, desired, rtol: float, what: str = ""):
    """|actual - desired| <= rtol * max|desired| elementwise: the tolerance
    is relative to the output's largest magnitude, so entries that cancel
    towards 0 (m' = b1*m + (1-b1)*g) are held to the same absolute bar."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (what, actual.shape, desired.shape)
    scale = float(np.max(np.abs(desired))) if desired.size else 0.0
    np.testing.assert_allclose(actual, desired, rtol=0, atol=rtol * max(scale, 1e-30), err_msg=what)
