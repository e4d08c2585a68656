"""Layer-wise SNR in the port — the fused path (centered-stats kernel; its
plain twin for CPU tensors) and the plain two-pass path — against the JAX
package on one fixed second-moment tree, within 1e-4 relative; and
``derive_rules`` on each package's measurement giving identical rules."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat_numpy, jax_params
from repro.core import derive_rules as jax_derive_rules, measure_tree_snr as jax_measure
from repro_torch.configs import get_reduced
from repro_torch.core import derive_rules, measure_tree_snr, snr_along_dims
from repro_torch.models import Transformer


def _nu_tree():
    """A ν-like tree with structure: positive, a per-row and per-column
    scale times lognormal noise, so candidates land on both sides of the
    SNR cutoff."""
    _, jparams, jmeta, arrays = jax_params()
    rng = np.random.default_rng(11)
    nu = {}
    for k, a in arrays.items():
        scale = np.ones(a.shape)
        for axis, n in enumerate(a.shape):
            shape = [1] * a.ndim
            shape[axis] = n
            scale = scale * np.exp(rng.standard_normal(shape) * rng.uniform(0.0, 1.5))
        nu[k] = (1e-4 * scale * np.exp(0.3 * rng.standard_normal(a.shape))).astype(np.float32)
    jnu = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams),
                                       [jnp.asarray(nu[k]) for k in arrays])
    return jnu, jmeta, {k: torch.from_numpy(v) for k, v in nu.items()}


@pytest.mark.parametrize("backend", ["fused", "jnp"])
def test_measure_tree_snr_matches_jax(backend):
    jnu, jmeta, tnu = _nu_tree()
    tmeta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    want = jax.jit(lambda nu: jax_measure(nu, jmeta, backend="jnp"))(jnu)
    got = measure_tree_snr(tnu, tmeta, backend=backend)
    assert list(got) == list(want)
    n_candidates = 0
    for name, by_k in want.items():
        assert set(got[name]) == set(by_k), name  # jit returns dicts in sorted-key order
        for label, v in by_k.items():
            n_candidates += 1
            np.testing.assert_allclose(float(got[name][label]), float(v), rtol=1e-4, err_msg=f"{name} {label}")
    assert n_candidates == 21
    rules = derive_rules({n: {k: float(v) for k, v in d.items()} for n, d in got.items()}, tmeta)
    jrules = jax_derive_rules({n: {k: float(v) for k, v in d.items()} for n, d in want.items()}, jmeta)
    assert rules == jrules
    assert any(rules.values()) and not all(rules.values())


def test_near_constant_lines_keep_their_snr():
    """The centered sums keep a near-constant line's variance: the fused
    path agrees with the two-pass one where E[v^2] - E[v]^2 would cancel."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy((3.0 + 1e-3 * rng.standard_normal((12, 40, 24))).astype(np.float32))
    fused = float(snr_along_dims(v, (1,), backend="fused"))
    plain = float(snr_along_dims(v.double(), (1,), backend="jnp"))
    assert fused == pytest.approx(plain, rel=1e-3)
    assert fused > 1e6


@pytest.mark.parametrize("backend", ["fused", "jnp"])
def test_per_layer_curve_matches_jax(backend):
    from repro.core.snr import snr_along_dims as jax_snr_along_dims

    jnu, _, tnu = _nu_tree()
    name = "blocks.slot_0.attn.wq"
    want = jax_snr_along_dims(flat_numpy(jnu)[name], (1,), per_remaining_dim=0)
    got = snr_along_dims(tnu[name], (1,), per_remaining_dim=0, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


@pytest.mark.parametrize("name,dims,per_dim", [
    ("blocks.slot_0.attn.wq", (1, 3), None),   # K interleaved with heads: transposing view
    ("blocks.slot_0.attn.wq", (1, 3), 2),
    ("blocks.slot_0.attn.wo", (0, 3), 1),      # K around the kept dims, per head
    ("embed", (0,), 1),                        # major view, per embed column
    ("blocks.slot_0.mlp.w_down", (-1,), 0),    # negative dim, minor view
])
def test_fused_snr_takes_every_view_and_form(name, dims, per_dim):
    """The fused path serves transposing views and the per-remaining-dim
    form through the kernel's line stats, as the JAX package's plain math
    computes them."""
    from repro.core.snr import snr_along_dims as jax_snr_along_dims

    jnu, _, tnu = _nu_tree()
    want = jax_snr_along_dims(flat_numpy(jnu)[name], tuple(d % tnu[name].ndim for d in dims),
                              per_remaining_dim=per_dim)
    got = snr_along_dims(tnu[name], dims, per_remaining_dim=per_dim, backend="fused")
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
