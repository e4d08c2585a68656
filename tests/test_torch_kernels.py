"""The port's three optimizer/SNR kernels (their plain twins, which the
wrappers run for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerances (relative to each output's largest magnitude, see
``_torch_parity.assert_close``): 1e-6 for elementwise outputs, which round
in the same operation order in both packages; 1e-5 for line sums, whose
summation order differs.

The CUDA leg (each kernel against its plain twin on the card) is in
``test_torch_cuda.py``, which imports no JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels import megaplan as jmega
from repro.kernels.snr_stats import snr_stats_centered_batched as jax_snr_stats
from repro_torch import kernels
from repro_torch.kernels import fused_adam, megaplan as tmega, slim_update, snr_stats, ssm_scan
from repro_torch.kernels.snr_stats import snr_stats_centered_batched

ELEMENTWISE = 1e-6
LINE_SUMS = 1e-5


def _lines(rng, shape):
    """Positive per-line bias corrections with distinct values per line."""
    return (0.05 + rng.random(shape)).astype(np.float32)


def _slim_inputs(rng, b, r, c, axis):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g = rng.standard_normal((b, r, c)).astype(np.float32)
    m = (0.1 * rng.standard_normal((b, r, c))).astype(np.float32)
    v = (0.01 * rng.random(line)).astype(np.float32)
    return g, m, v, _lines(rng, line), _lines(rng, line)


@pytest.mark.parametrize("rows,cols", [(20, 512), (3, 96), (5, 12)])
def test_mega_adam_update_matches_jax(rows, cols):
    rng = np.random.default_rng(rows * cols)
    g = rng.standard_normal((rows, cols)).astype(np.float32)
    m = (0.1 * rng.standard_normal((rows, cols))).astype(np.float32)
    v = (0.01 * rng.random((rows, cols))).astype(np.float32)
    bc1, bc2 = _lines(rng, (rows, 1)), _lines(rng, (rows, 1))
    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    want = jmega.mega_adam_update(*map(jnp.asarray, (g, m, v, bc1, bc2)), interpret=True, **kw)
    got = tmega.mega_adam_update(*map(torch.from_numpy, (g, m, v, bc1, bc2)), **kw)
    for name, a, b in zip(("u", "m'", "v'"), got, want):
        assert_close(a, b, ELEMENTWISE, name)


@pytest.mark.parametrize("b,r,c,axis", [
    (1, 37, 96, 1),    # minor, ragged kept rows
    (2, 16, 40, 1),    # minor, B > 1
    (1, 24, 50, 0),    # major, ragged kept columns
    (3, 16, 70, 0),    # batched major (scan-stacked leaves)
])
def test_mega_slim_update_batched_matches_jax(b, r, c, axis):
    rng = np.random.default_rng(b * r * c + axis)
    inputs = _slim_inputs(rng, b, r, c, axis)
    kw = dict(axis=axis, b1=0.9, b2=0.95, eps=1e-8)
    want = jmega.mega_slim_update_batched(*map(jnp.asarray, inputs), interpret=True, **kw)
    got = tmega.mega_slim_update_batched(*map(torch.from_numpy, inputs), **kw)
    assert_close(got[0], want[0], ELEMENTWISE, "u")
    assert_close(got[1], want[1], ELEMENTWISE, "m'")
    assert_close(got[2], want[2], LINE_SUMS, "v'")


@pytest.mark.parametrize("b,r,c,axis", [(1, 37, 64, 1), (2, 9, 130, 1), (1, 40, 33, 0), (3, 24, 70, 0)])
@pytest.mark.parametrize("near_constant", [False, True])
def test_snr_stats_centered_batched_matches_jax(b, r, c, axis, near_constant):
    rng = np.random.default_rng(b * r * c + axis)
    if near_constant:   # the high-SNR regime the shift exists for
        v = (5.0 + 1e-4 * rng.standard_normal((b, r, c))).astype(np.float32)
    else:
        v = np.square(rng.standard_normal((b, r, c))).astype(np.float32)
    want = jax_snr_stats(jnp.asarray(v), axis=axis, interpret=True)
    got = snr_stats_centered_batched(torch.from_numpy(v), axis=axis)
    for name, a, w in zip(("s1", "s1c", "s2c"), got, want):
        assert_close(a, w, LINE_SUMS, name)


def test_wrappers_reject_what_the_kernels_do_not_take():
    g = torch.zeros(4, 8)
    bc = torch.ones(4, 1)
    with pytest.raises(TypeError):
        tmega.mega_adam_update(g.double(), g, g, bc, bc)
    with pytest.raises(ValueError):
        tmega.mega_adam_update(g.t(), g.t(), g.t(), torch.ones(8, 1), torch.ones(8, 1))
    with pytest.raises(ValueError):  # the kernel loads float4s: cols % 4 == 0
        h = torch.zeros(4, 6)
        tmega.mega_adam_update(h, h, h, bc, bc)
    with pytest.raises(ValueError):
        tmega.mega_slim_update_batched(g[None], g[None], bc[None], bc[None], bc[None], axis=0)
    with pytest.raises(ValueError):
        snr_stats_centered_batched(g, axis=1)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.random((1, 4, 8), np.float32))
    snr_stats_centered_batched(v, axis=1)
    snr_stats.snr_stats_centered_partial_batched(v, axis=1)
    m_new, _ = slim_update.slim_partial_stats_batched(v, v, axis=1)
    slim_update.slim_finalize_batched(m_new, v[..., :1].contiguous(), axis=1)
    m_new, _ = tmega.mega_slim_partial_stats_batched(v, v, axis=1)
    line = v[..., :1].contiguous()
    tmega.mega_slim_finalize_batched(m_new, line, line + 1, line + 1, axis=1)
    fused_adam.fused_adam(v, v, v, v, lr=1e-3)
    slim_update.slim_update_batched(v, v, v, line, axis=1, lr=1e-3)
    snr_stats.snr_stats_batched(v, axis=1)
    bc = v[..., :4].contiguous()
    ssm_scan.ssm_scan(v, v, -torch.ones(8, 4), bc, bc, torch.ones(8), torch.zeros(1, 8, 4))
    ssm_scan.ssm_scan_bwd(v, v, -torch.ones(8, 4), bc, bc, torch.ones(8), torch.zeros(1, 8, 4), v)
    assert kernels.launch_counts() == {"mega_adam_update": 0, "mega_slim_update_batched": 0,
                                       "adam_precond": 0, "slim_precond_batched": 0,
                                       "snr_stats_centered_batched": 0, "paged_attention": 0,
                                       "snr_stats_centered_partial_batched": 0, "slim_partial_stats_batched": 0,
                                       "slim_finalize_batched": 0, "mega_slim_partial_stats_batched": 0,
                                       "mega_slim_finalize_batched": 0, "fused_adam": 0, "slim_update_batched": 0,
                                       "snr_stats_batched": 0, "ssm_scan": 0, "ssm_scan_bwd": 0}

