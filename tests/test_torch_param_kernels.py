"""The port's parameter-writing kernels (B6 ``fused_adam``, B7
``slim_update_batched``) through their entry points ``fused_adam_op``,
``slim_update_op`` and ``slim_update_nd``, and the plain line stats (B8
``snr_stats``), against the JAX package's Pallas kernels in interpret mode
and its plain oracles (``repro/kernels/ref.py``), on the same numpy inputs.
On the CPU the wrappers run their plain twins.

The bar is 1e-5 relative to each output's largest magnitude, the bar
``src/repro/optim/__init__.py`` sets for the fused path against the plain
one, f32 and bf16 parameters alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels import fused_adam_op as jax_fused_adam_op, slim_update_op as jax_slim_update_op
from repro.kernels import ops as jops, ref as jref
from repro.kernels.snr_stats import snr_stats as jax_snr_stats, snr_stats_batched as jax_snr_stats_batched
from repro_torch import kernels
from repro_torch.kernels import ops, ref, snr_stats

BAR = 1e-5
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8)


def _leaf(rng, shape, p_dtype):
    p = rng.standard_normal(shape).astype(np.float32)
    g = (1e-2 * rng.standard_normal(shape)).astype(np.float32)
    m = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    if p_dtype == "bfloat16":   # values a bf16 parameter can hold, the same in both packages
        p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    return p, g, m


def _pair(x, dtype):
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _hold(got, want, what):
    for name, a, w in zip(("p'", "m'", "v'"), got, want):
        assert str(a.dtype).split(".")[-1] == str(w.dtype), (what, name, a.dtype, w.dtype)
        assert_close(a.float(), np.asarray(w, np.float32), BAR, f"{what} {name}")


@pytest.mark.parametrize("shape", [(64, 256), (37, 129), (4, 6, 50)])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_adam_op_matches_jax(shape, p_dtype, wd):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    p, g, m = _leaf(rng, shape, p_dtype)
    v = (1e-4 * rng.random(shape)).astype(np.float32)
    kw = dict(lr=1e-3, wd=wd, count=5, **HYPER)
    jp, tp = _pair(p, p_dtype)
    want = jax_fused_adam_op(jp, *map(jnp.asarray, (g, m, v)), **kw)
    got = ops.fused_adam_op(tp, *map(torch.from_numpy, (g, m, v)), **kw)
    _hold(got, want, "fused_adam_op")
    # and against the plain oracles of both packages
    oracle = jref.adam_update_ref(jp, *map(jnp.asarray, (g, m, v)), **kw)
    _hold(ref.adam_update_ref(tp, *map(torch.from_numpy, (g, m, v)), **kw), oracle, "adam_update_ref")
    _hold(got, oracle, "fused_adam_op vs oracle")


@pytest.mark.parametrize("axis,shape", [(1, (48, 96)), (0, (48, 96)), (1, (5, 33)), (0, (37, 20))])
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_slim_update_op_matches_jax(axis, shape, p_dtype, wd):
    rng = np.random.default_rng(shape[0] * shape[1] + axis)
    p, g, m = _leaf(rng, shape, p_dtype)
    v_red = (1e-4 * rng.random((shape[0], 1) if axis == 1 else (1, shape[1]))).astype(np.float32)
    kw = dict(lr=1e-3, wd=wd, count=3, **HYPER)
    jp, tp = _pair(p, p_dtype)
    want = jax_slim_update_op(jp, *map(jnp.asarray, (g, m, v_red)), axis=axis, **kw)
    got = ops.slim_update_op(tp, *map(torch.from_numpy, (g, m, v_red)), axis=axis, **kw)
    _hold(got, want, "slim_update_op")
    if axis == 1:
        oracle = jref.slim_update_ref(jp, *map(jnp.asarray, (g, m, v_red)), **kw)
        _hold(ref.slim_update_ref(tp, *map(torch.from_numpy, (g, m, v_red)), **kw), oracle, "slim_update_ref")
        _hold(got, oracle, "slim_update_op vs oracle")


# Every route of the plan: minor, major, batched major (kept/K/kept, the
# scan-stacked form), a transposing K, and K = () (the plain route).
ND_CASES = [
    ((4, 8, 6), (2,)),          # minor
    ((4, 8, 6), (0,)),          # major
    ((3, 8, 6), (1,)),          # batched major
    ((2, 3, 4, 5), (1, 2)),     # batched major over a 2-dim K
    ((2, 3, 4, 5), (0, 1)),     # major over a leading 2-dim K
    ((3, 4, 5), (0, 2)),        # interleaved K: transposes
    ((6, 7), ()),               # no compression: the plain route
]


@pytest.mark.parametrize("shape,dims", ND_CASES)
@pytest.mark.parametrize("p_dtype,wd", [("float32", 0.0), ("bfloat16", 0.1)])
def test_slim_update_nd_matches_jax(shape, dims, p_dtype, wd):
    rng = np.random.default_rng(len(shape) * 10 + len(dims))
    p, g, m = _leaf(rng, shape, p_dtype)
    red_shape = tuple(1 if i in dims else n for i, n in enumerate(shape))
    v_red = (1e-4 * rng.random(red_shape)).astype(np.float32)
    kw = dict(dims=dims, lr=1e-3, wd=wd, count=2, **HYPER)
    jp, tp = _pair(p, p_dtype)
    want = jops.slim_update_nd(jp, *map(jnp.asarray, (g, m, v_red)), **kw)
    got = ops.slim_update_nd(tp, *map(torch.from_numpy, (g, m, v_red)), **kw)
    assert [tuple(t.shape) for t in got] == [tuple(w.shape) for w in want]
    _hold(got, want, f"slim_update_nd {shape} {dims}")


@pytest.mark.parametrize("shape", [(37, 64), (5, 130), (1, 7)])
def test_snr_stats_matches_jax(shape):
    v = np.square(np.random.default_rng(shape[1]).standard_normal(shape)).astype(np.float32)
    want = jax_snr_stats(jnp.asarray(v))
    got = snr_stats.snr_stats(torch.from_numpy(v))
    oracle = jref.snr_stats_ref(jnp.asarray(v))
    for name, a, w, o, r in zip(("s1", "s2"), got, want, oracle, ref.snr_stats_ref(torch.from_numpy(v))):
        assert_close(a, w, BAR, name)
        assert_close(a, o, BAR, f"{name} vs oracle")
        assert_close(r, o, BAR, f"{name} ref")


@pytest.mark.parametrize("b,r,c,axis", [(2, 9, 40, 1), (3, 24, 20, 0)])
def test_snr_stats_batched_matches_jax(b, r, c, axis):
    v = np.square(np.random.default_rng(b * r).standard_normal((b, r, c))).astype(np.float32)
    want = jax_snr_stats_batched(jnp.asarray(v), axis=axis)
    got = snr_stats.snr_stats_batched(torch.from_numpy(v), axis=axis)
    for name, a, w in zip(("s1", "s2"), got, want):
        assert_close(a, w, BAR, name)


def test_cpu_tensors_count_no_launch():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    p, g, m = map(torch.from_numpy, _leaf(rng, (8, 16), "float32"))
    ops.fused_adam_op(p, g, m, m.abs(), lr=1e-3)
    ops.slim_update_op(p, g, m, m.abs()[:, :1].contiguous(), axis=1, lr=1e-3)
    ops.slim_update_nd(p[None], g[None], m[None], m.abs()[None, :1], dims=(1,), lr=1e-3)
    snr_stats.snr_stats(p.abs())
    assert set(kernels.launch_counts().values()) == {0}
