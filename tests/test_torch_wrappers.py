"""The thin wrappers over ported kernels and the small plain functions the
port had no test of, each held to the JAX function on the same numpy
inputs (the Pallas kernels in interpret mode):

* ``megaplan.mega_slim_update`` (B1's 2-D form), ``megaplan.segment_table``
  on full-width gpt_small's Adam and Table-3 groups;
* ``snr_stats.snr_stats_centered``, ``snr_stats_centered_partial`` and
  ``snr_stats_centered_major`` (B5/B9 as 2-D calls), ``ref.snr_from_stats``;
* ``optim.base.trace`` with and without Nesterov, which SGD-M on parameter
  shards leans on, and ``snr_stats.snr_update_stats_finalize``.

On CUDA each wrapper is one call of its batched kernel; ``chip_smoke.py``'s
kernel phase holds each against its batched form on the card.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

TOL = 1e-5
TOL_PLAIN = 1e-6


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("flags", [(False, False), (True, True)], ids=["base", "snr+health"])
@pytest.mark.parametrize("axis", [1, 0])
def test_mega_slim_update_matches_jax(axis, flags):
    from repro.kernels import megaplan as jm
    from repro_torch.kernels import megaplan as tm

    with_snr, with_health = flags
    rng = np.random.default_rng(3 + axis)
    r, c = 24, 40
    line = (r, 1) if axis == 1 else (1, c)
    g, m = _rand(rng, (r, c)), _rand(rng, (r, c), 0.1)
    v = np.abs(_rand(rng, line, 0.01))
    bc1 = np.full(line, 1 - 0.9 ** 3, np.float32)
    bc2 = np.full(line, 1 - 0.95 ** 3, np.float32)
    kw = dict(axis=axis, b1=0.9, b2=0.95, eps=1e-8, with_snr=with_snr, with_health=with_health)
    got = tm.mega_slim_update(*(torch.from_numpy(x) for x in (g, m, v, bc1, bc2)), **kw)
    want = jm.mega_slim_update(*(jnp.asarray(x) for x in (g, m, v, bc1, bc2)), **kw)
    assert len(got) == len(want) == 3 + 2 * with_snr + 2 * with_health
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        assert_close(a.numpy(), np.asarray(b), TOL, "mega_slim_update")


@pytest.mark.parametrize("rules", ["adam", "table3"])
def test_segment_table_matches_jax(rules):
    """Full-width gpt_small's groups (all K = () for Adam; Table 3's): each
    group's table equals JAX's, and every (leaf, position) of every group
    appears exactly once, in the order the segments tile the concat axis."""
    from repro.configs import get_config as jax_config
    from repro.core import rules_as_tree as jax_rules_as_tree, table3_rules as jax_table3
    from repro.core.labels import flatten_with_names as jax_flatten
    from repro.kernels import megaplan as jm
    from repro_torch.configs import get_config
    from repro_torch.core import rules_as_tree, table3_rules
    from repro_torch.kernels import megaplan as tm

    cfg = get_config("gpt_small")
    abstract, meta = cfg.abstract()
    dims = rules_as_tree(table3_rules(meta), abstract, meta) if rules == "table3" else {k: () for k in abstract}
    names = list(abstract)
    plan = tm.plan_megagroups([tuple(abstract[k].shape) for k in names], [torch.float32] * len(names),
                              [dims[k] for k in names])
    jcfg = jax_config("gpt_small")
    jabs, jmeta = jcfg.abstract()
    jleaves = dict(jax_flatten(jabs)[0])
    if rules == "table3":
        jtree = jax_rules_as_tree(jax_table3(jmeta), jabs, jmeta)
        jdims = dict(zip(jleaves, jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(x, tuple))))
    else:
        jdims = {k: () for k in jleaves}
    assert list(jleaves) == names
    jplan = jm.plan_megagroups([jleaves[k].shape for k in names], [jnp.float32] * len(names),
                               [tuple(jdims[k]) for k in names])
    assert len(plan.groups) == len(jplan.groups) and plan.groups
    for g, jg in zip(plan.groups, jplan.groups):
        table = tm.segment_table(g)
        assert table.dtype == torch.int64
        np.testing.assert_array_equal(table.numpy(), jm.segment_table(jg))
        pairs = [tuple(r) for r in table[:, :2].tolist()]
        assert len(pairs) == len(set(pairs)) == sum(s.length for s in g.segments)
        for seg in g.segments:
            rows = [p for leaf, p in pairs if leaf == seg.index]
            assert rows == list(range(seg.length))


@pytest.mark.parametrize("name", ["snr_stats_centered", "snr_stats_centered_partial", "snr_stats_centered_major"])
def test_centered_stats_2d_wrappers_match_jax(name):
    from repro.kernels import snr_stats as js
    from repro_torch.kernels import snr_stats as ts

    rng = np.random.default_rng(11)
    v = np.abs(_rand(rng, (37, 70))) + 2.0
    got = getattr(ts, name)(torch.from_numpy(v))
    want = getattr(js, name)(jnp.asarray(v))
    kept = 70 if name.endswith("major") else 37
    assert len(got) == len(want) == (4 if name.endswith("partial") else 3)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (kept,) == b.shape
        assert_close(a.numpy(), np.asarray(b), TOL, name)


def test_snr_from_stats_matches_jax():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(5)
    v = np.abs(_rand(rng, (16, 48))) + 0.5
    s1, s2 = v.sum(1), (v * v).sum(1)
    got = tref.snr_from_stats(torch.from_numpy(s1), torch.from_numpy(s2), 48)
    want = jref.snr_from_stats(jnp.asarray(s1), jnp.asarray(s2), 48)
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=TOL_PLAIN)


@pytest.mark.parametrize("nesterov", [False, True])
def test_trace_matches_jax(nesterov):
    """Three updates of SGD's momentum buffer, every update and the buffer
    against JAX's ``trace`` at 1e-6."""
    from repro.optim.base import trace as jax_trace
    from repro_torch.optim.base import trace

    rng = np.random.default_rng(int(nesterov))
    params = {"w": _rand(rng, (6, 5)), "b": _rand(rng, (5,))}
    tx, jtx = trace(0.9, nesterov=nesterov), jax_trace(0.9, nesterov=nesterov)
    state = tx.init({k: torch.from_numpy(v) for k, v in params.items()})
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    for _ in range(3):
        g = {k: _rand(rng, v.shape) for k, v in params.items()}
        u, state = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, state)
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        for k in params:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ju[k]), rtol=TOL_PLAIN, atol=TOL_PLAIN)
            np.testing.assert_allclose(state.trace[k].numpy(), np.asarray(jstate.trace[k]), rtol=TOL_PLAIN,
                                       atol=TOL_PLAIN)


def test_snr_update_stats_finalize_matches_jax():
    """The from-update SNR's O(kept) finish on the same line sums: 1e-6."""
    from repro.kernels.snr_stats import snr_update_stats_finalize as jax_finalize
    from repro_torch.kernels.snr_stats import snr_update_stats_finalize

    rng = np.random.default_rng(9)
    g2 = np.square(_rand(rng, (12, 64)))
    first = g2[:, :1]
    s1c, s2c = (g2 - first).sum(1, keepdims=True), np.square(g2 - first).sum(1, keepdims=True)
    v_new = np.abs(_rand(rng, (12, 1), 0.1)) + 0.01
    args = (v_new, s1c, s2c)
    got = snr_update_stats_finalize(*(torch.from_numpy(x) for x in args), 64, 0.05)
    want = jax_finalize(*(jnp.asarray(x) for x in args), 64, 0.05)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL_PLAIN)
