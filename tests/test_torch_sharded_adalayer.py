"""AdaLayer (one second moment a parameter block) through the port's sharded
fused backend on a (data=2, model=2) mesh of 4 gloo CPU processes
(``_torch_ranks.run_ranks``), against the JAX package's unsharded 'jnp'
backend from the same numpy parameters and gradients.

On this mesh AdaLayer's rules leave every line of reduced gpt_small split
across ranks: each leaf, the embedding included, takes the psum regime,
the path whose pass 1 (B10 per leaf, B12 grouped) and pass 2 (B11, B13) run
on the card on the long lines of full-width gpt_small (the embedding's
shard is one 9,658,368-element line). Here the kernels' plain twins run.
Two updates by the grouped route and the per-leaf one: each update within
1e-5 of the JAX update's largest magnitude, each rank's m' shards within
1e-5 of the matching slice of the JAX state. The oracle is the JAX
package's unsharded update, which the sharded one must equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_parity import assert_close, jax_params
from repro.core.labels import flatten_with_names as jax_flatten
from repro.optim import apply_updates as jax_apply_updates
from repro.train import trainer as jax_trainer
from test_torch_sharded import _slice

TOL = 1e-5
LR = 3e-3
STEPS = 2


def _grads(arrays, step):
    rng = np.random.default_rng(23 + step)
    # step 0 trips the global-norm clip, step 1 does not
    return {k: (rng.standard_normal(a.shape) * (1.0 if step == 0 else 0.05)).astype(np.float32)
            for k, a in arrays.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 4 ranks' results, the JAX updates per step, the JAX state's
    leaves by name)."""
    _, jparams, jmeta, arrays = jax_params(seed=3)
    grads = [_grads(arrays, s) for s in range(STEPS)]
    port = ranks.run_ranks(ranks.adalayer_updates, tmp_path_factory.mktemp("adalayer"), arrays, grads, LR)
    jtx = jax_trainer.make_optimizer("adalayer", LR, jparams, jmeta, backend="jnp")
    state = jtx.init(jparams)
    treedef = jax.tree_util.tree_structure(jparams)
    updates = []
    for g in grads:
        upd, state = jtx.update(jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g[k]) for k in arrays]), state,
                                jparams)
        jparams = jax_apply_updates(jparams, upd)
        updates.append({n: np.asarray(x) for n, x in jax_flatten(upd)[0]})
    return port, updates, {n: np.asarray(x) for n, x in jax_flatten(state)[0]}


def test_every_leaf_takes_the_psum_regime(runs):
    port, updates, _ = runs
    for r in port:
        assert r["regimes"] == {"local": 0, "psum": len(updates[0]), "psum_jnp": 0, "jnp": 0, "degraded": 0}
        assert "embed" in r["psum"]


@pytest.mark.parametrize("route", ["grouped", "per_leaf"])
def test_sharded_updates_match_jax(runs, route):
    port, updates, _ = runs
    for r in port:
        got = r[route]["updates"]
        for step, want in enumerate(updates):
            assert got[step].keys() == want.keys()
            for k, u in want.items():
                assert_close(got[step][k], u, TOL, f"rank {r['coords']} {route} step {step} update {k}")


@pytest.mark.parametrize("route", ["grouped", "per_leaf"])
def test_sharded_first_moments_match_jax(runs, route):
    """Each rank's m' of every leaf: the slice of the JAX package's m' that
    the leaf's spec gives the rank."""
    port, _, jstate = runs
    mus = {n: a for n, a in jstate.items() if ".mu." in f".{n}."}
    assert len(mus) == len(port[0]["specs"])
    for r in port:
        state = r[route]["state"]
        for name, want in mus.items():
            leaf = name.split("mu.", 1)[1]
            assert_close(state[name], _slice(want, r["specs"][leaf], r["coords"]), TOL, f"{route} {name}")
