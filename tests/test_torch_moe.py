"""The port's mixture-of-experts layer (``repro_torch.models.mlp_moe``)
against the JAX package's on the CPU, from the same numpy inputs and
weights, in f32:

* ``moe_forward``'s output and aux loss (1e-5 of each output's largest
  magnitude: the combine sums a token's rows in another order than JAX's
  scatter-add) in three regimes: dropless (``n * k <= 16 * E``), with drops
  (a capacity factor of 0.5 and a router that favours two experts), and all
  ties (a zero router: every probability equal, so the top k are experts
  0..k-1 and the capacity drops the rest);
* the routing (expert ids, exactly) and the dispatch tables (``token_of``,
  ``valid``, exactly; ``gate_of`` and the gathered rows to 1e-6) that each
  package builds from its own router;
* the gradients of x and of the four leaves against ``jax.grad``;
* ``E = 1, k = 1`` equals the dense MLP on the same weights;
* the capacity rule (Python's half-to-even ``round``, the dropless rule);
* under a sharding context over more than one device the layer raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.models import mlp_moe as jmoe
from repro_torch.models import mlp_moe as tmoe
from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding

TOL = 1e-5
D, F = 16, 24

# (name, E, k, B, S, capacity factor, router scale): dropless at n = 16
# tokens, drops at n = 64 with half the capacity, ties with a zero router.
CASES = {
    "dropless": (4, 2, 2, 8, 1.25, 1.0),
    "drops": (4, 2, 2, 32, 0.5, 1.0),
    "ties": (4, 2, 2, 32, 1.25, 0.0),
}


def _case(name, seed=0):
    e, k, b, s, cf, scale = CASES[name]
    cfg_kw = dict(n_experts=e, top_k=k, d_model=D, d_ff=F, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    router = rng.standard_normal((D, e)).astype(np.float32) * scale
    if name == "drops":
        router[:, :2] += 0.5 * scale      # experts 0 and 1 take more than their share
    p = {"router": router,
         "w_up": (0.2 * rng.standard_normal((e, D, F))).astype(np.float32),
         "w_gate": (0.2 * rng.standard_normal((e, D, F))).astype(np.float32),
         "w_down": (0.2 * rng.standard_normal((e, F, D))).astype(np.float32)}
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    return jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw), p, x


def _jax_route(jcfg, p, x):
    xf = jnp.asarray(x).reshape(-1, D)
    logits = xf @ jnp.asarray(p["router"])
    gates, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    return xf, gates / jnp.sum(gates, axis=-1, keepdims=True), eidx


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_aux_match_jax(name):
    jcfg, tcfg, p, x = _case(name)
    jy, jaux = jmoe.moe_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    with tmoe.count_drops() as drops:
        ty, taux = tmoe.moe_forward({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    assert_close(ty, jy, TOL, "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL)
    n = x.shape[0] * x.shape[1]
    dropped = int(drops[0])
    assert (dropped > 0) == (name != "dropless"), dropped
    if name == "ties":    # experts 0 and 1 take every token, capacity 40 of 64
        assert dropped == 2 * (n - tmoe.moe_capacity(n, tcfg))


@pytest.mark.parametrize("name", list(CASES))
def test_routing_and_dispatch_tables_equal_jax(name):
    jcfg, tcfg, p, x = _case(name)
    xf, jgates, jeidx = _jax_route(jcfg, p, x)
    _, _, tgates, teidx = tmoe._router(torch.from_numpy(x).reshape(-1, D), torch.from_numpy(p["router"]),
                                       tcfg.top_k)
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(jeidx))
    assert_close(tgates, jgates, 1e-6, "gates")
    if name == "ties":
        np.testing.assert_array_equal(teidx.numpy(), np.tile(np.arange(tcfg.top_k), (xf.shape[0], 1)))
    n = xf.shape[0]
    cap = tmoe.moe_capacity(n, tcfg)
    want = jmoe._dispatch_group(xf, jgates, jeidx, tcfg.n_experts, tcfg.top_k, cap, jnp.float32)
    dp = tmoe._dispatch_group(torch.from_numpy(x).reshape(-1, D), teidx, tcfg.n_experts, tcfg.top_k, cap)
    shape = (tcfg.n_experts, cap)
    np.testing.assert_array_equal((dp.choice // tcfg.top_k).reshape(shape).numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(dp.valid.reshape(shape + (1,)).numpy(), np.asarray(want[3]))
    gate_of = torch.where(dp.valid, tgates.reshape(-1)[dp.choice], 0.0).reshape(shape)
    assert_close(gate_of, want[2], 1e-6, "gate_of")
    assert_close(dp.xg, want[0], 1e-6, "xg")
    # the two maps are inverse bijections between the kept choices and the filled slots
    assert int(dp.valid.sum()) == int(dp.keep.sum())
    np.testing.assert_array_equal(dp.choice[dp.slot[dp.keep]].numpy(), np.flatnonzero(dp.keep.numpy()))
    assert (int(dp.keep.sum()) == n * tcfg.top_k) == (name == "dropless")


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_grad(name):
    jcfg, tcfg, p, x = _case(name)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = jmoe.moe_forward(params, xx, jcfg)
        return jnp.sum(y * jnp.asarray(cot)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_forward(tp, tx, tcfg)
    (torch.sum(y * torch.from_numpy(cot)) + aux).backward()
    assert_close(tx.grad, jgx, TOL, "dx")
    for k in p:
        assert float(tp[k].grad.abs().max()) > 0, k
        assert_close(tp[k].grad, jgp[k], TOL, f"d{k}")


def test_one_expert_top_one_equals_the_dense_mlp():
    cfg = tmoe.MoEConfig(n_experts=1, top_k=1, d_model=D, d_ff=F)
    rng = np.random.default_rng(3)
    p = {"router": rng.standard_normal((D, 1)).astype(np.float32),
         "w_up": rng.standard_normal((1, D, F)).astype(np.float32),
         "w_gate": rng.standard_normal((1, D, F)).astype(np.float32),
         "w_down": rng.standard_normal((1, F, D)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for s in (8, 40):       # dropless, then the capacity rule with room for every token
        x = torch.from_numpy(rng.standard_normal((2, s, D)).astype(np.float32))
        y, _ = tmoe.moe_forward(tp, x, cfg)
        dense = tmoe.mlp_forward({k: tp[k][0] for k in ("w_up", "w_gate", "w_down")}, x, gated=True)
        torch.testing.assert_close(y, dense, rtol=0, atol=1e-6 * float(dense.abs().max()))


@pytest.mark.parametrize("n,e,k,cf", [(16, 4, 2, 1.25), (64, 4, 2, 1.25), (64, 4, 2, 0.5), (10, 8, 1, 1.0),
                                      (4096, 64, 8, 1.25), (8, 64, 8, 1.25), (128, 64, 8, 1.25), (40, 2, 1, 0.125)])
def test_capacity_rule_matches_jax(n, e, k, cf):
    """The JAX layer's host-side expression, with Python's ``round`` (half
    to even: 40 / 2 * 0.125 = 2.5 gives 2 slots), and the dropless rule."""
    cfg = tmoe.MoEConfig(n_experts=e, top_k=k, d_model=D, d_ff=F, capacity_factor=cf)
    want = int(max(1, round(n * k / e * cf)))
    if n * k <= 16 * e:
        want = min(n, max(want, n))
    assert tmoe.moe_capacity(n, cfg) == want
    assert want == {4096: 640, 40: 2}.get(n, want)       # olmoe's training batch of 2 x 2048; half to even


def test_moe_raises_under_a_mesh_of_more_than_one_device():
    _, tcfg, p, x = _case("dropless")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with use_sharding(ShardingContext(SpecMesh({"data": 2, "model": 2}))):
        with pytest.raises(NotImplementedError, match="expert parallelism"):
            tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    with use_sharding(ShardingContext(SpecMesh({"data": 1, "model": 1}))):
        y, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    torch.testing.assert_close(y, tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)[0], rtol=0, atol=0)
