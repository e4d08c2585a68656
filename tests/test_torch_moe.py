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
* under a device-free ``SpecMesh`` context the layer dispatches in JAX's G
  groups, with JAX's tables, output and aux loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.models import mlp_moe as jmoe
from repro_torch.models import mlp_moe as tmoe
from repro_torch.sharding import ShardingContext, SpecMesh, logical, use_sharding

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


def _jax_grouped(jcfg, p, x, g):
    """The JAX layer's body with G groups (``repro/models/mlp_moe.py:229-
    282`` as it runs under a mesh whose batch axes multiply to G): the
    tables of every group, and the output and aux loss."""
    b, s, _ = x.shape
    n_g = b * s // g
    e, k = jcfg.n_experts, jcfg.top_k
    xf = jnp.asarray(x).reshape(g, n_g, D)
    logits = jnp.einsum("gnd,de->gne", xf, jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    gates, eidx = jax.lax.top_k(probs, k)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    density = jnp.mean(jax.nn.one_hot(eidx[..., 0], e), axis=(0, 1))
    aux = jcfg.aux_coef * e * jnp.sum(density * jnp.mean(probs, axis=(0, 1)))
    aux = aux + jcfg.router_z_coef * jnp.mean(jnp.square(jax.nn.logsumexp(logits, axis=-1)))
    cap = int(max(1, round(n_g * k / e * jcfg.capacity_factor)))
    if n_g * k <= 16 * e:
        cap = min(n_g, max(cap, n_g))
    xg, token_of, gate_of, valid = jax.vmap(
        lambda a, b_, c: jmoe._dispatch_group(a, b_, c, e, k, cap, jnp.float32))(xf, gates, eidx)
    y = jax.vmap(lambda xg_g: jmoe._expert_ffn_dense({k_: jnp.asarray(v) for k_, v in p.items()}, xg_g, jcfg,
                                                     jnp.float32))(xg)
    y = jnp.where(valid, y * gate_of[..., None], 0)
    out = jax.vmap(lambda y_g, t_g: jnp.zeros((n_g, D)).at[t_g.reshape(-1)].add(y_g.reshape(-1, D)))(y, token_of)
    return dict(out=out.reshape(b, s, D), aux=aux, eidx=eidx, token_of=token_of, valid=valid, gate_of=gate_of,
                cap=cap)


@pytest.mark.parametrize("name", ["dropless", "drops"])
def test_moe_groups_under_a_spec_mesh_as_jax(name):
    """Under ``SpecMesh({'data': 2, 'model': 2})`` the layer dispatches in
    G = 2 groups of b*s/2 tokens, each with its own capacity, as the JAX
    layer does under a (2, 2) mesh: the dispatch tables equal JAX's
    exactly, the output and aux loss within 1e-5, and the drops are counted
    per group; a batch that G does not divide, and a mesh of one device,
    dispatch in one group."""
    jcfg, tcfg, p, x = _case(name)
    want = _jax_grouped(jcfg, p, x, 2)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    lay = logical.Layout(ShardingContext(SpecMesh({"data": 2, "model": 2})), False)
    assert tmoe.moe_groups(x.shape[0], lay) == 2 and tmoe.moe_groups(3, lay) == 1
    routing = tmoe.moe_route(tp, torch.from_numpy(x).reshape(-1, D), tcfg, 2)
    assert routing.capacity == want["cap"]
    e, k = tcfg.n_experts, tcfg.top_k
    np.testing.assert_array_equal(routing.eidx.reshape(2, -1, k).numpy(), np.asarray(want["eidx"]))
    for gi, dp in enumerate(routing.groups):
        shape = (e, want["cap"])
        np.testing.assert_array_equal((dp.choice // k).reshape(shape).numpy(), np.asarray(want["token_of"][gi]))
        np.testing.assert_array_equal(dp.valid.reshape(shape + (1,)).numpy(), np.asarray(want["valid"][gi]))
    with use_sharding(ShardingContext(SpecMesh({"data": 2, "model": 2}))):
        with tmoe.count_drops() as drops:
            y, aux = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    assert_close(y, want["out"], TOL, "y")
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=TOL)
    per_group = [int(v) for v in drops[0]]
    assert per_group == [int(n_k) - int(np.asarray(want["valid"][gi]).sum())
                         for gi, n_k in enumerate([x.shape[0] * x.shape[1] // 2 * k] * 2)]
    # each group's 32 tokens are few enough to route dropless (n_g * k <= 16 E),
    # where the 'drops' case drops as one group of 64
    assert per_group == [0, 0]
    with tmoe.count_drops() as drops:
        one = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)[0]
    assert (int(drops[0].sum()) > 0) == (name == "drops")
    # one group where G does not divide the batch, or on a mesh of one device
    with use_sharding(ShardingContext(SpecMesh({"data": 1, "model": 1}))):
        torch.testing.assert_close(tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)[0], one, rtol=0, atol=0)
    with use_sharding(ShardingContext(SpecMesh({"data": 3, "model": 1}))):
        torch.testing.assert_close(tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)[0], one, rtol=0, atol=0)
