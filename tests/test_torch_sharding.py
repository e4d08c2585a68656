"""The port's device-free sharding geometry against the JAX package's: shard
geometry, regime plans (with owner placements and the local canonical
plans), regime counts, owner factors, ``spec_for`` / ``param_specs`` and
``opt_state_specs`` come out equal, for the leaf sets of the JAX package's
own sharded parity scripts (``tests/test_sharded_fused.py``,
``tests/test_psum_kernels.py``, on their (data=4, model=2) mesh) and for
full-size gpt_small on (data=2, model=2), which has 7 psum and 4 local
leaves under the Table-3 rules.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_get_config
from repro.core import rules_as_tree as jax_rules_as_tree, table3_rules as jax_table3
from repro.core.labels import flatten_with_names as jax_flatten
from repro.sharding import shardspec as J
from repro.sharding.logical import ShardingContext as JaxContext, param_specs as jax_param_specs, \
    use_sharding as jax_use_sharding
from repro.sharding.state_shardings import opt_state_specs as jax_opt_state_specs
from repro.train.trainer import make_optimizer as jax_make_optimizer
from repro_torch.configs import get_config
from repro_torch.core import rules_as_tree, table3_rules
from repro_torch.core.labels import flatten_with_names
from repro_torch.models.common import meta_tree
from repro_torch.sharding import P, ShardingContext, opt_state_specs, param_specs, shardspec as T, use_sharding
from repro_torch.train.trainer import make_optimizer

MESH = {"data": 4, "model": 2}
# (shape, dims, spec) of the leaves the JAX package's parity scripts shard.
LEAVES = {
    "fanin": ((32, 16), (1,), ("data", None)),
    "psum": ((16, 32), (1,), (None, "model")),
    "psum3": ((12, 8, 20), (2,), (None, "model", "data")),
    "psumw": ((6, 8), (1,), (None, ("data", "model"))),
    "inter": ((4, 6, 8, 10), (0, 2), ()),
    "dense": ((24, 16), (), ("data", "model")),
    "vec": ((64,), (), ("data",)),
    "interk": ((4, 6, 8, 10), (1, 3), (None, "model", None, None)),
}


def _jp(spec):
    return None if spec is None else JP(*spec)


def _tp(spec):
    return None if spec is None else P(*spec)


def _plain(x):
    """A spec or plan field as plain Python, for comparing the packages."""
    if isinstance(x, (JP, P)):
        return ("spec",) + tuple(_plain(e) for e in x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return tuple(_plain(getattr(x, f)) for f in x._fields)
    if isinstance(x, (tuple, list)):
        return tuple(_plain(e) for e in x)
    return x


def _same_plan(jpl, tpl):
    jd, td = jpl._asdict(), tpl._asdict()
    assert jd.keys() == td.keys()
    for k in jd:
        if k == "cn":
            assert (jpl.cn is None) == (tpl.cn is None), k
            if jpl.cn is not None:
                assert tuple(jpl.cn) == tuple(tpl.cn), (k, jpl.cn, tpl.cn)
        else:
            assert _plain(jd[k]) == _plain(td[k]), (k, jd[k], td[k])


@pytest.mark.parametrize("name", sorted(LEAVES))
@pytest.mark.parametrize("mesh_shape", [MESH, {"data": 2, "model": 2}])
def test_leaf_plan_matches_jax(name, mesh_shape):
    shape, dims, spec = LEAVES[name]
    jm, tm = J.SpecMesh(mesh_shape), T.SpecMesh(mesh_shape)
    jpl = J.plan_sharded_leaf(shape, jnp.float32, dims, _jp(spec), jm, n_bufs=5)
    tpl = T.plan_sharded_leaf(shape, torch.float32, dims, _tp(spec), tm)
    _same_plan(jpl, tpl)
    assert J.owner_factor(jpl, jm) == T.owner_factor(tpl, tm)
    assert J.psum_kernel_eligible(jpl, True) == T.psum_kernel_eligible(tpl)
    for d in (dims or (0,)):
        assert _plain(J.owning_axes(shape, _jp(spec), jm, (d,))) == _plain(T.owning_axes(shape, _tp(spec), tm, (d,)))
    assert J.dim_shards(shape, _jp(spec), jm) == T.dim_shards(shape, _tp(spec), tm)
    assert _plain(J.even_spec(shape, _jp(spec), jm)) == _plain(T.even_spec(shape, _tp(spec), tm))
    assert J.local_shape(shape, _jp(spec), jm) == T.local_shape(shape, _tp(spec), tm)
    loc = T.local_shape(shape, _tp(spec), tm)
    assert T.global_shape(loc, T.even_spec(shape, _tp(spec), tm), tm) == tuple(shape)


@pytest.mark.parametrize("mesh_shape", [MESH, {"data": 2, "model": 2}])
def test_regime_counts_match_jax(mesh_shape):
    jm, tm = J.SpecMesh(mesh_shape), T.SpecMesh(mesh_shape)
    jplans = [J.plan_sharded_leaf(s, jnp.float32, d, _jp(sp), jm, n_bufs=5) for s, d, sp in LEAVES.values()]
    tplans = [T.plan_sharded_leaf(s, torch.float32, d, _tp(sp), tm) for s, d, sp in LEAVES.values()]
    assert J.regime_counts(jplans, degraded=2) == T.regime_counts(tplans, degraded=2)


@pytest.mark.parametrize("case", [((16, 1), (None, None), ("model",)), ((16, 1), (None, None), ("data", "model")),
                                  ((6, 1), (None, None), ("data",)), ((4, 1), (None, None), ("data", "model")),
                                  ((4, 1), (None, None), ("model", "data")), ((12, 8, 1), (None, "model", None),
                                                                               ("data",))])
def test_owner_placement_matches_jax(case):
    red_shape, spec, axes = case
    j = J.owner_placement(red_shape, JP(*spec), axes, J.SpecMesh(MESH))
    t = T.owner_placement(red_shape, P(*spec), axes, T.SpecMesh(MESH))
    assert _plain(j) == _plain(t)


def _gpt_small(mesh_shape):
    """Both packages' gpt_small parameter specs, dims and plans on a
    device-free mesh; the port's parameters on the meta device."""
    jcfg = jax_get_config("gpt_small")
    jparams, jmeta = jcfg.abstract()
    jm, tm = J.SpecMesh(mesh_shape), T.SpecMesh(mesh_shape)
    with jax_use_sharding(JaxContext(jm)):
        jspecs = jax_param_specs(jmeta, jparams)
    specs = get_config("gpt_small").specs()
    params = {n: torch.empty(sp.shape, dtype=sp.dtype, device="meta") for n, sp in flatten_with_names(specs)}
    meta = meta_tree(specs)
    with use_sharding(ShardingContext(tm)):
        tspecs = param_specs(meta, params)
    return jcfg, jparams, jmeta, jspecs, params, meta, tspecs, jm, tm


@pytest.mark.parametrize("mesh_shape", [{"data": 2, "model": 2}, {"data": 4, "model": 1}, {"data": 1, "model": 4},
                                        {"data": 16, "model": 16}])
def test_gpt_small_specs_and_plans_match_jax(mesh_shape):
    _, jparams, jmeta, jspecs, params, meta, tspecs, jm, tm = _gpt_small(mesh_shape)
    jspec_by_name = {n: s for (n, _), s in zip(jax_flatten(jparams)[0],
                                               jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, JP)))}
    assert {n: _plain(s) for n, s in jspec_by_name.items()} == {n: _plain(s) for n, s in tspecs.items()}
    jdims = jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta)
    jdim_by_name = dict(zip([n for n, _ in jax_flatten(jparams)[0]],
                            jax.tree_util.tree_structure(jparams).flatten_up_to(jdims)))
    tdims = rules_as_tree(table3_rules(meta), params, meta)
    jplans, tplans = [], []
    for name, p in params.items():
        assert tuple(jdim_by_name[name]) == tuple(tdims[name]), name
        jpl = J.plan_sharded_leaf(tuple(p.shape), jnp.float32, tuple(jdim_by_name[name]), jspec_by_name[name], jm,
                                  n_bufs=5)
        tpl = T.plan_sharded_leaf(tuple(p.shape), p.dtype, tuple(tdims[name]), tspecs[name], tm)
        _same_plan(jpl, tpl)
        assert J.owner_factor(jpl, jm) == T.owner_factor(tpl, tm)
        jplans.append(jpl)
        tplans.append(tpl)
    assert J.regime_counts(jplans) == T.regime_counts(tplans)
    if mesh_shape == {"data": 2, "model": 2}:
        assert T.regime_counts(tplans) == {"local": 4, "psum": 7, "psum_jnp": 0, "jnp": 0, "degraded": 0}


@pytest.mark.parametrize("optimizer", ["adam", "slim"])
@pytest.mark.parametrize("owner", [True, False])
def test_opt_state_specs_match_jax(optimizer, owner):
    _, jparams, jmeta, jspecs, params, meta, tspecs, jm, tm = _gpt_small({"data": 2, "model": 2})
    jtx = jax_make_optimizer(optimizer, 1e-3, jparams, jmeta, backend="jnp", emit_health=True)
    jstate = jax.eval_shape(jtx.init, jparams)
    jout = jax_opt_state_specs(jstate, jparams, jspecs, owner_mesh=jm if owner else None)
    ttx = make_optimizer(optimizer, 1e-3, params, meta, backend="jnp", emit_health=True)
    tout = opt_state_specs(ttx.init(params), params, tspecs, owner_mesh=tm if owner else None)
    jleaves = jax.tree_util.tree_leaves(jout, is_leaf=lambda x: isinstance(x, JP))
    tleaves = [s for s in _spec_leaves(tout)]
    assert [_plain(s) for s in jleaves] == [_plain(s) for s in tleaves]


def _spec_leaves(tree):
    """Spec leaves in the JAX package's flatten order (dicts by sorted key)."""
    if tree is None:
        return
    if isinstance(tree, P):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=lambda k: k.split(".")):
            yield from _spec_leaves(tree[k])
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _spec_leaves(getattr(tree, f))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _spec_leaves(v)


def test_spec_for_divisibility_fallback_matches_jax():
    jctx, tctx = JaxContext(J.SpecMesh(MESH)), ShardingContext(T.SpecMesh(MESH))
    for axes, shape in [(("vocab", "embed"), (50304, 768)), (("kv_heads", "head_dim"), (3, 64)),
                        (("batch", "seq_sp", "act_embed"), (8, 1024, 768)), (("layers", "embed", "mlp"), (12, 6, 7))]:
        for pad in (False, True):
            assert _plain(jctx.spec_for(axes, shape, allow_pad=pad)) == _plain(tctx.spec_for(axes, shape,
                                                                                               allow_pad=pad))


def test_normalize_spec_leaves_rejects_a_mismatched_tree():
    with pytest.raises(ValueError, match="do not mirror"):
        T.normalize_spec_leaves({"a": P(), "z": P()}, ["a", "b"], "test")
    assert T.normalize_spec_leaves({"b": P("data"), "a": None}, ["a", "b"], "t") == [None, P("data")]
    assert T.normalize_spec_leaves([P("data"), None], ["a", "b"], "t") == [P("data"), None]
