"""The port's sharded path against the JAX package's, on a (data=2, model=2)
mesh: the port as 4 gloo CPU processes (``_torch_ranks.run_ranks``), the
JAX oracle in a subprocess with 4 forced host devices on
``jax.make_mesh((2, 2), ("data", "model"))``, as the JAX package's own
sharded tests run it, both on the same numpy inputs.

* The owner-parity leaf set (``tests/test_psum_kernels.py``'s, which covers
  local, psum with and without an owner placement, batched psum and
  interleaved-K leaves) over 3 SlimAdam updates: u, mu and each rank's
  owner-slice nu against the matching slice of the JAX arrays, the
  from-update SNR and the health, within 1e-5; regime counts and owner
  factors equal; the per-leaf route (B10/B11) against the grouped one
  (B12/B13). Sharded Adam: u and the moments, and exact non-finite counts.
* Reduced gpt_small through the sharded trainer from the same initial
  parameters: Adam measuring SNR (the psum lines through B9's twin), the
  derived rules, then 'slim_snr' with from-update SNR: losses within 1e-4
  relative, SNR values within 1e-5 relative, rules equal. A guarded step
  with an injected NaN leaves every rank's state bit-identical.
* Checkpoints: the port restores the JAX sharded run's checkpoint onto its
  mesh (each rank's shards equal the slices), and the JAX package restores
  the port's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_parity import assert_close, jax_params
from repro.checkpoint import store as jax_store

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
# The measurement pass sums whole lines of a moment (up to 20k entries
# here); the JAX package sums them in f32, the port in f64, so the values
# differ by the reference's own f32 rounding, ~sqrt(n) * 2^-24 (1.4e-5
# measured on reduced gpt_small's embed, K = both).
SNR_TOL = 1e-4
MESH = {"data": 2, "model": 2}
DATA = dict(vocab_size=211, seq_len=32, global_batch=4, seed=5)
LR = 3e-3

SHAPES = {"fanin": (32, 16), "psum": (16, 32), "psum3": (12, 8, 20), "psumw": (6, 8), "inter": (4, 6, 8, 10),
          "dense": (24, 16), "vec": (64,)}
DIMS = {"fanin": (1,), "psum": (1,), "psum3": (2,), "psumw": (1,), "inter": (0, 2), "dense": (), "vec": ()}
SPECS = {"fanin": ("data", None), "psum": (None, "model"), "psum3": (None, "model", "data"),
         "psumw": (None, ("data", "model")), "inter": (), "dense": ("data", "model"), "vec": ("data",)}
BAD = {"psum": 3, "dense": 2}   # non-finite entries seeded per leaf

ORACLE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_reduced
from repro.core.slim_adam import scale_by_slim_adam
from repro.data import DataConfig, ZipfLM
from repro.optim import fused as F
from repro.optim.adam import scale_by_adam
from repro.sharding.logical import ShardingContext, use_sharding
from repro.sharding.shardspec import owner_factor, regime_counts
from repro.train import Trainer, TrainerConfig

work = sys.argv[1]
spec = json.loads(open(os.path.join(work, "spec.json")).read())
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
inp = dict(np.load(os.path.join(work, "inputs.npz")))
grads = {k: jnp.asarray(inp["g." + k]) for k in spec["dims"]}
bad = {k: jnp.asarray(inp["bad." + k]) for k in spec["dims"]}
dims = {k: tuple(v) for k, v in spec["dims"].items()}
specs = {k: P(*[tuple(e) if isinstance(e, list) else e for e in v]) for k, v in spec["specs"].items()}
params = {k: jnp.zeros_like(v) for k, v in grads.items()}
res, arrays = {}, {}
gl, td = jax.tree_util.tree_flatten(grads)
plans = F.sharded_tree_plans(gl, [tuple(d) for d in td.flatten_up_to(dims)], td.flatten_up_to(specs), mesh)
res["regimes"] = regime_counts(plans)
res["owner"] = {n: owner_factor(pl, mesh) for n, pl in zip(sorted(grads), plans) if pl.regime == "psum"}
kw = dict(backend="fused", mesh=mesh, param_specs=specs)
tx, tx_m = scale_by_slim_adam(dims, **kw), scale_by_slim_adam(dims, emit_snr=True, emit_health=True, **kw)
state = tx.init(params)
for i in range(3):
    u, state = jax.jit((tx_m if i == 2 else tx).update)(grads, state)
for k in grads:
    arrays[f"slim.u.{k}"], arrays[f"slim.mu.{k}"], arrays[f"slim.nu.{k}"] = u[k], state.mu[k], state.nu[k]
res["slim_snr"] = {k: None if v is None else float(v) for k, v in state.snr.items()}
res["slim_nonfinite"] = np.asarray(state.health.nonfinite).tolist()
res["slim_sumsq"] = float(state.health.grad_sumsq)
ta = scale_by_adam(b1=0.9, b2=0.95, emit_health=True, **kw)
u, st = jax.jit(ta.update)(grads, ta.init(params))
for k in grads:
    arrays[f"adam.u.{k}"], arrays[f"adam.mu.{k}"], arrays[f"adam.nu.{k}"] = u[k], st.mu[k], st.nu[k]
_, st = jax.jit(ta.update)(bad, st)
res["adam_nonfinite"] = np.asarray(st.health.nonfinite).tolist()

with use_sharding(ShardingContext(mesh)):
    tc = dict(total_steps=4, log_every=1, seed=0, backend="fused", measure_snr=True, snr_early_every=2)
    adam = Trainer(get_reduced("gpt_small"), "adam", spec["lr"], ZipfLM(DataConfig(**spec["data"])),
                   TrainerConfig(**tc))
    adam.run()
    rules = adam.derive_slim_rules()
    slim = Trainer(get_reduced("gpt_small"), "slim_snr", spec["lr"], ZipfLM(DataConfig(**spec["data"])),
                   TrainerConfig(**tc, snr_from_update=True, ckpt_every=4, ckpt_dir=os.path.join(work, "jax_ckpt")),
                   rules=rules)
    slim.run()
res.update(adam_loss=[m["loss"] for m in adam.metrics_log], slim_loss=[m["loss"] for m in slim.metrics_log],
           adam_snr=adam.snr.trajectory, slim_snr_traj=slim.snr.trajectory,
           rules={k: None if v is None else list(v) for k, v in rules.items()})
np.savez(os.path.join(work, "jax_out.npz"), **{k: np.asarray(v) for k, v in arrays.items()})
print(json.dumps(res))
"""


def _inputs():
    rng = np.random.default_rng(14)
    g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    bad = {k: v.copy() for k, v in g.items()}
    for k, n in BAD.items():
        flat = bad[k].reshape(-1)
        flat[rng.choice(flat.size, n, replace=False)] = [np.nan, np.inf, -np.inf][:n]
    return g, bad


def _slice(full, spec, coords):
    """This rank's block of a global array under an even spec (independent
    of the port's ``Mesh.shard``): the axes of a tuple entry split the dim
    with the first one most significant."""
    out = np.asarray(full)
    for d, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n *= MESH[a]
            idx = idx * MESH[a] + coords[a]
        blk = out.shape[d] // n
        out = np.take(out, range(idx * blk, (idx + 1) * blk), axis=d)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle (subprocess) and the port's 4 ranks, run side by
    side; then the cross restores."""
    work = tmp_path_factory.mktemp("sharded")
    g, bad = _inputs()
    np.savez(work / "inputs.npz", **{f"g.{k}": v for k, v in g.items()}, **{f"bad.{k}": v for k, v in bad.items()})
    (work / "spec.json").write_text(json.dumps({"dims": DIMS, "specs": SPECS, "lr": LR, "data": DATA}))
    script = work / "oracle.py"
    script.write_text(ORACLE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    jax_proc = subprocess.Popen([sys.executable, str(script), str(work)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        owner = ranks.run_ranks(ranks.owner_parity, work, g, SPECS, DIMS, bad)
        _, _, _, arrays = jax_params(seed=0)
        trainer = ranks.run_ranks(ranks.trainer_run, work, arrays, DATA, LR, str(work / "port_ckpt"))
        out, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    jax_res = json.loads(out.strip().splitlines()[-1])
    restored = ranks.run_ranks(ranks.restore_onto_mesh, work, str(work / "jax_ckpt"), trainer[0]["rules"])
    return dict(work=work, owner=owner, trainer=trainer, jax=jax_res, restored=restored,
                jax_arrays=dict(np.load(work / "jax_out.npz")))


def test_owner_parity_regimes_and_owner_factors(runs):
    jax = runs["jax"]
    for r in runs["owner"]:
        assert r["regimes"] == jax["regimes"] == {"local": 3, "psum": 3, "psum_jnp": 0, "jnp": 1, "degraded": 0}
        assert r["owner"] == jax["owner"] == {"psum": 2, "psum3": 2, "psumw": 1}


@pytest.mark.parametrize("route", ["grouped", "per_leaf"])
def test_owner_parity_slim_matches_jax(runs, route):
    arrays = runs["jax_arrays"]
    for r in runs["owner"]:
        got = r[f"slim_{route == 'grouped'}"]
        for k in SHAPES:
            assert_close(got["u"][k], arrays[f"slim.u.{k}"], TOL, f"u {k}")
            assert_close(got["mu"][k], _slice(arrays[f"slim.mu.{k}"], SPECS[k], r["coords"]), TOL, f"mu {k}")
            nu_spec = _nu_spec(k)
            assert_close(got["nu"][k], _slice(arrays[f"slim.nu.{k}"], nu_spec, r["coords"]), TOL, f"nu {k}")
        for k, s in runs["jax"]["slim_snr"].items():
            if s is None:
                assert got["snr"][k] is None
            else:
                np.testing.assert_allclose(got["snr"][k], s, rtol=TOL, err_msg=k)
        assert _by_name(got["nonfinite"], SHAPES) == _by_name(runs["jax"]["slim_nonfinite"], sorted(SHAPES))
        np.testing.assert_allclose(got["sumsq"], runs["jax"]["slim_sumsq"], rtol=TOL)


def _by_name(counts, names):
    """Per-leaf counts (in the order of ``names``: the port's dict order,
    the JAX package's sorted tree order) keyed by leaf name."""
    return {k: float(c) for k, c in zip(names, counts)}


def _nu_spec(name):
    """Storage spec of the reduced moment, from the JAX plan's owner
    placement (the masked spec where the leaf has none)."""
    from jax.sharding import PartitionSpec as JP

    from repro.sharding.shardspec import SpecMesh, plan_sharded_leaf

    spec = JP(*SPECS[name])
    pl = plan_sharded_leaf(SHAPES[name], np.float32, DIMS[name], spec, SpecMesh(MESH), n_bufs=5)
    out = pl.nu_spec if pl.nu_spec is not None else pl.red_spec
    return tuple(out) + (None,) * (len(SHAPES[name]) - len(out))


def test_per_leaf_route_matches_grouped_route(runs):
    for r in runs["owner"]:
        a, b = r["slim_True"], r["slim_False"]
        for part in ("u", "mu", "nu"):
            for k in SHAPES:
                assert_close(b[part][k], a[part][k], 1e-6, f"{part} {k}")


def test_sharded_adam_matches_jax(runs):
    arrays = runs["jax_arrays"]
    for r in runs["owner"]:
        for k in SHAPES:
            assert_close(r["adam"]["u"][k], arrays[f"adam.u.{k}"], TOL, f"u {k}")
            for part in ("mu", "nu"):
                np.testing.assert_allclose(r["adam"][part][k], _slice(arrays[f"adam.{part}.{k}"], SPECS[k],
                                                                      r["coords"]), rtol=0, atol=0, err_msg=k)
        nonfinite = _by_name(r["adam_health"][0], SHAPES)
        assert nonfinite == _by_name(runs["jax"]["adam_nonfinite"], sorted(SHAPES))
        assert {k: n for k, n in nonfinite.items() if n} == BAD


def test_sharded_trainer_matches_jax(runs):
    jax = runs["jax"]
    for r in runs["trainer"]:
        np.testing.assert_allclose(r["adam_loss"], jax["adam_loss"], rtol=1e-4)
        np.testing.assert_allclose(r["slim_loss"], jax["slim_loss"], rtol=1e-4)
        assert {k: None if v is None else list(v) for k, v in r["rules"].items()} == jax["rules"]
        for got, want in ((r["adam_snr"], jax["adam_snr"]), (r["slim_snr"], jax["slim_snr_traj"])):
            assert got.keys() == want.keys()
            for name in want:
                assert got[name].keys() == want[name].keys(), name
                for k in want[name]:
                    np.testing.assert_allclose(got[name][k], want[name][k], rtol=SNR_TOL, err_msg=f"{name} {k}")
    # every rank reports the same (replicated) values
    assert all(r["slim_loss"] == runs["trainer"][0]["slim_loss"] for r in runs["trainer"])


def test_guarded_nan_step_leaves_every_rank_bit_identical(runs):
    for r in runs["trainer"]:
        assert r["guard"]["skipped"] == 1.0 and r["guard"]["counters"]["skipped"] == 1
        assert r["guard"]["same"]


def test_checkpoints_restore_across_packages(runs):
    # the JAX sharded run's checkpoint, restored onto the port's mesh
    step = jax_store.latest_step(runs["work"] / "jax_ckpt")
    arrays = dict(np.load(runs["work"] / "jax_ckpt" / f"step_{step:08d}" / "arrays.npz"))
    for r in runs["restored"]:
        assert r["step"] == step == 4
        assert r["state"].keys() == arrays.keys()
        for name, local in r["state"].items():
            want = arrays[name]
            if name in r["specs"]:
                want = _slice(want, r["specs"][name], r["coords"])
            np.testing.assert_array_equal(local, want.astype(np.float32), err_msg=name)
    # the port's sharded run's checkpoint (whole arrays), restored by the JAX package
    port_state = runs["trainer"][0]["state"]
    step = jax_store.latest_step(runs["work"] / "port_ckpt")
    manifest = json.loads((runs["work"] / "port_ckpt" / f"step_{step:08d}" / "manifest.json").read_text())
    like = {name: np.zeros(e["shape"], e["dtype"]) for name, e in manifest["leaves"].items()}
    stored, extra = jax_store.restore(runs["work"] / "port_ckpt", like)
    assert extra["step"] == 4 and stored.keys() == port_state.keys()
    for name, leaf in stored.items():
        np.testing.assert_array_equal(np.asarray(leaf, np.float32), port_state[name], err_msg=name)
