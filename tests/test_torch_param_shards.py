"""Parameter-shard storage: each rank of a (data=2, model=2) mesh holds only
its shards of the parameters, gradients and updates
(``repro_torch.launch.train``, the step built with ``grad_shardings``),
held to the JAX package's ``repro/launch/train.py`` recipe and to the port's
whole-parameter sharded path.

The port runs as 4 gloo CPU processes (``tests/_torch_ranks.run_ranks``);
the JAX oracle runs in a subprocess with 4 host devices: ``jax.make_mesh``
with Auto axes, ``param_specs``, the parameters and the optimizer state
``device_put`` on their ``NamedSharding``s, and ``jit(make_train_step(...,
grad_shardings=p_sh))`` with ``out_shardings=(p_sh, o_sh, None)``, from the
same numpy weights. Reduced gpt_small, olmoe_1b_7b and falcon_mamba_7b:

* every parameter's and optimizer-state leaf's per-rank shape equals JAX's
  ``NamedSharding.shard_shape``, exactly;
* the losses of 3 steps (Adam; Table-3 SlimAdam) equal JAX's at rtol 1e-4;
* each rank's first-step gradient shard equals the cut of the
  whole-parameter port's averaged gradient within 1e-6 of the leaf's
  largest |g| (f32; only the order of the sums differs);
* the per-rank persistent bytes equal the count reckoned from
  ``shardspec.local_shape``;
* a guarded step with NaN gradients is skipped on every rank alike;
* the rest of the launcher's optimizers (Adafactor on all three models,
  SM3, Lion, SGD-M, and Adam and SlimAdam on the 'jnp' route, on
  gpt_small): every leaf's shard shape equals JAX's, 3 losses at rtol 1e-4
  of JAX's recipe and within 1e-5 of the port's whole-parameter ``Trainer``
  on the same mesh; all 12 names of ``OPTIMIZERS`` build and step.

Checkpoints across layouts: a shard-storage checkpoint restores into the
port's whole-parameter ``Trainer`` and through JAX's ``store.restore``; a
JAX Trainer's checkpoint restores into shard storage; the launcher's loop
resumes from its own checkpoint with losses bit-equal in f32.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_parity import assert_close, flat_numpy, jax_params

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gpt_small", "olmoe_1b_7b", "falcon_mamba_7b")
OPTIMIZERS = ("adam", "slim")
# the rest of the launcher's optimizers and the 'jnp' route: (arch,
# optimizer, backend); Adafactor's factored statistics on all three models
CASES = (("gpt_small", "adafactor", "fused"), ("olmoe_1b_7b", "adafactor", "fused"),
         ("falcon_mamba_7b", "adafactor", "fused"), ("gpt_small", "sm3", "fused"), ("gpt_small", "lion", "fused"),
         ("gpt_small", "sgdm", "fused"), ("gpt_small", "adam", "jnp"), ("gpt_small", "slim", "jnp"))
CASE_IDS = ["-".join(c) for c in CASES]
ALL_OPTIMIZERS = ("adam", "slim", "slim_snr", "adalayer", "adalayer_ln_tl", "adam_mini_v1", "adam_mini_v2",
                  "adafactor", "adafactor_v2", "sm3", "lion", "sgdm")
TOL_TRAINER = 1e-5
DATA = dict(seq_len=32, global_batch=4, seed=5)
LR = 1e-3
STEPS = 3
TOL_GRAD = 1e-6

ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.core.labels import flatten_with_names
from repro.data import DataConfig, ZipfLM
from repro.sharding.logical import ShardingContext, param_specs, use_sharding
from repro.sharding.state_shardings import opt_state_specs
from repro.train.step import make_train_step
from repro.train.trainer import make_optimizer

work = sys.argv[1]
spec = pickle.load(open(os.path.join(work, "spec.pkl"), "rb"))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
named = lambda spec_tree: jax.tree.map(lambda s: NamedSharding(mesh, s), spec_tree,
                                       is_leaf=lambda x: isinstance(x, P))
out = {}
for arch in spec["archs"]:
    cfg = get_reduced(arch)
    ctx = ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **spec["data"]))
    with use_sharding(ctx):
        params, meta = cfg.init(jax.random.PRNGKey(0))
        p_specs = param_specs(meta, params)
        p_sh = named(p_specs)
        for opt in spec["optimizers"]:
            tx = make_optimizer(opt, spec["lr"], params, meta, backend="fused", mesh=mesh, param_specs=p_specs)
            opt_state = tx.init(params)
            o_sh = named(opt_state_specs(jax.eval_shape(lambda: opt_state), params, p_specs, owner_mesh=mesh))
            tree, shards = {"params": params, "opt": opt_state}, dict(flatten_with_names({"params": p_sh, "opt": o_sh})[0])
            shapes = {name: tuple(shards[name].shard_shape(leaf.shape)) for name, leaf in flatten_with_names(tree)[0]}
            b_sh = NamedSharding(mesh, ctx.spec_for(("batch", None), (data.cfg.global_batch, data.cfg.seq_len)))
            step = jax.jit(make_train_step(cfg, tx, grad_shardings=p_sh),
                           in_shardings=(p_sh, o_sh, {"tokens": b_sh, "labels": b_sh}),
                           out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1))
            p, s = jax.device_put(params, p_sh), jax.device_put(opt_state, o_sh)
            losses = []
            for k in range(spec["steps"]):
                p, s, metrics = step(p, s, {k2: jnp.asarray(v) for k2, v in data.batch(k).items()})
                losses.append(float(metrics["loss"]))
            out[(arch, opt)] = dict(shapes=shapes, losses=losses)
for arch, opt, backend in spec["cases"]:
    # the rest of the launcher's recipe: every optimizer, either backend
    # (repro/launch/train.py:62-92; owner slices on the fused route only)
    cfg = get_reduced(arch)
    ctx = ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **spec["data"]))
    with use_sharding(ctx):
        params, meta = cfg.init(jax.random.PRNGKey(0))
        p_specs = param_specs(meta, params)
        p_sh = named(p_specs)
        tx = make_optimizer(opt, spec["lr"], params, meta, backend=backend, mesh=mesh, param_specs=p_specs)
        opt_state = tx.init(params)
        o_sh = named(opt_state_specs(jax.eval_shape(lambda: opt_state), params, p_specs,
                                     owner_mesh=mesh if backend == "fused" else None))
        tree, shards = {"params": params, "opt": opt_state}, dict(flatten_with_names({"params": p_sh, "opt": o_sh})[0])
        shapes = {name: tuple(shards[name].shard_shape(leaf.shape)) for name, leaf in flatten_with_names(tree)[0]}
        b_sh = NamedSharding(mesh, ctx.spec_for(("batch", None), (data.cfg.global_batch, data.cfg.seq_len)))
        step = jax.jit(make_train_step(cfg, tx, grad_shardings=p_sh),
                       in_shardings=(p_sh, o_sh, {"tokens": b_sh, "labels": b_sh}),
                       out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1))
        p, s = jax.device_put(params, p_sh), jax.device_put(opt_state, o_sh)
        losses = []
        for k in range(spec["steps"]):
            p, s, metrics = step(p, s, {k2: jnp.asarray(v) for k2, v in data.batch(k).items()})
            losses.append(float(metrics["loss"]))
        out[(arch, opt, backend)] = dict(shapes=shapes, losses=losses)
pickle.dump(out, open(os.path.join(work, "jax_out.pkl"), "wb"))
print("ok")
"""


def _jax_checkpoint(path):
    """The JAX package's Trainer (reduced gpt_small, Adam, the same weights
    and data), 4 steps with checkpoints at steps 2 and 4: its losses."""
    from repro.configs import get_reduced
    from repro.data import DataConfig, ZipfLM
    from repro.train import Trainer, TrainerConfig

    cfg = get_reduced("gpt_small")
    tr = Trainer(cfg, "adam", LR, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **DATA)),
                 TrainerConfig(total_steps=4, log_every=1, seed=0, ckpt_every=2, ckpt_dir=str(path)))
    tr.run()   # seed 0: the weights of jax_params(seed=0)
    return [m["loss"] for m in tr.metrics_log]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle (subprocess) beside the port's 4 ranks."""
    from repro_torch.data import DataConfig, ZipfLM

    work = tmp_path_factory.mktemp("shards")
    (work / "spec.pkl").write_bytes(pickle.dumps(dict(archs=ARCHS, optimizers=OPTIMIZERS, lr=LR, data=DATA,
                                                      steps=STEPS, cases=CASES)))
    script = work / "oracle.py"
    script.write_text(ORACLE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    jax_proc = subprocess.Popen([sys.executable, str(script), str(work)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        jax_losses = _jax_checkpoint(work / "jax_ckpt")
        arrays = {arch: jax_params(seed=0, arch=arch)[3] for arch in ARCHS}
        first = ZipfLM(DataConfig(vocab_size=211, **DATA)).batch(0)
        port = ranks.run_ranks(ranks.param_shard_runs, work, arrays, DATA, LR, STEPS, first, timeout_s=240.0)
        cases = ranks.run_ranks(ranks.param_shard_optimizers, work, arrays, DATA, LR, STEPS, CASES, ALL_OPTIMIZERS,
                                timeout_s=240.0)
        ckpt = ranks.run_ranks(ranks.param_shard_checkpoints, work, arrays["gpt_small"], DATA, LR,
                               str(work / "jax_ckpt"), str(work / "own_ckpt"))
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    return dict(port=port, cases=cases, ckpt=ckpt, jax=pickle.loads((work / "jax_out.pkl").read_bytes()),
                jax_losses=jax_losses, own_ckpt=work / "own_ckpt", arrays=arrays)


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_stored_as_jax_shards(runs, arch, opt):
    """(a) Each rank's shape of every parameter and optimizer-state leaf is
    JAX's ``NamedSharding(...).shard_shape`` of the global leaf."""
    want = runs["jax"][(arch, opt)]["shapes"]
    for r in runs["port"]:
        assert r[arch][f"{opt}_shapes"] == want


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_losses_match_jax_launch_recipe(runs, arch, opt):
    """(b) 3 steps from the same weights and batches, rtol 1e-4 (the bar of
    ``test_sharded_trainer_matches_jax``); every rank the same losses."""
    want = runs["jax"][(arch, opt)]["losses"]
    for r in runs["port"]:
        np.testing.assert_allclose(r[arch][opt], want, rtol=1e-4)
        assert r[arch][opt] == runs["port"][0][arch][opt]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_shards_are_the_cut_of_the_whole_parameter_gradients(runs, arch):
    """(c) Each rank's first-step gradient shard against its cut of the
    whole-parameter port's averaged gradient (``Trainer``'s path on the same
    mesh), f32, within 1e-6 of the leaf's largest |g|; every region its
    parallel form where the whole-parameter path takes it."""
    for r in runs["port"]:
        for name, (got, want) in r[arch]["grads"].items():
            assert got.shape == want.shape, name
            assert_close(got, want, TOL_GRAD, f"{arch} {name}")
    kinds = {"gpt_small": ("mlp",), "olmoe_1b_7b": ("attn", "moe"), "falcon_mamba_7b": ("ssm",)}[arch]
    for r in runs["port"]:
        assert all(r[arch]["regions"][k]["fallback"] == 0 for k in kinds), r[arch]["regions"]


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_persistent_bytes_equal_the_reckoned_shards(runs, arch, opt):
    """(d) A rank's parameter and optimizer-state bytes equal the count
    reckoned from ``shardspec.local_shape``, and the parameters' are a
    quarter of the whole where every leaf splits over both axes."""
    for r in runs["port"]:
        held, reckoned = r[arch][f"{opt}_bytes"]
        assert held == reckoned
    whole = sum(a.nbytes for a in runs["arrays"][arch].values())
    per_rank = [r[arch][f"{opt}_bytes"][0]["params"] for r in runs["port"]]
    assert all(b < whole for b in per_rank) and sum(per_rank) >= whole


@pytest.mark.parametrize("arch", ARCHS)
def test_guarded_step_skips_nan_gradients_on_every_rank(runs, arch):
    """(e) NaN gradients: the step is skipped on every rank, every entry
    counted non-finite alike, the parameter and state shards bit-identical;
    the next good step moves them."""
    rows = [r[arch]["guard"] for r in runs["port"]]
    for g in rows:
        assert g["skipped"] == (1.0, 0.0) and g["same"] and g["moved"]
        assert g["nonfinite"] == rows[0]["nonfinite"] > 0


def test_launcher_resumes_its_own_checkpoint_bit_equal(runs):
    for r in runs["ckpt"]:
        assert r["resumed"] == r["losses"][2:]
        assert r["losses"] == runs["ckpt"][0]["losses"]


def test_jax_checkpoint_restores_into_shard_storage(runs):
    """The JAX Trainer's step-2 checkpoint cut into every rank's shards
    exactly; the next 2 steps follow JAX's losses (rtol 1e-4)."""
    for r in runs["ckpt"]:
        assert r["foreign_err"] == 0.0
        np.testing.assert_allclose(r["foreign"], runs["jax_losses"][2:], rtol=1e-4)


@pytest.mark.parametrize("into", ["trainer", "jax"])
def test_shard_checkpoint_restores_whole(runs, into):
    """The launcher's step-2 checkpoint (gathered, rank 0 wrote it) into the
    port's whole-parameter ``Trainer`` and through JAX's ``store.restore``:
    the parameters equal the shards gathered whole, bit for bit."""
    want = runs["ckpt"][0]["step2_params"]
    if into == "trainer":
        from repro_torch.configs import get_reduced
        from repro_torch.data import DataConfig, ZipfLM
        from repro_torch.train import Trainer, TrainerConfig

        cfg = get_reduced("gpt_small")
        tr = Trainer(cfg, "adam", LR, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **DATA)),
                     TrainerConfig(backend="fused", ckpt_dir=str(runs["own_ckpt"])), device="cpu")
        assert tr.step == 2
        got = flat_numpy(tr.params)
    else:
        from repro.checkpoint import store
        from repro.train.trainer import make_optimizer

        cfg, params, meta, _ = jax_params(seed=0, arch="gpt_small")
        state, extra = store.restore(str(runs["own_ckpt"]),
                                     {"params": params, "opt": make_optimizer("adam", LR, params, meta).init(params)})
        assert int(extra["step"]) == 2
        got = flat_numpy(state["params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_every_optimizer_is_stored_as_jax_shards(runs, case):
    """Adafactor, SM3, Lion, SGD-M and the 'jnp' route of Adam and
    SlimAdam: each rank's shape of every parameter and state leaf is JAX's
    ``shard_shape`` under the launcher's recipe (Adafactor's row and column
    statistics by ``_masked_like_params_partial``, SM3's accumulators
    replicated, the 'jnp' route's reduced moments by the masked spec)."""
    want = runs["jax"][case]["shapes"]
    for r in runs["cases"]:
        assert r[case]["shapes"] == want


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_every_optimizer_matches_jax_launch_recipe(runs, case):
    """3 steps of each case from the same weights and batches against JAX's
    recipe, rtol 1e-4; every rank the same losses."""
    want = runs["jax"][case]["losses"]
    for r in runs["cases"]:
        np.testing.assert_allclose(r[case]["losses"], want, rtol=1e-4)
        assert r[case]["losses"] == runs["cases"][0][case]["losses"]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_every_optimizer_matches_the_whole_parameter_trainer(runs, case):
    """Within the port: shard storage against the whole-parameter
    ``Trainer`` on the same mesh, the same optimizer and backend, f32,
    within 1e-5 (only the order of the sums differs); bytes a rank equal the
    reckoned count."""
    for r in runs["cases"]:
        np.testing.assert_allclose(r[case]["losses"], r[case]["trainer"], rtol=0, atol=TOL_TRAINER)
        held, reckoned = r[case]["bytes"]
        assert held == reckoned


@pytest.mark.parametrize("name", ALL_OPTIMIZERS)
def test_every_optimizer_name_steps_on_parameter_shards(runs, name):
    """All 12 names of ``OPTIMIZERS`` build and step under parameter-shard
    storage on the (2, 2) gloo mesh, each rank the same finite loss; on a
    device-free mesh of the same shape each reckons its bytes on both
    backends, and 'slim_snr' without derived rules raises, as JAX's
    launcher does (its ``slim_rule_dims``)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding
    from repro_torch.train.trainer import OPTIMIZERS as REGISTRY

    assert set(ALL_OPTIMIZERS) == set(REGISTRY)
    losses = [r[name] for r in runs["cases"]]
    assert np.isfinite(losses[0]) and losses == [losses[0]] * len(losses)
    cfg = get_reduced("gpt_small")
    mesh = SpecMesh({"data": 2, "model": 2})
    with use_sharding(ShardingContext(mesh)):
        _, meta = cfg.abstract()
        for backend in ("fused", "jnp"):
            rules = None
            if name == "slim_snr":
                with pytest.raises(ValueError, match="derived rules"):
                    launch.reckon_bytes(cfg, name, LR, mesh, backend=backend)
                rules = {k: () for k in meta}
            got = launch.reckon_bytes(cfg, name, LR, mesh, backend=backend, rules=rules)
            assert got["params"] > 0 and got["opt"] > 0, (name, backend)
