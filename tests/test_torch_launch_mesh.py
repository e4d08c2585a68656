"""The launcher on a mesh, end to end: ``python -m repro_torch.launch.train
--mesh single|multi`` (``launch.train.main``) run by real ranks, held to the
port's whole-parameter ``Trainer``, to the JAX package's
``repro/launch/train.py`` recipe and to JAX's ``store.restore``.

The production meshes need 256 or 512 ranks. In the rank processes the
harness replaces ``repro_torch.launch.mesh.make_production_mesh`` by a
factory of the same axes at small sizes, (data=2, model=2) for ``single``
and (pod=2, data=2, model=2) for ``multi`` (``tests/_torch_ranks.py``
``LAUNCH_MESHES``), and calls ``main(argv)`` unchanged on every rank as
gloo CPU processes: on a harness mesh already up (``main``'s mesh is then
a second one in the same group), or fresh, from the environment torchrun
gives a rank. ``main`` prints 4 decimals; the harness keeps the rows
``train`` returns. The JAX oracle runs in a subprocess with 8 host
devices and Auto axes. Reduced gpt_small and smollm_135m, f32:

* (a) ``main`` on 8 ranks (``multi``) and on 4 (``single``), Table-3
  SlimAdam on the fused route, 3 steps: losses within 1e-5 of the
  whole-parameter ``Trainer`` in one process from the same seed-0 weights
  and ZipfLM batches; each rank's bytes equal ``reckon_bytes``; the log on
  rank 0 alone;
* (b) ``build(whole=...)`` and ``train`` on the 3-axis mesh from JAX's
  weights, Adam and SlimAdam: every parameter's and optimizer-state leaf's
  shard shape is JAX's ``NamedSharding.shard_shape``, and 3 losses are
  within rtol 1e-4 of JAX's recipe;
* (c) elastic resume: a ``multi`` job's step-2 checkpoint resumed by a
  fresh ``single`` job to step 4, and the reverse, give steps 3-4 within
  1e-5 of the uninterrupted run; JAX's ``store.restore`` reads the 8-rank
  checkpoint onto a 4-device mesh, bit for bit, and its next 2 steps follow
  the port's (rtol 1e-4);
* (d) ``--guard`` on the 3-axis mesh with a NaN step injected through the
  guard's controls: skipped on every rank, the shards bit-identical across
  it, a clean step's ``grad_sumsq`` (the health's) and gradient norm within
  1e-6 (relative) of the whole-parameter Trainer's, the guard's counters
  equal on every rank; a rollback after 3 spikes, while rank 0's checkpoint
  writes land only when it waits for them, restores the same checkpoint on
  every rank (the pod replicas' shards bit-equal after it).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

import _torch_ranks as ranks
from _torch_parity import jax_params
from repro_torch.train.faults import FaultPlan

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gpt_small", "smollm_135m")
MESHES = ("multi", "single")
# (b) also holds the MoE's dispatch groups, one a (pod, data) rank pair, to JAX's
RECIPE = tuple((arch, opt) for arch in ARCHS + ("olmoe_1b_7b",) for opt in ("adam", "slim"))
LR = 3e-4                      # the launcher's default
SEQ, BATCH = 32, 8             # the rows split over (pod, data): 2 a rank on 8 ranks
RECIPE_DATA = dict(seq_len=SEQ, global_batch=BATCH, seed=5)
STEPS = 3
NAN_STEP = 1                   # 0-based, as FaultPlan counts
# The rollback run: a NaN step, then 8 good ones fill the guard's window
# (``min_history``), then 3 spikes in a row escalate to a rollback at step
# 12 (1-based), after the checkpoint of step 9 (every 14 // 4 = 3 steps).
ROLLBACK_STEPS, SPIKES, ROLLED_TO = 14, (9, 10, 11), 9
TOL_TRAINER = 1e-5
TOL_JAX = 1e-4
TOL_SUMSQ = 1e-6

ORACLE = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.checkpoint import store
from repro.configs import get_reduced
from repro.core.labels import flatten_with_names
from repro.data import DataConfig, ZipfLM
from repro.sharding.logical import ShardingContext, param_specs, use_sharding
from repro.sharding.state_shardings import opt_state_specs
from repro.train.step import make_train_step
from repro.train.trainer import make_optimizer

work = sys.argv[1]
spec = pickle.load(open(os.path.join(work, "spec.pkl"), "rb"))


def recipe(mesh, arch, opt, data, params=None, start=0, steps=0, restore=None):
    # repro/launch/train.py:55-92 on ``mesh``: shapes, losses, and with
    # ``restore`` the state read by store.restore onto this mesh first
    named = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree, is_leaf=lambda x: isinstance(x, P))
    cfg = get_reduced(arch)
    ctx = ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)
    out = {}
    with use_sharding(ctx):
        params, meta = cfg.init(jax.random.PRNGKey(0))
        p_specs = param_specs(meta, params)
        p_sh = named(p_specs)
        tx = make_optimizer(opt, spec["lr"], params, meta, backend="fused", mesh=mesh, param_specs=p_specs)
        opt_state = tx.init(params)
        o_sh = named(opt_state_specs(jax.eval_shape(lambda: opt_state), params, p_specs, owner_mesh=mesh))
        tree, shards = {"params": params, "opt": opt_state}, dict(flatten_with_names({"params": p_sh, "opt": o_sh})[0])
        out["shapes"] = {name: tuple(shards[name].shard_shape(leaf.shape))
                         for name, leaf in flatten_with_names(tree)[0]}
        p, s = jax.device_put(params, p_sh), jax.device_put(opt_state, o_sh)
        if restore is not None:
            state, extra = store.restore(restore, {"params": p, "opt": s}, shardings={"params": p_sh, "opt": o_sh})
            p, s, start = state["params"], state["opt"], int(extra["step"])
            stored = np.load(os.path.join(restore, f"step_{start:08d}", "arrays.npz"))
            leaves = flatten_with_names(state)[0]
            out["restored"] = dict(step=start, names=sorted(n for n, _ in leaves), stored=sorted(stored.files),
                                   err=max(float(np.abs(np.asarray(x) - stored[n]).max()) for n, x in leaves))
        b_sh = NamedSharding(mesh, ctx.spec_for(("batch", None), (data.cfg.global_batch, data.cfg.seq_len)))
        step = jax.jit(make_train_step(cfg, tx, grad_shardings=p_sh),
                       in_shardings=(p_sh, o_sh, {"tokens": b_sh, "labels": b_sh}),
                       out_shardings=(p_sh, o_sh, None), donate_argnums=(0, 1))
        losses = []
        for k in range(start, start + steps):
            p, s, metrics = step(p, s, {k2: jnp.asarray(v) for k2, v in data.batch(k).items()})
            losses.append(float(metrics["loss"]))
        out["losses"] = losses
    return out


auto = lambda n: (AxisType.Auto,) * n
three = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=auto(3))
out = {}
for arch, opt in spec["recipe"]:
    cfg = get_reduced(arch)
    out[(arch, opt)] = recipe(three, arch, opt, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **spec["data"])),
                              steps=spec["steps"])
# the port's 8-rank checkpoint, once its job has written it, onto 4 of the devices
deadline = time.monotonic() + 600
while not os.path.exists(os.path.join(work, "ckpt_ready")):
    if time.monotonic() > deadline:
        raise SystemExit("the port's checkpoint never came")
    time.sleep(0.2)
four = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4], axis_types=auto(2))
cfg = get_reduced("gpt_small")
out["restore"] = recipe(four, "gpt_small", "slim",
                        ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"], global_batch=spec["batch"])),
                        steps=2, restore=spec["ckpt"])
pickle.dump(out, open(os.path.join(work, "jax_out.pkl"), "wb"))
print("ok")
"""


def argv(arch, mesh, steps, *extra):
    """The launcher's command line (its defaults spelled out), reduced, on
    the CPU."""
    return ["--arch", arch, "--mesh", mesh, "--reduced", "--steps", str(steps), "--seq", str(SEQ), "--batch",
            str(BATCH), "--optimizer", "slim", "--backend", "fused", "--lr", str(LR), "--log-every", "1",
            "--device", "cpu", *extra]


def key(*args):
    return " ".join(argv(*args))


GATHER_DSTS = (0, 5)           # rank 5: pod 1, outside rank 0's group over (data, model)
PLAN = FaultPlan(nan_grad_steps=(NAN_STEP,), spike_steps=SPIKES)
MESH_OF = {"multi": dict(shape=(2, 2, 2), axes=("pod", "data", "model")),
           "single": dict(shape=(2, 2), axes=("data", "model"))}


def _in_threads(*calls):
    """Each ``(fn, args, kwargs)`` in a thread of its own: their results in
    order, or the first one's exception."""
    results, errors = [None] * len(calls), []

    def one(i, fn, args, kw):
        try:
            results[i] = fn(*args, **kw)
        except BaseException as e:   # noqa: BLE001 — re-raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i, *c)) for i, c in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _trainer(arch, steps, guard=False):
    """The port's whole-parameter ``Trainer`` in this process, as the
    launcher's ``--mesh none`` path builds it from the same flags: its rows."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.train import FaultPlan, GuardConfig, Trainer, TrainerConfig

    cfg = get_reduced(arch)
    tr = Trainer(cfg, "slim", LR, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)),
                 TrainerConfig(total_steps=steps, log_every=1, backend="fused", guard=GuardConfig() if guard else None),
                 faults=FaultPlan(nan_grad_steps=(NAN_STEP,)) if guard else None, device="cpu")
    tr.run()
    return tr.metrics_log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle (subprocess) beside the port's rank jobs: an 8-rank
    and a 4-rank job on harness meshes, then a fresh job of each size
    resuming the other's checkpoint."""
    work = tmp_path_factory.mktemp("launch_mesh")
    ckpt = {m: str(work / f"ckpt_{m}") for m in MESHES + ("rollback",)}
    (work / "spec.pkl").write_bytes(pickle.dumps(dict(recipe=RECIPE, lr=LR, data=RECIPE_DATA, steps=STEPS, seq=SEQ,
                                                      batch=BATCH, ckpt=ckpt["multi"])))
    script = work / "oracle.py"
    script.write_text(ORACLE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    jax_proc = subprocess.Popen([sys.executable, str(script), str(work)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        arrays = {arch: jax_params(seed=0, arch=arch)[3] for arch in dict(RECIPE)}

        def job(mesh, *, guard=False):
            argvs = [argv(arch, mesh, STEPS) for arch in ARCHS]
            argvs += [argv("gpt_small", mesh, 4), argv("gpt_small", mesh, 2, "--ckpt", ckpt[mesh])]
            if guard:
                argvs += [argv("gpt_small", mesh, STEPS, "--guard"),
                          argv("gpt_small", mesh, ROLLBACK_STEPS, "--guard", "--ckpt", ckpt["rollback"])]
            return argvs

        multi, single = _in_threads(
            (ranks.run_ranks, (ranks.launcher_job, work, job("multi", guard=True), PLAN, True, arrays,
                               RECIPE_DATA, LR, STEPS, GATHER_DSTS), dict(timeout_s=300.0, **MESH_OF["multi"])),
            (ranks.run_ranks, (ranks.launcher_main, work, job("single")), dict(timeout_s=300.0, **MESH_OF["single"])))
        (work / "ckpt_ready").touch()
        pairs = (("single", "multi"), ("multi", "single"))
        resumed = _in_threads(*((ranks.run_ranks, (ranks.launcher_main, work, [argv("gpt_small", into, 4, "--ckpt",
                                                                                     ckpt[source])]),
                                 dict(timeout_s=300.0, fresh=True, **MESH_OF[into])) for into, source in pairs))
        resumed = {into: [r[key("gpt_small", into, 4, "--ckpt", ckpt[source])] for r in res]
                   for (into, source), res in zip(pairs, resumed)}
        trainer = {arch: _trainer(arch, STEPS) for arch in ARCHS}
        trainer["guard"] = _trainer("gpt_small", STEPS, guard=True)
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    rollback = [r["main"][key("gpt_small", "multi", ROLLBACK_STEPS, "--guard", "--ckpt", ckpt["rollback"])]
                for r in multi]
    return dict(main={"multi": [r["main"] for r in multi], "single": single}, gathered=[r["gathered"] for r in multi],
                recipe=[r["recipe"] for r in multi], resumed=resumed, trainer=trainer, rollback=rollback,
                jax=pickle.loads((work / "jax_out.pkl").read_bytes()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_main_matches_the_whole_parameter_trainer(runs, mesh, arch):
    """(a) ``main`` on every rank of the small production mesh: the same
    losses on every rank, within 1e-5 of the whole-parameter ``Trainer``
    (only the order of the sums differs)."""
    want = [m["loss"] for m in runs["trainer"][arch]]
    rows = [r[key(arch, mesh, STEPS)]["rows"] for r in runs["main"][mesh]]
    for got in rows:
        assert [r["step"] for r in got] == list(range(1, STEPS + 1))
        assert [r["loss"] for r in got] == [r["loss"] for r in rows[0]]
        np.testing.assert_allclose([r["loss"] for r in got], want, rtol=0, atol=TOL_TRAINER)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_main_builds_the_mesh_and_holds_the_reckoned_shards(runs, mesh, arch):
    """(a) The mesh ``main`` built has the production mesh's axes at the
    harness's sizes, a distinct coordinate a rank; each rank's bytes of
    parameter and state shards equal ``reckon_bytes`` under the same
    context, and ``pod`` replicates (a ``multi`` rank holds a ``single``
    rank's bytes)."""
    res = [r[key(arch, mesh, STEPS)] for r in runs["main"][mesh]]
    want = dict(zip(MESH_OF[mesh]["axes"], MESH_OF[mesh]["shape"]))
    assert all(r["mesh"] == want for r in res)
    assert len({tuple(r["coords"].values()) for r in res}) == len(res)
    for r in res:
        held, reckoned = r["bytes"]
        assert held == reckoned
    other = runs["main"]["single" if mesh == "multi" else "multi"][0][key(arch, "single" if mesh == "multi"
                                                                        else "multi", STEPS)]
    assert res[0]["bytes"][0] == other["bytes"][0]


@pytest.mark.parametrize("mesh", MESHES)
def test_main_logs_on_rank_zero_alone(runs, mesh):
    """(a) Rank 0 prints a line a step (``--log-every 1``) and the summary;
    every other rank prints nothing."""
    for rank, r in enumerate(runs["main"][mesh]):
        printed = r[key("gpt_small", mesh, STEPS)]["printed"]
        if rank == 0:
            lines = printed.splitlines()
            assert [ln.split(":")[0] for ln in lines[:STEPS]] == [f"step {s}" for s in range(1, STEPS + 1)]
            assert lines[STEPS].startswith(f"done: {STEPS} steps")
        else:
            assert printed == ""


@pytest.mark.parametrize("arch,opt", RECIPE)
def test_every_leaf_is_stored_as_jax_shards_on_three_axes(runs, arch, opt):
    """(b) ``build(whole=...)`` on the (pod, data, model) mesh: every rank's
    shape of every parameter and optimizer-state leaf is JAX's
    ``NamedSharding.shard_shape`` under the launcher's recipe, exactly."""
    want = runs["jax"][(arch, opt)]["shapes"]
    for r in runs["recipe"]:
        assert r[(arch, opt)]["shapes"] == want


@pytest.mark.parametrize("arch,opt", RECIPE)
def test_losses_match_jax_launch_recipe_on_three_axes(runs, arch, opt):
    """(b) 3 steps from JAX's weights and the same batches against JAX's
    recipe on 8 host devices, rtol 1e-4; every rank the same losses."""
    want = runs["jax"][(arch, opt)]["losses"]
    for r in runs["recipe"]:
        np.testing.assert_allclose(r[(arch, opt)]["losses"], want, rtol=TOL_JAX)
        assert r[(arch, opt)]["losses"] == runs["recipe"][0][(arch, opt)]["losses"]


@pytest.mark.parametrize("into,source", [("single", "multi"), ("multi", "single")])
def test_checkpoint_resumes_onto_the_other_mesh(runs, into, source):
    """(c) Elastic resume: the ``source`` job's step-2 checkpoint (gathered
    whole, rank 0 wrote it) resumed by a fresh ``into`` job through
    ``main``, each rank cutting its parameter and optimizer-state shards,
    owner slices included, for its new mesh: steps 3-4 within 1e-5 of the
    ``source`` mesh's uninterrupted run, the same on every rank."""
    want = [r["loss"] for r in runs["main"][source][0][key("gpt_small", source, 4)]["rows"]][2:]
    res = runs["resumed"][into]
    want_mesh = dict(zip(MESH_OF[into]["axes"], MESH_OF[into]["shape"]))
    for r in res:
        assert r["mesh"] == want_mesh and r["start"] == 2
        assert [row["step"] for row in r["rows"]] == [3, 4]
        np.testing.assert_allclose([row["loss"] for row in r["rows"]], want, rtol=0, atol=TOL_TRAINER)
        assert r["rows"] == res[0]["rows"]
        assert r["printed"].startswith("resumed from step 2") == (r is res[0])


def test_jax_restores_the_eight_rank_checkpoint(runs):
    """(c) JAX's ``store.restore`` reads the 8-rank job's checkpoint (Table-3
    SlimAdam on the fused route: the psum leaves' reduced moments stored
    whole) onto a (data=2, model=2) mesh of 4 of its devices, every leaf
    the stored array bit for bit, and its next 2 steps follow the port's
    uninterrupted 8-rank run (rtol 1e-4)."""
    got = runs["jax"]["restore"]
    assert got["restored"]["step"] == 2
    assert got["restored"]["names"] == got["restored"]["stored"]
    assert got["restored"]["err"] == 0.0
    want = [r["loss"] for r in runs["main"]["multi"][0][key("gpt_small", "multi", 4)]["rows"]][2:]
    np.testing.assert_allclose(got["losses"], want, rtol=TOL_JAX)


def _guarded(runs):
    return [r[key("gpt_small", "multi", STEPS, "--guard")] for r in runs["main"]["multi"]]


def test_guard_skips_the_nan_step_on_every_rank(runs):
    """(d) The NaN step is skipped on all 8 ranks, every gradient entry
    counted non-finite, every rank's parameter and optimizer-state shards
    bit-identical across it; the guard's counters equal on every rank."""
    res = _guarded(runs)
    n_params = sum(a.size for a in jax_params(seed=0, arch="gpt_small")[3].values())
    for r in res:
        assert [row["step_skipped"] for row in r["rows"]] == [float(s == NAN_STEP) for s in range(STEPS)]
        assert r["rows"][NAN_STEP]["nonfinite_count"] == n_params
        assert r["same"]
        assert r["counters"] == res[0]["counters"]
        assert r["counters"]["skipped"] == 1 and r["counters"]["rollbacks"] == 0


def test_guarded_norms_match_the_whole_parameter_trainer(runs):
    """(d) On the clean steps the health's ``grad_sumsq`` (each leaf's row
    divided by its replica count, ``pod`` included, before the all-axis
    psum) and the gradient norm are within 1e-6 (relative) of the
    whole-parameter Trainer's; the losses within 1e-5."""
    want = runs["trainer"]["guard"]
    for r in _guarded(runs):
        for s, (got, ref) in enumerate(zip(r["rows"], want)):
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=0, atol=TOL_TRAINER)
            if s == NAN_STEP:
                continue
            np.testing.assert_allclose(got["health_grad_norm"] ** 2, ref["health_grad_norm"] ** 2, rtol=TOL_SUMSQ)
            np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=TOL_SUMSQ)


def test_rollback_restores_one_checkpoint_on_every_rank(runs):
    """(d) Three spikes in a row roll the guarded run back while rank 0's
    background checkpoint writes are still on their way (they land only
    once rank 0 waits for them): every rank restores step 9 (a rank that
    looked before they landed found none), so the ranks that replicate a
    shard over ``pod`` hold the same bits after it; the counters equal on
    every rank."""
    res = runs["rollback"]
    assert all(r["restored"] == [ROLLED_TO] for r in res), [r["restored"] for r in res]
    assert all(r["counters"] == res[0]["counters"] for r in res)
    assert res[0]["counters"]["rollbacks"] == 1 and res[0]["counters"]["skipped"] == 1
    assert f"step {SPIKES[-1] + 1}: guard rolled back to checkpoint step {ROLLED_TO}" in res[0]["printed"]
    half = len(res) // 2   # rank r and r + 4 differ only in their pod coordinate
    for r in range(half):
        assert res[r]["coords"]["pod"] == 0 and res[r + half]["coords"]["pod"] == 1
        for name, x in res[r]["state"].items():
            np.testing.assert_array_equal(x, res[r + half]["state"][name], err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("dst", GATHER_DSTS)
def test_checkpoint_gathers_to_one_rank(runs, dst):
    """The launcher's save gathers the state whole to rank 0 alone
    (``store.gather_to_host(..., dst=0)``): on ``dst`` every leaf, owner
    slices included, equals the all-gathered one bit for bit, and every
    other rank gets None (a pod replica's group sends nothing)."""
    for rank, got in enumerate(runs["gathered"]):
        if rank != dst:
            assert got[dst] is None
            continue
        want = got["all"]
        assert got[dst].keys() == want.keys()
        for name, x in want.items():
            np.testing.assert_array_equal(got[dst][name], x, err_msg=name)
