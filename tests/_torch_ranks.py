"""Run a function on every rank of a gloo mesh of CPU processes, a
(data=2, model=2) mesh unless the caller names another, for the port's
sharded parity tests. Imports no JAX, so the rank processes start quickly;
the rank functions the tests run live here too.

``run_ranks(fn, tmp_path, *args, shape=..., axes=...)`` starts one spawned
process a rank that rendezvous through a file under ``tmp_path``, each
calling ``fn(mesh, *args)``; it returns the results in rank order, and
raises with the failing rank's traceback if any rank raises, or when the
deadline passes (the process groups' own timeout ends ranks blocked in a
collective). With ``fresh=True`` no mesh is built: each rank gets the
environment torchrun gives it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and calls ``fn(None, *args)``.
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

MESH_SHAPE = (2, 2)
MESH_AXES = ("data", "model")


def _worker(rank, fn, rdv, args, out, timeout_s, shape, axes, port):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh

        world = int(np.prod(shape))
        if port is None:
            mesh = make_mesh(shape, axes, device="cpu", init_method=f"file://{rdv}", rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=timeout_s))
        else:
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            mesh = None
        out.put((rank, "ok", fn(mesh, *args)))
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 — a rank reports every failure to the parent
        out.put((rank, "error", traceback.format_exc()))


def free_port() -> int:
    """A TCP port on the loopback address that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, tmp_path, *args, timeout_s: float = 120.0, shape=MESH_SHAPE, axes=MESH_AXES, fresh=False):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    rdv = tmp_path / f"rdv-{time.monotonic_ns()}"
    world = int(np.prod(shape))
    port = free_port() if fresh else None
    procs = [ctx.Process(target=_worker, args=(r, fn, str(rdv), args, out, timeout_s, tuple(shape), tuple(axes),
                                               port),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(results) < world:
            try:
                rank, status, value = out.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} did not finish in "
                                       f"{timeout_s} s")
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------

def _np(t):
    return None if t is None else t.detach().float().cpu().numpy()


def owner_parity(mesh, inputs, specs, dims, poison):
    """The owner-parity leaf set: 2 sharded SlimAdam updates, a third with
    from-update SNR and health, by the grouped route and the per-leaf one;
    one sharded Adam update, then one with health on poisoned gradients."""
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.optim import fused as F
    from repro_torch.optim.adam import scale_by_adam
    from repro_torch.sharding import P
    from repro_torch.sharding.shardspec import owner_factor, regime_counts

    specs = {k: P(*v) for k, v in specs.items()}
    grads = {k: torch.from_numpy(v) for k, v in inputs.items()}
    params = {k: torch.zeros_like(v) for k, v in grads.items()}
    out = {"coords": dict(mesh.coords)}
    plans = F.sharded_tree_plans(list(grads.values()), [dims[k] for k in grads], [specs[k] for k in grads], mesh)
    out["regimes"] = regime_counts(plans)
    out["owner"] = {k: owner_factor(pl, mesh) for k, pl in zip(grads, plans) if pl.regime == "psum"}
    for mk in (True, False):
        kw = dict(backend="fused", mesh=mesh, param_specs=specs, megakernel=mk)
        tx, tx_m = scale_by_slim_adam(dims, **kw), scale_by_slim_adam(dims, emit_snr=True, emit_health=True, **kw)
        state = tx.init(params)
        for i in range(3):
            u, state = (tx_m if i == 2 else tx).update(grads, state)
        out[f"slim_{mk}"] = {"u": {k: _np(x) for k, x in u.items()}, "mu": {k: _np(x) for k, x in state.mu.items()},
                             "nu": {k: _np(x) for k, x in state.nu.items()},
                             "snr": {k: None if x is None else float(x) for k, x in state.snr.items()},
                             "nonfinite": _np(state.health.nonfinite), "sumsq": float(state.health.grad_sumsq)}
    bad = {k: torch.from_numpy(v) for k, v in poison.items()}
    tx = scale_by_adam(b1=0.9, b2=0.95, backend="fused", mesh=mesh, param_specs=specs, emit_health=True)
    u, state = tx.update(grads, tx.init(params))
    out["adam"] = {"u": {k: _np(x) for k, x in u.items()}, "mu": {k: _np(x) for k, x in state.mu.items()},
                   "nu": {k: _np(x) for k, x in state.nu.items()}}
    _, poisoned = tx.update(bad, state)
    out["adam_health"] = (_np(poisoned.health.nonfinite), float(poisoned.health.grad_sumsq))
    return out


def trainer_run(mesh, arrays, data_kw, lr, ckpt_dir):
    """Reduced gpt_small through the sharded trainer as the paper runs it:
    Adam measuring SNR (B9 on the psum lines), derived rules, then
    'slim_snr' with from-update SNR, checkpointing; then a guarded SlimAdam
    step with an injected NaN."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.sharding import ShardingContext, use_sharding
    from repro_torch.train import FaultPlan, GuardConfig, Trainer, TrainerConfig

    cfg = get_reduced("gpt_small")
    out = {"coords": dict(mesh.coords)}
    with use_sharding(ShardingContext(mesh)):
        tc = dict(total_steps=4, log_every=1, seed=0, backend="fused", measure_snr=True, snr_early_every=2)
        adam = Trainer(cfg, "adam", lr, ZipfLM(DataConfig(**data_kw)), TrainerConfig(**tc), device="cpu")
        adam.model.load_params(params_from_numpy(arrays, "cpu"))
        adam.run()
        rules = adam.derive_slim_rules()
        slim = Trainer(cfg, "slim_snr", lr, ZipfLM(DataConfig(**data_kw)),
                       TrainerConfig(**tc, snr_from_update=True, ckpt_every=4, ckpt_dir=ckpt_dir), rules=rules,
                       device="cpu")
        slim.model.load_params(params_from_numpy(arrays, "cpu"))
        slim.run()
        out.update(adam_loss=[m["loss"] for m in adam.metrics_log], slim_loss=[m["loss"] for m in slim.metrics_log],
                   adam_snr=adam.snr.trajectory, slim_snr=slim.snr.trajectory, rules=rules,
                   state=_state_np(slim.global_state()))
        guard = Trainer(cfg, "slim", lr, ZipfLM(DataConfig(**data_kw)),
                        TrainerConfig(total_steps=3, log_every=1, seed=0, backend="fused",
                                      guard=GuardConfig(min_history=1)),
                        faults=FaultPlan(nan_grad_steps=(1,)), device="cpu")
        guard.run(1)
        before = _state_np(guard._state())
        guard.run(2)
        after = _state_np(guard._state())
        out["guard"] = {"skipped": guard.metrics_log[-1]["step_skipped"], "counters": dict(guard.guard.counters),
                        "same": all(np.array_equal(before[k], after[k], equal_nan=True) for k in before)
                        and before.keys() == after.keys()}
    return out


def restore_onto_mesh(mesh, ckpt_dir, rules):
    """Restore a whole-array checkpoint of a slim_snr run onto the mesh:
    this rank's shards of every optimizer leaf with their specs, and the
    step."""
    from repro_torch.checkpoint.store import named_leaves
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.sharding import ShardingContext, use_sharding
    from repro_torch.train import Trainer, TrainerConfig

    with use_sharding(ShardingContext(mesh)):
        data = ZipfLM(DataConfig(vocab_size=211, seq_len=32, global_batch=4))
        tr = Trainer(get_reduced("gpt_small"), "slim_snr", 1e-3, data,
                     TrainerConfig(backend="fused", ckpt_dir=ckpt_dir, snr_early_every=2), rules=rules,
                     device="cpu")
        specs = {name: tuple(sh.spec) for name, sh in named_leaves(tr._shardings())}
        return {"coords": dict(mesh.coords), "step": tr.step, "state": _state_np(tr._state()), "specs": specs}


def _state_np(tree):
    from repro_torch.checkpoint.store import named_leaves

    return {name: _np(leaf) for name, leaf in named_leaves(tree)}


def adalayer_updates(mesh, arrays, grads, lr):
    """Reduced gpt_small's AdaLayer (one second moment a parameter block)
    through the sharded fused backend, by the grouped route (B12/B13) and
    the per-leaf one (B10/B11): an update for each of ``grads``' steps,
    applied. Returns the regime counts, which leaves take the psum regime,
    each step's whole update and the last state's m' shards by name, and
    the parameters' specs."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import Transformer
    from repro_torch.optim import apply_updates
    from repro_torch.optim import fused as F
    from repro_torch.sharding import ShardingContext, param_specs, use_sharding
    from repro_torch.sharding.shardspec import regime_counts
    from repro_torch.train.trainer import make_optimizer, slim_rule_dims

    meta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    base = params_from_numpy(arrays, "cpu")
    with use_sharding(ShardingContext(mesh)):
        specs = param_specs(meta, base)
    dims = slim_rule_dims("adalayer", base, meta)
    plans = F.sharded_tree_plans(list(base.values()), [dims[k] for k in base], [specs[k] for k in base], mesh)
    out = {"coords": dict(mesh.coords), "regimes": regime_counts(plans),
           "psum": sorted(k for k, pl in zip(base, plans) if pl.regime == "psum"),
           "specs": {k: tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in specs[k]) for k in base}}
    for route, mk in (("grouped", True), ("per_leaf", False)):
        params = {k: v.clone() for k, v in base.items()}
        tx = make_optimizer("adalayer", lr, params, meta, backend="fused", megakernel=mk, mesh=mesh,
                            param_specs=specs)
        state = tx.init(params)
        updates = []
        with torch.no_grad():
            for g in grads:
                upd, state = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, state, params)
                apply_updates(params, upd)
                updates.append({k: _np(x) for k, x in upd.items()})
        out[route] = {"updates": updates, "state": _state_np(state)}
    return out


# -- tensor, sequence and expert parallelism of the forward ------------------

def _layer_fn(kind, cfg_kw):
    """``fn(params, x) -> (y, aux or None)`` of one layer of the port."""
    from repro_torch.models import attention, mlp_moe, ssm

    if kind == "mlp":
        return lambda p, x: (mlp_moe.mlp_forward(p, x, gated=cfg_kw["gated"]), None)
    if kind == "attn":
        cfg = attention.AttnConfig(**cfg_kw)
        return lambda p, x: (attention.attention_forward(p, x, cfg), None)
    if kind == "ssm":
        cfg = ssm.SSMConfig(**cfg_kw)
        return lambda p, x: (ssm.ssm_forward(p, x, cfg), None)
    cfg = mlp_moe.MoEConfig(**cfg_kw)
    return lambda p, x: mlp_moe.moe_forward(p, x, cfg)


def layer_grads(fn, params, x, w, scale_aux):
    """(y, aux, d(sum(y * w) + aux * scale_aux) by x and by each
    parameter); ``x`` and ``params`` whole, ``w`` cut as y is."""
    y, aux = fn(params, x)
    loss = (y.float() * w).sum()
    if aux is not None:
        loss = loss + aux * scale_aux
    grads = torch.autograd.grad(loss, [x] + list(params.values()))
    return y, aux, grads


def tp_layers(mesh, cases):
    """Each case (``{name: dict(kind, cfg, params, x, w)}``) through the
    port's layer on the mesh: x (B, S, D) cut to this rank's rows and part
    of the sequence (the sequence-parallel layout), the parameters whole.
    Returns this rank's y block, the aux loss, the gradients of x and of
    every parameter summed over the ranks (the sum of the ranks' losses,
    each ``sum(y_r * w_r) + aux / ranks``), and the region counts. A case's
    ``dtype`` (default f32) is x's."""
    from repro_torch.sharding import P, ShardingContext, logical, shard_map, use_sharding

    out = {"coords": dict(mesh.coords)}
    xspec = P("data", "model", None)
    cut = shard_map(lambda t: t, mesh, (xspec,), xspec)
    for name, case in cases.items():
        params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"]).to(case.get("dtype", torch.float32)).requires_grad_(True)
        fn = _layer_fn(case["kind"], case["cfg"])
        with use_sharding(ShardingContext(mesh)):
            logical.region_counts(reset=True)
            y, aux, grads = layer_grads(lambda p, xx: shard_map(lambda xl, pl: fn(pl, xl), mesh, (xspec, P()),
                                                                xspec)(xx, p),
                                        params, x, cut(torch.from_numpy(case["w"])), 1.0 / mesh.size)
            regions = logical.region_counts(reset=True)
        whole = [_np(mesh.psum(g, tuple(mesh.shape))) for g in grads]
        out[name] = {"y": _np(y), "aux": None if aux is None else float(aux), "gx": whole[0],
                     "gp": dict(zip(params, whole[1:])), "regions": regions}
    return out


def tp_trainer(mesh, runs, data_kw, lr, steps):
    """Reduced models through the sharded trainer (Adam, ``backend='fused'``)
    from given initial parameters: ``runs`` is ``{arch: arrays}``. Returns
    each run's losses and region counts."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.sharding import ShardingContext, logical, use_sharding
    from repro_torch.train import Trainer, TrainerConfig

    out = {"coords": dict(mesh.coords)}
    for arch, arrays in runs.items():
        cfg = get_reduced(arch)
        with use_sharding(ShardingContext(mesh)):
            logical.region_counts(reset=True)
            tr = Trainer(cfg, "adam", lr, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw)),
                         TrainerConfig(total_steps=steps, log_every=1, seed=0, backend="fused"), device="cpu")
            tr.model.load_params(params_from_numpy(arrays, "cpu"))
            tr.run()
            out[arch] = {"loss": [m["loss"] for m in tr.metrics_log], "regions": logical.region_counts(reset=True)}
    return out


def vlm_grads(mesh, batches):
    """Reduced internvl2_26b (frontend rows prepended to the tokens; the
    loss on the text positions) with remat, through ``make_grad_fn`` on the
    mesh and unsharded in the same process, from the same weights, for each
    batch (``{name: numpy batch}``; sequences the model axis divides and
    does not): the loss and the gradients of both, and the region counts."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import Transformer
    from repro_torch.sharding import ShardingContext, logical, use_sharding
    from repro_torch.train.step import make_grad_fn

    cfg = dataclasses.replace(get_reduced("internvl2_26b"), remat=True)
    model = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(7))
    out = {}
    for name, arrays in batches.items():
        batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
        with use_sharding(ShardingContext(mesh)):
            logical.region_counts(reset=True)
            g, m = make_grad_fn(model, mesh=mesh)(batch)
            regions = logical.region_counts(reset=True)
        g1, m1 = make_grad_fn(model)(batch)
        out[name] = {"loss": (float(m["loss"]), float(m1["loss"])), "regions": regions,
                     "grads": {k: (_np(g[k]), _np(g1[k])) for k in g}}
    return out


def momentless_updates(mesh, inputs, specs, dims, steps):
    """Moment-less SlimAdam (``use_first_moment=False``) on the mesh:
    ``steps`` updates of the given whole gradients, by the fused backend's
    sharded route. Returns each leaf's last u (whole) and this rank's nu
    shards, and whether the state holds a first moment."""
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.sharding import P

    specs = {k: P(*v) for k, v in specs.items()}
    grads = {k: torch.from_numpy(v) for k, v in inputs.items()}
    params = {k: torch.zeros_like(v) for k, v in grads.items()}
    tx = scale_by_slim_adam(dims, use_first_moment=False, backend="fused", mesh=mesh, param_specs=specs,
                            emit_snr=True, emit_health=True)
    state = tx.init(params)
    for _ in range(steps):
        u, state = tx.update(grads, state)
    return {"coords": dict(mesh.coords), "mu": state.mu, "u": {k: _np(x) for k, x in u.items()},
            "nu": {k: _np(x) for k, x in state.nu.items()},
            "snr": {k: None if x is None else float(x) for k, x in state.snr.items()},
            "sumsq": float(state.health.grad_sumsq)}


def pipe_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def gpipe_run(mesh, cases):
    """``gpipe`` of :func:`pipe_stage` over the ``pipe`` axis for each case
    (``{name: (params with a 'cot' cotangent, x)}``): the outputs on this
    rank, the gradients of x and of the stage parameters of ``sum(out *
    cot) / P`` (each rank's loss; their sum is ``sum(out * cot)``) summed
    over the ranks, and the collectives' calls."""
    from repro_torch.sharding.pipeline import gpipe

    res = {}
    for name, (params, x) in cases.items():
        mesh.collective_stats(reset=True)
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items() if k != "cot"}
        xt = torch.from_numpy(x).requires_grad_(True)
        out = gpipe(pipe_stage, p, xt, mesh=mesh)
        loss = (out * torch.from_numpy(params["cot"])).sum() / mesh.shape["pipe"]
        grads = torch.autograd.grad(loss, [xt] + list(p.values()))
        calls = {k: v["calls"] for k, v in mesh.collective_stats(reset=True).items()}
        whole = [_np(mesh.psum(g, tuple(mesh.shape))) for g in grads]
        res[name] = {"out": _np(out), "gx": whole[0], "gp": dict(zip(p, whole[1:])), "calls": calls}
    return res


# -- parameter-shard storage ------------------------------------------------

def _copy_state(tree):
    from repro_torch.checkpoint.store import named_leaves

    return {name: leaf.detach().clone() for name, leaf in named_leaves(tree)}


def param_shard_runs(mesh, arrays, data_kw, lr, steps, first_batch):
    """Reduced models stored as this rank's parameter shards
    (``repro_torch.launch.train``) from given weights (``{arch: arrays}``):
    for Adam and Table-3 SlimAdam, the shape of every parameter and state
    leaf, ``steps`` losses through the launcher's loop, and the persistent
    bytes beside the reckoned count; for Adam the first batch's gradient
    shards beside the cut of the whole-parameter port's averaged gradients
    (``Trainer`` on the same mesh); a guarded step whose gradients are NaN
    (skipped, state bit-identical), then a good one."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch import train as launch
    from repro_torch.sharding import ShardingContext, logical, use_sharding
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import make_grad_fn

    out = {"coords": dict(mesh.coords)}
    batch = {k: torch.from_numpy(v) for k, v in first_batch.items()}
    for arch, arr in arrays.items():
        cfg = get_reduced(arch)
        whole = params_from_numpy(arr, "cpu")
        data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
        res = {}
        with use_sharding(ShardingContext(mesh)):
            for opt in ("adam", "slim"):
                run = launch.build(cfg, opt, lr, mesh, whole=whole)
                res[f"{opt}_shapes"] = {name: tuple(t.shape) for name, t in _copy_state(run.state()).items()}
                res[f"{opt}_bytes"] = (run.persistent_bytes(), launch.reckon_bytes(cfg, opt, lr, mesh))
                if opt == "adam":
                    logical.region_counts(reset=True)
                    grads, _ = make_grad_fn(run.model, grad_shardings=run.p_sh)(batch)
                    res["regions"] = logical.region_counts(reset=True)
                    tr = Trainer(cfg, "adam", lr, data, TrainerConfig(backend="fused"), device="cpu")
                    tr.model.load_params(whole)
                    ref, _ = make_grad_fn(tr.model, mesh=mesh)(batch)
                    res["grads"] = {k: (_np(g), _np(run.p_sh[k].shard(ref[k]))) for k, g in grads.items()}
                rows, _ = launch.train(run, data, steps, log=lambda *a: None)
                res[opt] = [r["loss"] for r in rows]
            run = launch.build(cfg, "adam", lr, mesh, guard=True, whole=whole)
            before = _copy_state(run.state())
            state, bad = run.step(run.opt_state, batch, {"lr_scale": 1.0, "grad_scale": float("nan")})
            after = _copy_state(run.state(state))
            state, good = run.step(state, batch, {"lr_scale": 1.0, "grad_scale": 1.0})
            res["guard"] = {"skipped": (float(bad["step_skipped"]), float(good["step_skipped"])),
                            "nonfinite": float(bad["nonfinite_count"]),
                            "same": before.keys() == after.keys()
                            and all(torch.equal(before[k], after[k]) for k in before),
                            "moved": not torch.equal(before["params.final_norm.scale"],
                                                     run.model.params["final_norm.scale"])}
        out[arch] = res
    return out


def param_shard_checkpoints(mesh, arrays, data_kw, lr, jax_ckpt, own_ckpt):
    """Reduced gpt_small's Adam stored as parameter shards, from given
    weights: 2 steps through the launcher's loop, checkpointed (gathered
    whole, rank 0 writes ``own_ckpt``), then 2 more; a fresh build resumed
    from that checkpoint for steps 3-4; a fresh build restored from
    ``jax_ckpt``'s step 2 (the JAX package's Trainer wrote it) and trained to
    step 4. Returns the losses, the whole parameters at step 2 (gathered),
    and the largest difference of each restored shard from the cut of its
    stored array."""
    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch import train as launch
    from repro_torch.sharding import ShardingContext, use_sharding

    cfg = get_reduced("gpt_small")
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
    quiet = lambda *a: None   # noqa: E731
    out = {"coords": dict(mesh.coords)}
    with use_sharding(ShardingContext(mesh)):
        run = launch.build(cfg, "adam", lr, mesh, whole=params_from_numpy(arrays, "cpu"))
        first, state = launch.train(run, data, 2, ckpt=own_ckpt, ckpt_every=2, log=quiet)
        out["step2_params"] = store.gather_to_host(run.model.params, run.p_sh)
        rest, _ = launch.train(run._replace(opt_state=state), data, 4, start=2, log=quiet)
        out["losses"] = [r["loss"] for r in first + rest]
        resumed = launch.build(cfg, "adam", lr, mesh, whole=params_from_numpy(arrays, "cpu"))
        state, extra = launch.restore(resumed, own_ckpt)
        rows, _ = launch.train(resumed._replace(opt_state=state), data, 4, start=int(extra["step"]), log=quiet)
        out["resumed"] = [r["loss"] for r in rows]
        foreign = launch.build(cfg, "adam", lr, mesh, gen=torch.Generator().manual_seed(9))
        state, extra = launch.restore(foreign, jax_ckpt, step=2)
        stored = np.load(f"{jax_ckpt}/step_00000002/arrays.npz")
        cuts = dict(store.named_leaves(foreign.shardings()))
        out["foreign_err"] = max(float(np.abs(_np(leaf) - _np(cuts[name].shard(torch.from_numpy(stored[name])))
                                              if name in cuts else _np(leaf) - stored[name]).max())
                                 for name, leaf in store.named_leaves(foreign.state(state)))
        rows, _ = launch.train(foreign._replace(opt_state=state), data, 4, start=int(extra["step"]), log=quiet)
        out["foreign"] = [r["loss"] for r in rows]
    return out


def param_shard_optimizers(mesh, arrays, data_kw, lr, steps, cases, names):
    """Each ``(arch, optimizer, backend)`` of ``cases`` stored as this
    rank's parameter shards from given weights (``{arch: arrays}``): the
    shape of every parameter and state leaf, ``steps`` losses through the
    launcher's loop, the persistent bytes beside the reckoned count, and the
    losses of the whole-parameter ``Trainer`` on the same mesh with the same
    optimizer and backend; then one step of reduced gpt_small under each
    optimizer of ``names`` on the fused backend (``slim_snr`` with rules
    that compress nothing)."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch import train as launch
    from repro_torch.sharding import ShardingContext, use_sharding
    from repro_torch.train import Trainer, TrainerConfig

    out = {"coords": dict(mesh.coords)}
    for arch, opt, backend in cases:
        cfg = get_reduced(arch)
        whole = params_from_numpy(arrays[arch], "cpu")
        data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
        with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
            run = launch.build(cfg, opt, lr, mesh, backend=backend, whole=whole)
            shapes = {name: tuple(t.shape) for name, t in _copy_state(run.state()).items()}
            held = (run.persistent_bytes(), launch.reckon_bytes(cfg, opt, lr, mesh, backend=backend))
            rows, _ = launch.train(run, data, steps, log=lambda *a: None)
            tr = Trainer(cfg, opt, lr, data, TrainerConfig(backend=backend, total_steps=steps, log_every=1),
                         device="cpu")
            tr.model.load_params(whole)
            tr.opt_state = tr.tx.init(tr.params)
            tr.run()
        out[(arch, opt, backend)] = {"shapes": shapes, "bytes": held, "losses": [r["loss"] for r in rows],
                                     "trainer": [m["loss"] for m in tr.metrics_log]}
    cfg = get_reduced("gpt_small")
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
    whole = params_from_numpy(arrays["gpt_small"], "cpu")
    with use_sharding(ShardingContext(mesh)):
        _, meta = cfg.abstract()
        for name in names:
            rules = {k: () for k in meta} if name == "slim_snr" else None
            run = launch.build(cfg, name, lr, mesh, rules=rules, whole=whole)
            rows, _ = launch.train(run, data, 1, log=lambda *a: None)
            out[name] = rows[0]["loss"]
    return out


# -- decode on the mesh -------------------------------------------------------

def decode_config(case):
    """The port's config of a decode case: the reduced ``arch`` (its
    ``optimized()`` fields with ``optimized``), with ``fields`` replaced
    (a dtype by its torch name)."""
    import dataclasses

    from repro_torch.configs import get_optimized, get_reduced

    cfg = get_optimized(case["arch"], reduced=True) if case.get("optimized") else get_reduced(case["arch"])
    fields = {k: getattr(torch, v) if k == "dtype" else v for k, v in case.get("fields", {}).items()}
    return dataclasses.replace(cfg, **fields)


def _cache_np(cache):
    """{slot: [each cache tensor but the fill index, as numpy]}."""
    return {k: [_np(t) for f, t in zip(c._fields, c) if f != "index"] for k, c in cache.slots.items()}


def serve_tokens(cfg, params, cache, tokens, steps):
    """``make_serve_step`` for ``steps`` steps: the columns of ``tokens``
    (B, T) fed first, then the step's own greedy tokens. Returns (each
    step's logits (B, V) and next tokens (B,), the cache)."""
    from repro_torch.train.step import make_serve_step

    step = make_serve_step(cfg)
    logits, nexts = [], []
    tok = None
    for t in range(steps):
        if t < tokens.shape[1]:
            tok = tokens[:, t:t + 1]
        tok, lg, cache = step(params, cache, tok)
        logits.append(_np(lg[:, 0]))
        nexts.append(tok[:, 0].numpy().copy())
    return np.stack(logits), np.stack(nexts), cache


def decode_mesh(mesh, cases):
    """Each case (``{name: dict(arch, fields, optimized, arrays, tokens,
    steps, max_seq)}``) served on the mesh in the decode layout: this
    rank's stored parameter shards (``launch.train.stored_weights`` cut from
    the whole arrays), its rows of the tokens, its block of a
    ``max_seq``-position cache (``init_decode_cache`` under the context),
    ``steps`` steps through ``make_serve_step``. Returns each step's logits
    and next tokens for the rank's rows, its cache blocks, the region counts
    and the last step's collectives."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.train import stored_weights
    from repro_torch.models import transformer
    from repro_torch.sharding import ShardingContext, logical, use_sharding

    out = {"coords": dict(mesh.coords)}
    d, n_data = mesh.coords["data"], mesh.shape["data"]
    for name, case in cases.items():
        cfg = decode_config(case)
        rows = case["tokens"].shape[0] // n_data
        tokens = torch.from_numpy(case["tokens"][d * rows:(d + 1) * rows])
        with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
            params = stored_weights(cfg, mesh, whole=params_from_numpy(case["arrays"], "cpu"))
            cache = transformer.init_decode_cache(cfg, case["tokens"].shape[0], case["max_seq"], cfg.dtype)
            logical.region_counts(reset=True)
            logits, nexts, cache = serve_tokens(cfg, params, cache, tokens, case["steps"])
            regions = logical.region_counts(reset=True)
        out[name] = {"logits": logits, "next": nexts, "cache": _cache_np(cache), "regions": regions,
                     "step": cache.step}
    return out


def decode_cell_step(mesh, arch, seq, batch):
    """One decode step of the dry run's reduced ``decode_32k`` cell
    (``launch.dryrun.cell_config``: bf16 parameters drawn by
    ``stored_weights``, a bf16 cache of ``seq`` positions for ``batch``
    global rows) on this rank of the mesh: its persistent bytes (parameter
    shards and cache block), the step's collectives by kind and its kernel
    launches."""
    from repro_torch import kernels
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import stored_weights
    from repro_torch.models import transformer
    from repro_torch.sharding import P, ShardingContext, use_sharding
    from repro_torch.train.step import make_serve_step

    cfg = dryrun.cell_config(arch, "decode_32k", reduced=True, seq=seq)
    with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
        params = stored_weights(cfg, mesh)
        cache = transformer.init_decode_cache(cfg, batch, seq)
        tokens = mesh.shard(torch.zeros((batch, 1), dtype=torch.int32), P("data", None))
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)   # noqa: E731
        held = {"params": nbytes(params.values()), "opt": 0,
                "cache": nbytes(t for c in cache.slots.values() for t in c)}
        kernels.reset_launch_counts()
        mesh.collective_stats(reset=True)
        make_serve_step(cfg)(params, cache, tokens)
        stats = mesh.collective_stats(reset=True)
    return {"coords": dict(mesh.coords), "bytes": held,
            "collectives": {k: {"calls": int(v["calls"]), "bytes": int(v["bytes"])} for k, v in stats.items()},
            "launches": {k: v for k, v in kernels.launch_counts().items() if v}}


def train_cell_peak(mesh, arch, seq, batch):
    """One step of the dry run's reduced ``train_4k`` cell
    (``launch.dryrun.cell_config``; ``launch.train.build``: Table-3
    SlimAdam on the fused route, grad_accum 1) on this
    rank: its persistent bytes and the peak of the live tensors over the
    step (``MemTracker`` with the parameter and optimizer-state shards
    tracked from the start, each storage once however the step views it)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_leaves

    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch import dryrun, train as launch
    from repro_torch.sharding import ShardingContext, use_sharding

    cfg = dryrun.cell_config(arch, "train_4k", reduced=True, seq=seq)
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
        run = launch.build(cfg, "slim", 3e-4, mesh, backend="fused", grad_accum=1)
        batch_ = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
        mem = MemTracker()
        mem.track_external(*run.model.params.values(),
                           *(t for t in tree_leaves(run.opt_state) if isinstance(t, torch.Tensor)))
        with mem:
            run.step(run.opt_state, batch_)
    peak = mem.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    return {"coords": dict(mesh.coords), "bytes": run.persistent_bytes(), "peak": int(peak)}


# -- the launcher on a mesh ----------------------------------------------------

# The harness's small meshes with the production meshes' axes: what
# ``launch.mesh.make_production_mesh`` builds in the launcher's rank
# processes here, in place of (16, 16) and (2, 16, 16).
LAUNCH_MESHES = {False: ((2, 2), ("data", "model")), True: ((2, 2, 2), ("pod", "data", "model"))}


def launcher_main(mesh, argvs, plan=None, lazy_disk: bool = False):
    """``repro_torch.launch.train.main(argv)`` on this rank for each of
    ``argvs``, as a torchrun rank runs it, with the production mesh
    replaced by :data:`LAUNCH_MESHES`' of the same axes. ``mesh`` is the
    harness's own (None for a fresh rank, whose group ``main`` starts from
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``). Every argv
    names ``--optimizer``, ``--backend`` and ``--lr``. Captured from
    ``train``'s call: each step's metrics, the mesh ``main`` built, this
    rank's shard shapes and final shards, its bytes beside ``reckon_bytes``
    under the same context, the steps its rollbacks restored, and what
    ``main`` printed.

    A ``--guard`` run takes the faults of ``plan`` (a ``FaultPlan``, 0-based
    steps) as the Trainer takes them: a NaN or Inf step's gradients scaled
    through the guard's controls (the state copied before and after the
    first such step), a spike step's loss multiplied where the guard
    observes it; its guard's counters are kept. ``lazy_disk``: in a
    ``--guard`` run rank 0's background checkpoint writes land only once
    rank 0 waits for them (``AsyncCheckpointer.wait``), the slowest disk the
    launcher must be right on."""
    import contextlib
    import io
    import threading

    from repro_torch import injection
    from repro_torch.checkpoint import store
    from repro_torch.launch import mesh as launch_mesh, train as launch
    from repro_torch.train.faults import FaultPlan

    launch_mesh.make_production_mesh = lambda *, multi_pod=False, **kw: launch_mesh.make_mesh(
        *LAUNCH_MESHES[multi_pod], **kw)
    plan = plan or FaultPlan()
    real = {"Guard": launch.Guard, "train": launch.train, "restore": launch.restore}
    seen = {}

    class Guard(real["Guard"]):
        def controls(self, grad_scale=1.0):
            seen["guard"] = self
            return super().controls(grad_scale * plan.grad_scale(seen["at"]))

        def observe(self, loss, **kw):
            return super().observe(plan.corrupt_loss(seen["at"] - 1, loss), **kw)

    def restore(run, ckpt, step=None):
        opt_state, extra = real["restore"](run, ckpt, step)
        seen["restored"].append(int(extra["step"]))
        return opt_state, extra

    def train(run, data, steps, *, start=0, **kw):
        argv = seen["argv"]
        flag = lambda name: argv[argv.index(name) + 1]   # noqa: E731
        seen.update(at=start, start=start, run=run, reckoned=launch.reckon_bytes(
            run.model.cfg, flag("--optimizer"), float(flag("--lr")), run.mesh, backend=flag("--backend"),
            guard="--guard" in argv))
        step = run.step

        def counted(opt_state, batch, *controls):
            poisoned = controls and "before" not in seen and seen["at"] in plan.nan_grad_steps + plan.inf_grad_steps
            if poisoned:
                seen["before"] = _copy_state(run.state(opt_state))
            new_state, metrics = step(opt_state, batch, *controls)
            if poisoned:
                seen["after"] = _copy_state(run.state(new_state))
            seen["at"] += 1
            return new_state, metrics

        rows, opt_state = real["train"](run._replace(step=counted), data, steps, start=start, **kw)
        seen.update(rows=rows, opt_state=opt_state)
        return rows, opt_state

    lead = (mesh.rank if mesh is not None else int(os.environ["RANK"])) == 0
    real["wait"] = store.AsyncCheckpointer.wait

    def wait(acp):
        seen["landed"].set()
        return real["wait"](acp)

    def hold(step):
        if "--guard" in seen["argv"] and lead:
            seen["landed"].wait(timeout=120)

    launch.Guard, launch.train, launch.restore = Guard, train, restore
    store.AsyncCheckpointer.wait = wait
    out = {"coords": None if mesh is None else dict(mesh.coords)}
    try:
        with injection.installed(store.IO_FAULT_POINT, hold) if lazy_disk else contextlib.nullcontext():
            for argv in argvs:
                seen.clear()
                seen.update(argv=argv, restored=[], landed=threading.Event())
                printed = io.StringIO()
                with contextlib.redirect_stdout(printed):
                    launch.main(argv)
                run = seen["run"]
                state = _copy_state(run.state(seen["opt_state"]))
                res = {"mesh": dict(run.mesh.shape), "coords": dict(run.mesh.coords), "start": seen["start"],
                       "rows": seen["rows"], "printed": printed.getvalue(), "restored": seen["restored"],
                       "shapes": {k: tuple(t.shape) for k, t in state.items()},
                       "state": {k: _np(t) for k, t in state.items()},
                       "bytes": (run.persistent_bytes(), seen["reckoned"])}
                if "guard" in seen:
                    res["counters"] = dict(seen["guard"].counters)
                if "before" in seen:
                    before, after = seen["before"], seen["after"]
                    res["same"] = before.keys() == after.keys() and all(torch.equal(before[k], after[k])
                                                                        for k in before)
                out[" ".join(argv)] = res
    finally:
        launch.Guard, launch.train, launch.restore = real["Guard"], real["train"], real["restore"]
        store.AsyncCheckpointer.wait = real["wait"]
    return out


def launcher_recipe(mesh, arrays, data_kw, lr, steps):
    """JAX's launcher recipe by hand on this rank of ``mesh``:
    ``launch.train.build(whole=...)`` from given weights (``{arch:
    arrays}``) and ``train`` for ``steps`` steps, Adam and Table-3 SlimAdam
    on the fused route. Returns each run's shard shapes and losses."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch import train as launch
    from repro_torch.sharding import ShardingContext, use_sharding

    out = {"coords": dict(mesh.coords)}
    for arch, arr in arrays.items():
        cfg = get_reduced(arch)
        data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
        with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
            for opt in ("adam", "slim"):
                run = launch.build(cfg, opt, lr, mesh, whole=params_from_numpy(arr, "cpu"))
                shapes = {name: tuple(t.shape) for name, t in _copy_state(run.state()).items()}
                rows, _ = launch.train(run, data, steps, log=lambda *a: None)
                out[(arch, opt)] = {"shapes": shapes, "losses": [r["loss"] for r in rows]}
    return out


def gathered_state(mesh, dsts):
    """Reduced gpt_small's launcher state (Table-3 SlimAdam on the fused
    route: owner slices) on this rank of the mesh, gathered whole to every
    rank and to each rank of ``dsts`` alone (``store.gather_to_host``):
    what this rank got each way."""
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train as launch
    from repro_torch.sharding import ShardingContext, use_sharding

    cfg = get_reduced("gpt_small")
    with use_sharding(ShardingContext(mesh)):
        run = launch.build(cfg, "slim", 1e-3, mesh, backend="fused")
        out = {"all": store.gather_to_host(run.state(), run.shardings())}
        for dst in dsts:
            out[dst] = store.gather_to_host(run.state(), run.shardings(), dst=dst)
    return {k: None if v is None else {name: np.asarray(x) for name, x in store.named_leaves(v)}
            for k, v in out.items()}


def launcher_job(mesh, argvs, plan, lazy_disk, arrays, data_kw, lr, steps, dsts):
    """:func:`launcher_main`, :func:`launcher_recipe` and
    :func:`gathered_state` on the same ranks."""
    return {"main": launcher_main(mesh, argvs, plan, lazy_disk),
            "recipe": launcher_recipe(mesh, arrays, data_kw, lr, steps), "gathered": gathered_state(mesh, dsts)}
