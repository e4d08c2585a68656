"""Distributed training driver (port of ``repro/launch/train.py``, same
flags): a mesh, the sharded train loop and checkpointing.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt_small --steps 100 --mesh none
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train --arch gpt_small --mesh single

``--arch`` takes any of the 13 architectures that read tokens alone (the
encoders and the VLM take other inputs and raise). ``--mesh none`` trains
one process on the reduced config through ``Trainer``; ``single`` and
``multi`` build the production meshes, (data=16, model=16) and (pod=2,
data=16, model=16), with one process per rank: rank, world size and local
rank come from the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for the rendezvous).
Runs on the GPU; ``--device cpu`` (or ``main(argv, device="cpu")``) runs
on the CPU (over gloo on a mesh):

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon_mamba_7b --reduced --device cpu --steps 4

On a mesh every rank stores the parameters and the optimizer state as
``repro/launch/train.py:69-92`` does (parameter-shard storage): the
parameters as this rank's shards of their ``param_specs`` (``embed`` over
``data``, ``vocab``, ``mlp``, ``heads``, ``kv_heads``, ``experts`` and
``d_inner`` over ``model``, as far as each dim divides), the optimizer
state as its shards of ``opt_state_specs(owner_mesh=mesh)``, and the step
is built with ``grad_shardings`` (:class:`Sharded`, :func:`train`): its own
loop, as JAX's, with ``store.AsyncCheckpointer`` (the shards gathered whole,
rank 0 writes the JAX package's format) and the guard; a resume cuts each
rank's shards from the checkpoint. Every optimizer of ``OPTIMIZERS``
serves it: the Adam/SlimAdam family on the route ``--backend`` names (the
fused kernels on each rank's shards, or the plain math with each mean of
g^2 completed across the mesh), the other baselines in plain math with
their reductions completed across the mesh; the context takes the
config's ``sharding_overrides`` as its rules.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..checkpoint import store
from ..configs import ARCH_IDS, get_config, get_reduced
from ..core.labels import flatten_with_names
from ..data import DataConfig, ZipfLM
from ..sharding import ShardingContext, opt_state_specs, param_specs, shardings_from_specs, use_sharding
from ..sharding.logical import Weights
from ..sharding.shardspec import local_shape
from ..train.guard import ROLLBACK, Guard, GuardConfig
from ..train.step import make_train_step
from ..optim.base import resolve_backend
from ..train.trainer import _SLIM_FAMILY, OPTIMIZERS, Trainer, TrainerConfig, make_optimizer


class ShardModel(NamedTuple):
    """What the step reads of a model stored as shards: its config, this
    rank's parameter shards ``{name: tensor}`` and the meta tree."""
    cfg: Any
    params: Dict[str, torch.Tensor]
    meta: Dict[str, Any]


def shard_params(whole: Mapping[str, torch.Tensor], shardings: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """This rank's shards of whole parameters (new tensors that require
    grad), by their NamedShardings."""
    return {k: shardings[k].shard(w).detach().clone().requires_grad_(True) for k, w in whole.items()}


def init_shards(cfg, shardings: Mapping[str, Any], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The weights ``cfg.init(gen, device)`` draws, kept as this rank's
    shards: each leaf drawn whole in tree order (the same values), cut and
    freed, so one whole leaf is live at a time. On ``meta`` (a dry run)
    only the shards' shapes, nothing drawn."""
    out = {}
    if torch.device(device).type == "meta":
        for name, s in flatten_with_names(cfg.specs()):
            shape = local_shape(tuple(s.shape), shardings[name].spec, shardings[name].mesh)
            out[name] = torch.empty(shape, dtype=s.dtype, device="meta", requires_grad=True)
        return out
    for name, s in flatten_with_names(cfg.specs()):
        whole = s.init(gen, s.shape, s.dtype).to(device)
        out[name] = shardings[name].shard(whole).detach().clone().requires_grad_(True)
        del whole
    return out


def stored_weights(cfg, mesh, *, whole: Optional[Mapping[str, torch.Tensor]] = None,
                   gen: Optional[torch.Generator] = None) -> Weights:
    """This rank's shards of ``cfg``'s parameters under their specs in the
    active context, as :func:`build` stores them, without gradients: the
    ``Weights`` a decode step serves from (``train.step.make_serve_step``).
    Cut from ``whole``, or drawn from ``gen`` (default: a CPU generator
    seeded 0) leaf by leaf (:func:`init_shards`); on a ``meta`` mesh only
    their shapes."""
    abstract, meta = cfg.abstract()
    p_sh = shardings_from_specs(param_specs(meta, abstract), mesh)
    if whole is not None:
        params = {k: p_sh[k].shard(whole[k].detach().to(mesh.device)).clone() for k in abstract}
    else:
        params = init_shards(cfg, p_sh, gen if gen is not None else torch.Generator().manual_seed(0), mesh.device)
        params = {k: t.detach() for k, t in params.items()}
    return Weights(params, {k: sh.spec for k, sh in p_sh.items()}, mesh)


class Sharded(NamedTuple):
    """One rank's sharded training state: the model's shards, their
    ``NamedSharding``s (``p_sh``), the optimizer, its state and the state's
    shardings (``o_sh``), and the step built with ``grad_shardings=p_sh``
    (``step(opt_state, batch[, controls]) -> (opt_state, metrics)``; the
    parameter shards are updated in place)."""
    model: ShardModel
    p_sh: Dict[str, Any]
    tx: Any
    opt_state: Any
    o_sh: Any
    step: Callable
    mesh: Any

    def state(self, opt_state=None) -> Dict[str, Any]:
        return {"params": self.model.params, "opt": self.opt_state if opt_state is None else opt_state}

    def shardings(self) -> Dict[str, Any]:
        return {"params": self.p_sh, "opt": self.o_sh}

    def persistent_bytes(self) -> Dict[str, int]:
        """This rank's bytes of parameter shards and optimizer-state shards
        (gradients and updates are shards of the parameters' size too,
        live within a step)."""
        nbytes = lambda tree: sum(t.numel() * t.element_size() for _, t in store.named_leaves(tree)   # noqa: E731
                                  if isinstance(t, torch.Tensor))
        return {"params": nbytes(self.model.params), "opt": nbytes(self.opt_state)}


def owner_mesh(mesh, backend: str):
    """The mesh when ``backend`` resolves to the fused route on its device
    (the psum leaves' reduced moments stored as owner slices), else None
    (the masked specs of the 'jnp' route): ``repro/launch/train.py:78``."""
    return mesh if resolve_backend(backend, getattr(mesh, "device", None)) == "fused" else None


def _layout(cfg, optimizer: str, lr, mesh, rules, backend: str, emit_health: bool):
    """(global parameters on ``meta``, meta, their specs, the unsharded
    optimizer's state on ``meta``, its specs): the shapes and layouts of
    ``repro/launch/train.py:62-82``, nothing allocated; the specs under the
    active sharding context (a config's ``sharding_overrides`` among its
    rules)."""
    abstract, meta = cfg.abstract()
    p_specs = param_specs(meta, abstract)
    # the state's specs from the unsharded optimizer's state on meta tensors
    state = make_optimizer(optimizer, lr, abstract, meta, rules=rules, backend=backend,
                           emit_health=emit_health).init(abstract)
    return abstract, meta, p_specs, state, opt_state_specs(state, abstract, p_specs,
                                                           owner_mesh=owner_mesh(mesh, backend))


def build(cfg, optimizer: str, lr, mesh, *, backend: str = "fused", guard: bool = False, grad_accum: int = 1,
          rules: Optional[Dict[str, Any]] = None, gen: Optional[torch.Generator] = None,
          whole: Optional[Mapping[str, torch.Tensor]] = None) -> Sharded:
    """The sharded state of ``repro/launch/train.py:62-92`` on this rank of
    ``mesh``, under a ``ShardingContext(mesh)`` the caller keeps active for
    the steps: the parameters' specs from the global shapes (on ``meta``,
    nothing allocated), the weights drawn from ``gen`` (default: a CPU
    generator seeded 0) or cut from ``whole`` and kept as shards, the
    optimizer (any of ``OPTIMIZERS``; ``backend`` names the Adam/SlimAdam
    family's route) with ``param_shards=True`` and its state, and the
    step. ``emit_health`` rides a guarded step on the Adam/SlimAdam family;
    the other optimizers' guarded steps read the gradient norm, as in
    ``Trainer``."""
    emit_health = guard and optimizer in ("adam",) + _SLIM_FAMILY
    abstract, meta, p_specs, _, o_specs = _layout(cfg, optimizer, lr, mesh, rules, backend, emit_health)
    p_sh = shardings_from_specs(p_specs, mesh)
    if whole is not None:
        params = shard_params({k: whole[k].to(mesh.device) for k in abstract}, p_sh)
    else:
        params = init_shards(cfg, p_sh, gen if gen is not None else torch.Generator().manual_seed(0), mesh.device)
    tx = make_optimizer(optimizer, lr, abstract, meta, rules=rules, backend=backend, emit_health=emit_health,
                        mesh=mesh, param_specs=p_specs, param_shards=True)
    model = ShardModel(cfg, params, meta)
    step = make_train_step(model, tx, grad_accum=grad_accum, guard=guard, mesh=mesh, grad_shardings=p_sh)
    return Sharded(model, p_sh, tx, tx.init(params), shardings_from_specs(o_specs, mesh), step, mesh)


def reckon_bytes(cfg, optimizer: str, lr, mesh, *, backend: str = "fused", guard: bool = False,
                 rules: Optional[Dict[str, Any]] = None) -> Dict[str, int]:
    """This rank's persistent bytes of parameter and optimizer-state
    shards, reckoned from the global shapes and their specs alone
    (``shardspec.local_shape``): what :meth:`Sharded.persistent_bytes` of
    :func:`build` with the same arguments holds."""
    emit_health = guard and optimizer in ("adam",) + _SLIM_FAMILY
    abstract, _, p_specs, state, o_specs = _layout(cfg, optimizer, lr, mesh, rules, backend, emit_health)

    def count(tree, specs):
        by_name = dict(store.named_leaves(shardings_from_specs(specs, mesh)))
        return sum(math.prod(local_shape(tuple(t.shape), by_name[name].spec, mesh)) * t.element_size()
                   for name, t in store.named_leaves(tree))

    return {"params": count(abstract, p_specs), "opt": count(state, o_specs)}


def restore(run: Sharded, ckpt: str, step: Optional[int] = None) -> tuple:
    """Load the newest valid checkpoint of ``ckpt`` (or ``step``'s) into
    ``run``: each rank's parameter shards in place (cut from the whole
    arrays), and (the optimizer state's shards, the extra dict)."""
    state, extra = store.restore(ckpt, run.state(), step=step, shardings=run.shardings())
    with torch.no_grad():
        for k, p in run.model.params.items():
            p.copy_(state["params"][k])
    return state["opt"], extra


def save(run: Sharded, opt_state, acp: store.AsyncCheckpointer, ckpt: str, step: int) -> None:
    """Gather the state whole to rank 0, leaf by leaf (a collective: every
    rank calls it), and have rank 0 hand it to ``acp``: the same files as an
    unsharded run's."""
    host = store.gather_to_host(run.state(opt_state), run.shardings(), dst=0)
    if host is not None:
        acp.save(ckpt, step, host, extra={"step": step})


def train(run: Sharded, data: ZipfLM, steps: int, *, start: int = 0, ckpt: Optional[str] = None,
          ckpt_every: int = 0, guard: Optional[Guard] = None, log_every: int = 10,
          log: Callable[[str], None] = print) -> Tuple[List[Dict[str, float]], Any]:
    """JAX's loop (``repro/launch/train.py:105-150``) from step ``start`` to
    ``steps`` on ``run``: every rank takes the global batch (the step keeps
    its rows), the guard's controls on a guarded step and its rollback to
    the last checkpoint, a checkpoint every ``ckpt_every`` steps through
    one ``AsyncCheckpointer`` (waited on before returning). Returns (the
    metrics of every step, read to the host; the optimizer state); ``log``
    prints every ``log_every`` steps (pass a no-op on ranks other than 0)."""
    device = run.mesh.device
    acp = store.AsyncCheckpointer()
    opt_state = run.opt_state
    out: List[Dict[str, float]] = []
    t0 = time.time()
    for s in range(start, steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(s).items()}
        if guard is not None:
            controls = guard.controls()
            opt_state, metrics = run.step(opt_state, batch, controls)
            action = guard.observe(float(metrics["loss"]), skipped=bool(metrics["step_skipped"] > 0),
                                   nonfinite=float(metrics["nonfinite_count"]))
            if action == ROLLBACK:
                guard.note_rollback()
                if ckpt:
                    # rank 0 writes the checkpoints in the background: its writes land before any rank
                    # looks, so every rank restores the same step
                    acp.wait()
                    run.mesh.barrier()
                if ckpt and store.latest_step(ckpt) is not None:
                    opt_state, extra = restore(run._replace(opt_state=opt_state), ckpt)
                    log(f"step {s + 1}: guard rolled back to checkpoint step {int(extra.get('step', 0))}")
        else:
            opt_state, metrics = run.step(opt_state, batch)
        row = {k: float(v) for k, v in metrics.items()}
        row["step"] = s + 1
        out.append(row)
        if (s + 1) % log_every == 0:
            tput = (s + 1 - start) * data.cfg.global_batch * data.cfg.seq_len / (time.time() - t0)
            extra_log = ""
            if guard is not None:
                c = guard.counters
                extra_log = (f" skipped {c['skipped']} backoffs {c['backoffs']} rollbacks {c['rollbacks']}"
                             f" lr_scale {guard.lr_scale:.2f}")
            log(f"step {s + 1}: loss {row['loss']:.4f} grad_norm {row['grad_norm']:.3f} tok/s {tput:.0f}" + extra_log)
        if ckpt and ckpt_every and (s + 1) % ckpt_every == 0:
            save(run, opt_state, acp, ckpt, s + 1)
    acp.wait()
    run.mesh.barrier()
    return out, opt_state


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm_135m")
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--mesh", choices=("none", "single", "multi"), default="none")
    ap.add_argument("--optimizer", default="slim", choices=OPTIMIZERS)
    ap.add_argument("--backend", choices=("jnp", "fused", "auto"), default="auto",
                    help="Adam/SlimAdam execution path; 'fused' + a mesh runs the kernels on each rank's shards")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--guard", action="store_true",
                    help="fault-tolerant step: in-pass anomaly health, skip poisoned steps, lr backoff on loss "
                         "spikes, rollback to the last checkpoint on repeated faults")
    ap.add_argument("--device", default=None, help="default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    device = args.device or device

    cfg = get_reduced(args.arch) if args.reduced or args.mesh == "none" else get_config(args.arch)
    if not cfg.embed_inputs or cfg.extra_embed_len:
        raise ValueError(f"arch {args.arch!r} takes frame embeddings, patches or frontend embeddings; this launcher "
                         "feeds ZipfLM tokens only (train it through train.step.make_train_step)")
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    if args.mesh == "none":
        tc = TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                           ckpt_every=max(args.steps // 4, 1) if args.ckpt else 0, ckpt_dir=args.ckpt,
                           backend=args.backend, guard=GuardConfig() if args.guard else None)
        tr = Trainer(cfg, args.optimizer, args.lr, data, tc, grad_accum=args.grad_accum, device=device)
        start = tr.step
        if start:
            print(f"resumed from step {start}")
        t0 = time.time()
        tr.run()
        for m in tr.metrics_log:
            extra = ""
            if tr.guard is not None:
                extra = (f" skipped {int(m['guard_skipped'])} backoffs {int(m['guard_backoffs'])} rollbacks "
                         f"{int(m['guard_rollbacks'])} lr_scale {m['guard_lr_scale']:.2f}")
            print(f"step {int(m['step'])}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.3f}" + extra)
        print(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s")
        if tr.guard is not None:
            print("guard counters:", tr.guard.counters)
        return

    from .mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), device=resolve_device(device))
    lead = mesh.rank == 0
    log = print if lead else (lambda *a: None)
    with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
        run = build(cfg, args.optimizer, args.lr, mesh, backend=args.backend, guard=args.guard,
                    grad_accum=args.grad_accum)
        start = 0
        if args.ckpt and store.latest_step(args.ckpt) is not None:
            opt_state, extra = restore(run, args.ckpt)
            run = run._replace(opt_state=opt_state)
            start = int(extra.get("step", 0))
            log(f"resumed from step {start}")
        guard = Guard(GuardConfig()) if args.guard else None
        t0 = time.time()
        train(run, data, args.steps, start=start, ckpt=args.ckpt, ckpt_every=max(args.steps // 4, 1),
              guard=guard, log_every=args.log_every, log=log)
    log(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s")
    if guard is not None:
        log(f"guard counters: {guard.counters}")


if __name__ == "__main__":
    main()
