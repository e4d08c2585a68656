"""Trainer: optimizer registry, SNR measurement hooks, checkpoint/restart
and the guarded fault-tolerant loop (port of ``repro/train/trainer.py``).

The paper's loop: train Adam while measuring layer-wise SNR of its second
moments, derive SlimAdam rules from the averages (``derive_slim_rules``),
then train SlimAdam with those rules ('slim_snr') or with the paper's
Table-3 rules ('slim'). A :class:`repro_torch.train.guard.GuardConfig`
turns on the guarded step (in-pass health, skip/backoff/rollback);
``ckpt_every``/``ckpt_dir`` write atomic checkpoints that a new trainer on
the same directory resumes from; ``snr_from_update`` rides the SNR
measurement of a SlimAdam run on the update pass.

Under ``repro_torch.sharding.use_sharding(ShardingContext(mesh))`` (every
rank of a ``repro_torch.launch.mesh.Mesh`` builds its own trainer with the
same arguments) the trainer runs sharded, as the JAX one does under its
context: the optimizer and the SNR pass get the mesh and the parameter
specs, so the fused backend keeps each rank's shards of the optimizer state
and the train step splits the batch across the ranks; checkpoints hold
whole arrays (gathered, written by rank 0), and a restore cuts each rank's
shards. The baselines other than the Adam/SlimAdam family (adafactor,
sm3, lion, sgdm) keep their whole state on every rank there.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..checkpoint import store
from ..core import SNRTracker, derive_rules, measure_tree_snr, rules_as_tree, table3_rules
from ..core.baselines import (adafactor, adalayer_ln_tl_rules, adalayer_rules, adam_mini_v1_rules,
                              adam_mini_v2_rules, lion, sm3)
from ..core.slim_adam import ScaleBySlimAdamState, slim_adam
from ..data.pipeline import ZipfLM
from ..models.transformer import Transformer
from ..optim.adam import ScaleByAdamState, adamw, sgdm
from ..optim.base import resolve_backend
from ..sharding import current as current_sharding, opt_state_specs, param_specs, shardings_from_specs
from ..sharding.logical import is_process_mesh
from .guard import ROLLBACK, Guard, GuardConfig, find_slim_snr, find_state_field, strip_slim_snr
from .step import make_eval_step, make_train_step

OPTIMIZERS = ("adam", "slim", "slim_snr", "adalayer", "adalayer_ln_tl",
              "adam_mini_v1", "adam_mini_v2", "adafactor", "adafactor_v2",
              "sm3", "lion", "sgdm")
_SLIM_FAMILY = ("slim", "slim_snr", "adalayer", "adalayer_ln_tl",
                "adam_mini_v1", "adam_mini_v2")
_BASELINE_RULES = {"adalayer": adalayer_rules, "adalayer_ln_tl": adalayer_ln_tl_rules,
                   "adam_mini_v1": adam_mini_v1_rules, "adam_mini_v2": adam_mini_v2_rules}


def slim_rule_dims(name: str, params, meta, rules: Optional[Dict[str, Any]] = None):
    """Per-leaf reduction dims the slim-family optimizer ``name`` uses (one
    derivation shared by :func:`make_optimizer` and the from-update SNR
    consumer); None for an optimizer without compressed moments."""
    if name not in _SLIM_FAMILY:
        return None
    if name == "slim":
        r = table3_rules(meta)
    elif name == "slim_snr":
        if rules is None:
            raise ValueError("slim_snr requires derived rules")
        r = rules
    else:
        r = _BASELINE_RULES[name](meta)
    return rules_as_tree(r, params, meta)


def make_optimizer(name: str, lr, params, meta, *, weight_decay: float = 0.1, b1: float = 0.9,
                   b2: float = 0.95, grad_clip: float = 1.0, rules: Optional[Dict[str, Any]] = None,
                   backend: str = "jnp", emit_snr: bool = False, emit_health: bool = False,
                   megakernel: bool = True, mesh=None, param_specs=None, param_shards: bool = False):
    """Build any of the paper's optimizers (``OPTIMIZERS``). ``lr`` is a
    constant or a schedule (``repro_torch.optim.schedules``); ``rules`` are
    the derived rules 'slim_snr' needs. ``backend`` ('jnp' | 'fused' |
    'auto'), ``megakernel=False`` (the fused backend's per-leaf route) and
    ``mesh``/``param_specs`` (the sharded fused backend) apply to the
    Adam/SlimAdam family; the other baselines read ``mesh``/``param_specs``
    only with ``param_shards``. ``emit_snr``
    (slim family) builds the measure-step variant that publishes
    from-update SNR on its state; ``emit_health`` (Adam/slim family)
    publishes the in-pass StepHealth the guarded step reads.
    ``param_shards`` (parameter-shard storage, ``repro_torch.launch.train``;
    needs ``mesh`` and ``param_specs``): the parameters, gradients and
    updates are this rank's shards, for every optimizer; the Adam/SlimAdam
    family runs it on either backend, the other baselines complete their
    reductions across the mesh (``repro_torch.core.baselines``)."""
    shard_kw = dict(param_shards=True) if param_shards else {}
    base_kw = dict(mesh=mesh, param_specs=param_specs, param_shards=True) if param_shards else {}
    if emit_snr and name not in _SLIM_FAMILY:
        raise ValueError(f"emit_snr is only supported by the slim family {_SLIM_FAMILY}, not {name!r}")
    if emit_health and name not in ("adam",) + _SLIM_FAMILY:
        raise ValueError(f"emit_health is only supported by the Adam/slim family {('adam',) + _SLIM_FAMILY}, "
                         f"not {name!r}")
    if name == "adam":
        return adamw(lr, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip, backend=backend,
                     mesh=mesh, param_specs=param_specs, emit_health=emit_health, megakernel=megakernel, **shard_kw)
    if name in _SLIM_FAMILY:
        return slim_adam(lr, slim_rule_dims(name, params, meta, rules), b1=b1, b2=b2,
                         weight_decay=weight_decay, grad_clip=grad_clip, backend=backend, mesh=mesh,
                         param_specs=param_specs, emit_snr=emit_snr, emit_health=emit_health,
                         megakernel=megakernel, **shard_kw)
    if name == "adafactor":
        return adafactor(lr, weight_decay=weight_decay, grad_clip=grad_clip, **base_kw)
    if name == "adafactor_v2":
        return adafactor(lr, momentum=0.9, weight_decay=weight_decay, grad_clip=grad_clip, **base_kw)
    if name == "sm3":
        return sm3(lr, beta=0.95, weight_decay=weight_decay, grad_clip=grad_clip, **base_kw)
    if name == "lion":
        return lion(lr, weight_decay=weight_decay, grad_clip=grad_clip, **base_kw)
    if name == "sgdm":
        return sgdm(lr, weight_decay=weight_decay, grad_clip=grad_clip, **base_kw)
    raise ValueError(f"unknown optimizer {name!r}; choose from {OPTIMIZERS}")


def find_adam_nu(opt_state) -> Optional[Dict[str, torch.Tensor]]:
    """The second-moment dict inside a (chained, multi-step) Adam or
    SlimAdam state — what the paper's SNR analysis reads; None for the
    other baselines."""
    return find_state_field(opt_state, (ScaleByAdamState, ScaleBySlimAdamState), "nu")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    log_every: int = 50
    ckpt_every: int = 0              # 0 = disabled
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    measure_snr: bool = False
    snr_early_every: int = 100
    snr_late_every: int = 1000
    # Ride the SNR measurement on the update pass: measure steps run a
    # second train step whose optimizer update also emits per-leaf
    # from-update SNR (slim family only), and measure_tree_snr consumes it
    # instead of re-reading nu for the candidate K the optimizer reduces.
    snr_from_update: bool = False
    seed: int = 0
    # Backend for the Adam/SlimAdam update and the SNR pass: 'jnp' | 'fused' | 'auto'.
    backend: str = "jnp"
    # A GuardConfig turns on the guarded train step (in-pass health +
    # skip/backoff/rollback, see repro_torch.train.guard); None keeps the
    # plain step.
    guard: Optional[GuardConfig] = None


class Trainer:
    """Train ``model_cfg`` with ``optimizer_name`` on ``data``. Runs on CUDA
    unless ``device`` names another device; raises when no GPU is present
    and none is named. ``grad_accum`` splits each batch into that many
    microbatches; ``faults`` (a :class:`repro_torch.train.faults.FaultPlan`)
    injects gradient and loss faults into the guarded step. A trainer whose
    ``ckpt_dir`` holds a checkpoint resumes from it. The weights are drawn
    from ``gen`` (default: a CPU generator seeded with ``tc.seed``; a
    seeded CUDA generator draws a large model on the card)."""

    def __init__(self, model_cfg, optimizer_name: str, lr, data: ZipfLM,
                 tc: Optional[TrainerConfig] = None, *, optimizer_kw: Optional[dict] = None,
                 rules: Optional[dict] = None, grad_accum: int = 1, faults=None, device=None,
                 gen: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        ctx = current_sharding()
        # a device-free SpecMesh context shapes the forward (the MoE's
        # dispatch groups) but shards nothing: the trainer runs unsharded
        self.mesh = ctx.mesh if ctx is not None and is_process_mesh(ctx.mesh) else None
        if self.mesh is not None and self.mesh.device.type != self.device.type:
            raise ValueError(f"the mesh runs on {self.mesh.device}, the trainer on {self.device}")
        self.model_cfg = model_cfg
        self.tc = tc = tc if tc is not None else TrainerConfig()
        self.data = data
        self.guard = Guard(tc.guard) if tc.guard is not None else None
        self.faults = faults
        self.ckpt_failures = 0
        gen = gen if gen is not None else torch.Generator().manual_seed(tc.seed)
        self.model = Transformer(model_cfg, device=self.device, gen=gen)
        self.params, self.meta = self.model.params, self.model.meta
        okw = dict(optimizer_kw or {})
        okw.setdefault("backend", tc.backend)
        self.backend = okw["backend"]  # one backend for update + SNR pass
        guarded = self.guard is not None
        # In-pass kernel health exists on the Adam/slim family only; the
        # others run guarded through the step's grad-norm check.
        emit_health = guarded and optimizer_name in ("adam",) + _SLIM_FAMILY
        # Under a sharding context the Adam/slim family gets the mesh and
        # the parameter specs; only its fused backend shards the state.
        self.param_specs = param_specs(self.meta, self.params) if self.mesh is not None else None
        self.sharded = (self.mesh is not None and optimizer_name in ("adam",) + _SLIM_FAMILY
                        and resolve_backend(self.backend, self.device) == "fused")
        mesh_kw = dict(mesh=self.mesh, param_specs=self.param_specs) if self.sharded else {}
        self.tx = make_optimizer(optimizer_name, lr, self.params, self.meta, rules=rules, emit_health=emit_health,
                                 **okw, **mesh_kw)
        self.opt_state = self.tx.init(self.params)
        self.state_specs = self._state_specs(optimizer_name, lr, rules, okw) if self.sharded else None
        self.step = 0
        self.snr = SNRTracker()
        self.metrics_log: list = []
        self._train_step = make_train_step(self.model, self.tx, grad_accum=grad_accum, guard=guarded,
                                           mesh=self.mesh)
        # Measure-step variant: the same optimizer built with emit_snr=True,
        # so on SNR cadence steps the update pass measures SNR_K along each
        # compressed leaf's own K (state.snr) and maybe_measure_snr skips
        # the nu read for that candidate.
        self._train_step_snr = None
        self._update_dims = None
        if tc.measure_snr and tc.snr_from_update and optimizer_name in _SLIM_FAMILY:
            self._update_dims = slim_rule_dims(optimizer_name, self.params, self.meta, rules)
            tx_snr = make_optimizer(optimizer_name, lr, self.params, self.meta, rules=rules, emit_snr=True,
                                    emit_health=emit_health, **okw, **mesh_kw)
            self._train_step_snr = make_train_step(self.model, tx_snr, grad_accum=grad_accum, guard=guarded,
                                                   mesh=self.mesh)
        if tc.ckpt_dir and store.latest_step(tc.ckpt_dir) is not None:
            self.restore()

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The data stream's batch ``step`` on the trainer's device."""
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in self.data.batch(step).items()}

    def _state_specs(self, optimizer_name, lr, rules, okw):
        """PartitionSpecs of the sharded optimizer state, from the unsharded
        optimizer's state on meta tensors (global shapes, no memory)."""
        abstract = {k: torch.empty(p.shape, dtype=p.dtype, device="meta") for k, p in self.params.items()}
        tx = make_optimizer(optimizer_name, lr, abstract, self.meta, rules=rules, emit_health=self.guard is not None,
                            **okw)
        return opt_state_specs(tx.init(abstract), abstract, self.param_specs, owner_mesh=self.mesh)

    # -- fault tolerance ---------------------------------------------------

    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def _shardings(self):
        """How each leaf of the checkpointed state lies over the mesh (the
        parameters are whole on every rank)."""
        return {"opt": shardings_from_specs(self.state_specs, self.mesh)} if self.sharded else None

    def global_state(self):
        """The state as whole tensors: the optimizer shards gathered across
        the mesh (a collective: every rank calls it), as checkpoints hold
        it."""
        shardings = self._shardings()
        if shardings is None:
            return self._state()
        by_name = dict(store.named_leaves(shardings))
        return store.map_leaves(self._state(), lambda name, leaf: by_name[name].gather(leaf)
                                if name in by_name else leaf)

    def restore(self):
        """Load the newest valid checkpoint of ``tc.ckpt_dir``: parameters
        in place, the optimizer state (this rank's shards on a mesh), and
        the step."""
        state, extra = store.restore(self.tc.ckpt_dir, self._state(), shardings=self._shardings())
        self.model.load_params(state["params"])
        self.opt_state = state["opt"]
        self.step = int(extra.get("step", 0))

    def checkpoint(self):
        """Save the whole state (gathered on a mesh, written by rank 0 while
        the others wait for it)."""
        if not self.tc.ckpt_dir:
            return
        state = self.global_state()
        try:
            if self.mesh is None or self.mesh.rank == 0:
                store.save(self.tc.ckpt_dir, self.step, state, extra={"step": self.step}, keep=self.tc.ckpt_keep)
        except OSError as e:
            # A failed save must not kill the run: the atomic tmp-dir
            # protocol left no torn step_* dir behind, so count it and train
            # on to the next checkpoint cadence.
            self.ckpt_failures += 1
            warnings.warn(f"checkpoint save failed at step {self.step} ({e}); continuing without it")
        if self.mesh is not None:
            self.mesh.barrier()

    def _rollback(self):
        """Guard escalation: restore the last valid checkpoint and re-seed
        the data pipeline so the restored trajectory doesn't replay the
        exact batch sequence that diverged."""
        self.guard.note_rollback()
        restored = False
        if self.tc.ckpt_dir and store.latest_step(self.tc.ckpt_dir) is not None:
            try:
                self.restore()
                restored = True
            except FileNotFoundError:
                pass
        if not restored:
            warnings.warn("guard requested rollback but no valid checkpoint is available; continuing with "
                          "backed-off lr")
        bump = self.guard.counters["rollbacks"] * self.tc.guard.reseed_bump
        self.data = ZipfLM(dataclasses.replace(self.data.cfg, seed=self.data.cfg.seed + bump))

    # -- SNR hook ------------------------------------------------------------

    def maybe_measure_snr(self):
        if not self.tc.measure_snr or not SNRTracker.should_measure(
                self.step, self.tc.snr_early_every, self.tc.snr_late_every):
            return
        nu = find_adam_nu(self.opt_state)
        if nu is None:
            return
        from_upd = find_slim_snr(self.opt_state) if self._train_step_snr is not None else None
        # on a mesh each rank measures its shards, laid out by the moments' storage specs
        shard_kw = dict(mesh=self.mesh, param_specs=find_adam_nu(self.state_specs)) if self.sharded else {}
        self.snr.update(measure_tree_snr(nu, self.meta, backend=self.backend, from_update=from_upd,
                                         update_dims=self._update_dims if from_upd is not None else None,
                                         **shard_kw),
                        self.step)
        if from_upd is not None:
            # Strip the consumed snapshot so checkpoints keep the snr-less layout.
            self.opt_state = strip_slim_snr(self.opt_state)

    # -- main loop -----------------------------------------------------------

    def run(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Train up to step ``steps`` (default ``tc.total_steps``). Metrics
        are read to the host only at ``log_every`` and at the last step (the
        guarded loop reads the loss every step, for its policy)."""
        steps = steps if steps is not None else self.tc.total_steps
        t0 = time.time()
        if self.step >= steps:
            # A restored checkpoint can already be at/past the target step:
            # run a forward-only eval so the no-op still yields the full
            # metrics dict (grad_norm 0: no update happened).
            last = {k: float(v) for k, v in make_eval_step(self.model)(self.batch(self.step)).items()}
            last.update(grad_norm=0.0, step=self.step, wall_s=round(time.time() - t0, 2))
            self.metrics_log.append(last)
            return last
        last: Dict[str, float] = {}
        while self.step < steps:
            batch = self.batch(self.step)
            # On SNR-cadence steps, run the emit_snr step variant so the
            # measurement rides the update pass.
            step_fn = self._train_step
            if self._train_step_snr is not None and SNRTracker.should_measure(
                    self.step + 1, self.tc.snr_early_every, self.tc.snr_late_every):
                step_fn = self._train_step_snr
            if self.guard is not None:
                g_scale = self.faults.grad_scale(self.step) if self.faults is not None else 1.0
                self.opt_state, metrics = step_fn(self.opt_state, batch, self.guard.controls(g_scale))
                self.step += 1
                loss = float(metrics["loss"])
                if self.faults is not None:
                    loss = self.faults.corrupt_loss(self.step - 1, loss)
                skipped = bool(metrics["step_skipped"] > 0)
                action = self.guard.observe(loss, skipped=skipped, nonfinite=float(metrics["nonfinite_count"]))
                if not skipped:
                    self.maybe_measure_snr()
                if action == ROLLBACK:
                    self._rollback()
                    continue
            else:
                self.opt_state, metrics = step_fn(self.opt_state, batch)
                self.step += 1
                self.maybe_measure_snr()
            if self.step % self.tc.log_every == 0 or self.step == steps:
                last = {k: float(v) for k, v in metrics.items()}
                last.update(step=self.step, wall_s=round(time.time() - t0, 2))
                if self.guard is not None:
                    last.update(self.guard.stats(), ckpt_failures=float(self.ckpt_failures))
                self.metrics_log.append(last)
            if self.tc.ckpt_every and self.step % self.tc.ckpt_every == 0:
                self.checkpoint()
        return last

    def derive_slim_rules(self, cutoff: float = 1.0):
        """Paper §5: turn the tracked SNR averages into SlimAdam rules."""
        return derive_rules(self.snr.averaged(), self.meta, cutoff=cutoff)
