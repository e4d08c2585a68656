"""Trainer: optimizer registry and the SNR measurement cadence (port of
``repro/train/trainer.py``, single device).

The paper's loop: train Adam while measuring layer-wise SNR of its second
moments, derive SlimAdam rules from the averages (``derive_slim_rules``),
then train SlimAdam with those rules ('slim_snr') or with the paper's
Table-3 rules ('slim').

Not ported yet: checkpoints, the guard and fault injection, from-update SNR,
gradient accumulation, and the baseline optimizers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..core import SNRTracker, derive_rules, measure_tree_snr, rules_as_tree, table3_rules
from ..core.slim_adam import ScaleBySlimAdamState, slim_adam
from ..data.pipeline import ZipfLM
from ..models.transformer import Transformer
from ..optim.adam import ScaleByAdamState, adamw
from ..optim.base import ChainState
from .step import make_train_step

OPTIMIZERS = ("adam", "slim", "slim_snr")


def slim_rule_dims(name: str, params, meta, rules: Optional[Dict[str, Any]] = None):
    """Per-leaf reduction dims the slim-family optimizer ``name`` uses."""
    if name == "slim":
        return rules_as_tree(table3_rules(meta), params, meta)
    if name == "slim_snr":
        if rules is None:
            raise ValueError("slim_snr requires derived rules")
        return rules_as_tree(rules, params, meta)
    raise ValueError(f"{name!r} is not a slim-family optimizer")


def make_optimizer(name: str, lr: float, params, meta, *, weight_decay: float = 0.1, b1: float = 0.9,
                   b2: float = 0.95, grad_clip: float = 1.0, rules: Optional[Dict[str, Any]] = None,
                   backend: str = "jnp"):
    """Build one of the ported optimizers. ``rules`` are the derived rules
    'slim_snr' needs; ``backend`` is 'jnp' | 'fused' | 'auto'."""
    if name == "adam":
        return adamw(lr, b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip, backend=backend)
    if name in ("slim", "slim_snr"):
        return slim_adam(lr, slim_rule_dims(name, params, meta, rules), b1=b1, b2=b2,
                         weight_decay=weight_decay, grad_clip=grad_clip, backend=backend)
    raise ValueError(f"unknown optimizer {name!r}; choose from {OPTIMIZERS}")


def find_adam_nu(opt_state) -> Optional[Dict[str, torch.Tensor]]:
    """The second-moment dict inside a (chained) optimizer state — what the
    paper's SNR analysis reads."""
    if isinstance(opt_state, (ScaleByAdamState, ScaleBySlimAdamState)):
        return opt_state.nu
    if isinstance(opt_state, ChainState):
        for s in opt_state.inner_states:
            nu = find_adam_nu(s)
            if nu is not None:
                return nu
    return None


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    log_every: int = 50
    measure_snr: bool = False
    snr_early_every: int = 100
    snr_late_every: int = 1000
    seed: int = 0
    # Backend for the Adam/SlimAdam update and the SNR pass: 'jnp' | 'fused' | 'auto'.
    backend: str = "jnp"


class Trainer:
    """Train ``model_cfg`` with ``optimizer_name`` on ``data``. Runs on CUDA
    unless ``device`` names another device; raises when no GPU is present
    and none is named."""

    def __init__(self, model_cfg, optimizer_name: str, lr: float, data: ZipfLM,
                 tc: Optional[TrainerConfig] = None, *, optimizer_kw: Optional[dict] = None,
                 rules: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.tc = tc = tc if tc is not None else TrainerConfig()
        self.data = data
        self.model = Transformer(model_cfg, device=self.device, gen=torch.Generator().manual_seed(tc.seed))
        self.params, self.meta = self.model.params, self.model.meta
        okw = dict(optimizer_kw or {})
        okw.setdefault("backend", tc.backend)
        self.backend = okw["backend"]  # one backend for update + SNR pass
        self.tx = make_optimizer(optimizer_name, lr, self.params, self.meta, rules=rules, **okw)
        self.opt_state = self.tx.init(self.params)
        self.step = 0
        self.snr = SNRTracker()
        self.metrics_log: list = []
        self._train_step = make_train_step(self.model, self.tx)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The data stream's batch ``step`` on the trainer's device."""
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in self.data.batch(step).items()}

    def maybe_measure_snr(self):
        if not self.tc.measure_snr or not SNRTracker.should_measure(
                self.step, self.tc.snr_early_every, self.tc.snr_late_every):
            return
        nu = find_adam_nu(self.opt_state)
        if nu is not None:
            self.snr.update(measure_tree_snr(nu, self.meta, backend=self.backend), self.step)

    def run(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Train up to step ``steps`` (default ``tc.total_steps``). Metrics
        are read to the host only at ``log_every`` and at the last step."""
        steps = steps if steps is not None else self.tc.total_steps
        t0 = time.time()
        last: Dict[str, float] = {}
        while self.step < steps:
            self.opt_state, metrics = self._train_step(self.opt_state, self.batch(self.step))
            self.step += 1
            self.maybe_measure_snr()
            if self.step % self.tc.log_every == 0 or self.step == steps:
                last = {k: float(v) for k, v in metrics.items()}
                last.update(step=self.step, wall_s=round(time.time() - t0, 2))
                self.metrics_log.append(last)
        return last

    def derive_slim_rules(self, cutoff: float = 1.0):
        """Paper §5: turn the tracked SNR averages into SlimAdam rules."""
        return derive_rules(self.snr.averaged(), self.meta, cutoff=cutoff)
