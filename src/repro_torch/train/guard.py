"""Guarded training policy: skip / backoff / rollback on anomalous steps
(port of ``repro/train/guard.py``; the policy is the same plain Python).

The division of labor with the rest of the stack:

* the **kernels** accumulate per-leaf ``[nonfinite_count, finite_sumsq]``
  inside the update's own pass over device memory (``repro_torch.kernels``
  with_health outputs, surfaced as
  :class:`repro_torch.optim.fused.StepHealth` on the optimizer state when
  built with ``emit_health=True``);
* the **guarded step** (``make_train_step(..., guard=True)``) reads that
  health and, when the step is poisoned, neither applies the updates nor
  takes the new optimizer state — a non-finite gradient can never advance
  parameters, moments or count;
* this module holds the **host-side policy**: a rolling loss window with a
  z-score spike detector, multiplicative lr backoff/recovery, and a
  consecutive-bad-step counter that escalates to a rollback to the last
  good checkpoint (``Trainer.run`` executes the rollback + data re-seed).

Everything here is plain Python on host scalars — the step reads one
flag and the loss to the host, so the policy adds no device work.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Deque, Dict, Optional

# Step outcomes observe() can report. 'skip' = the guarded step already
# discarded the update (non-finite health); 'backoff' = finite but spiking
# loss, lr scaled down; 'rollback' = enough consecutive bad steps that the
# trainer should restore the last good checkpoint.
OK, SKIP, BACKOFF, ROLLBACK = "ok", "skip", "backoff", "rollback"


@dataclasses.dataclass
class GuardConfig:
    """Policy knobs for :class:`Guard`.

    The defaults are deliberately loose: a z-score of 6 over a 32-step
    window fires on genuine divergence (or an injected spike) but not on
    ordinary early-training loss noise."""
    window: int = 32           # rolling loss window length
    min_history: int = 8       # no spike verdicts until this many good steps
    spike_z: float = 6.0       # z-score above which a loss counts as a spike
    spike_min_std: float = 1e-6  # std floor so a flat window can't divide by ~0
    lr_backoff: float = 0.5    # lr_scale *= this on a spike
    lr_recover: float = 1.25   # lr_scale *= this on a good step (capped at 1)
    min_lr_scale: float = 0.05
    max_bad_steps: int = 3     # consecutive bad steps before rollback
    max_rollbacks: int = 3     # stop escalating after this many restores
    reseed_bump: int = 1009    # data seed += rollbacks * this after a restore


class Guard:
    """Host-side anomaly policy over per-step (loss, health) observations.

    Feed it one :meth:`observe` per optimizer step; it returns the action
    the trainer should take. Counters are cheap plain ints — merge
    :meth:`stats` into the metrics dict when logging.
    """

    def __init__(self, cfg: Optional[GuardConfig] = None):
        self.cfg = cfg or GuardConfig()
        self._window: Deque[float] = deque(maxlen=self.cfg.window)
        self.lr_scale: float = 1.0
        self.consecutive_bad: int = 0
        self.counters: Dict[str, int] = {
            "skipped": 0, "spikes": 0, "backoffs": 0, "rollbacks": 0,
            "nonfinite_total": 0,
        }

    # -- policy ------------------------------------------------------------

    def _is_spike(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        if len(self._window) < self.cfg.min_history:
            return False
        mean = sum(self._window) / len(self._window)
        var = sum((x - mean) ** 2 for x in self._window) / len(self._window)
        std = max(math.sqrt(var), self.cfg.spike_min_std)
        return (loss - mean) / std > self.cfg.spike_z

    def _escalate(self) -> str:
        self.consecutive_bad += 1
        if (self.consecutive_bad >= self.cfg.max_bad_steps
                and self.counters["rollbacks"] < self.cfg.max_rollbacks):
            return ROLLBACK
        return ""

    def observe(self, loss: float, *, skipped: bool = False,
                nonfinite: float = 0.0) -> str:
        """Record one step's outcome; return OK / SKIP / BACKOFF / ROLLBACK.

        ``skipped``: the guarded step discarded the update (non-finite
        health) — the loss is untrusted and is kept out of the window.
        A finite loss that z-scores past ``spike_z`` triggers a backoff
        (multiplicative lr_scale cut) and is also kept out of the window so
        one spike can't inflate the baseline. Good steps recover lr_scale
        multiplicatively back toward 1.
        """
        if skipped:
            self.counters["skipped"] += 1
            self.counters["nonfinite_total"] += int(nonfinite)
            return self._escalate() or SKIP
        if self._is_spike(loss):
            self.counters["spikes"] += 1
            self.counters["backoffs"] += 1
            self.lr_scale = max(self.lr_scale * self.cfg.lr_backoff,
                                self.cfg.min_lr_scale)
            return self._escalate() or BACKOFF
        self._window.append(float(loss))
        self.consecutive_bad = 0
        self.lr_scale = min(self.lr_scale * self.cfg.lr_recover, 1.0)
        return OK

    def controls(self, grad_scale: float = 1.0) -> Dict[str, float]:
        """The guarded step's controls from this guard's state: the same
        keys and Python floats whatever the state (tracecheck's aval-stable
        contract), as the JAX trainer hands its step f32 scalars."""
        return {"lr_scale": float(self.lr_scale), "grad_scale": float(grad_scale)}

    def note_rollback(self):
        """Trainer callback after a checkpoint restore: the loss window no
        longer describes the restored trajectory, so clear it (lr_scale is
        kept backed-off — the restored run re-earns it on good steps)."""
        self.counters["rollbacks"] += 1
        self.consecutive_bad = 0
        self._window.clear()

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {f"guard_{k}": float(v)
                                 for k, v in self.counters.items()}
        out["guard_lr_scale"] = float(self.lr_scale)
        return out


# -- optimizer-state walkers ----------------------------------------------
# Generic over chained states; live here (not trainer.py) so the train step
# can use them without importing the orchestration layer.


def _opt_types():
    from ..core.slim_adam import ScaleBySlimAdamState
    from ..optim.adam import ScaleByAdamState
    from ..optim.base import ChainState, MultiStepsState

    return ScaleByAdamState, ScaleBySlimAdamState, ChainState, MultiStepsState


def find_state_field(opt_state, types, field: str) -> Optional[Any]:
    """The first non-None ``field`` of a state of ``types`` in a (possibly
    chained or multi-step) optimizer state."""
    *_, chain_t, multi_t = _opt_types()
    if isinstance(opt_state, types):
        return getattr(opt_state, field)
    if isinstance(opt_state, chain_t):
        for s in opt_state.inner_states:
            out = find_state_field(s, types, field)
            if out is not None:
                return out
    if isinstance(opt_state, multi_t):
        return find_state_field(opt_state.inner_state, types, field)
    return None


def _rebuild(opt_state, fn):
    """``opt_state`` with ``fn`` applied to every Adam/SlimAdam state in it
    (through chains and multi-step wrappers), in tree order."""
    adam_t, slim_t, chain_t, multi_t = _opt_types()
    if isinstance(opt_state, (adam_t, slim_t)):
        return fn(opt_state)
    if isinstance(opt_state, chain_t):
        return chain_t(tuple(_rebuild(s, fn) for s in opt_state.inner_states))
    if isinstance(opt_state, multi_t):
        return opt_state._replace(inner_state=_rebuild(opt_state.inner_state, fn))
    return opt_state


def find_step_health(opt_state) -> Optional[Any]:
    """First non-None ``StepHealth`` published on a (possibly chained)
    optimizer state by an ``emit_health`` transformation, else None."""
    adam_t, slim_t, *_ = _opt_types()
    return find_state_field(opt_state, (adam_t, slim_t), "health")


def strip_step_health(opt_state):
    """``opt_state`` with any published StepHealth cleared, restoring the
    health-less layout checkpoints expect."""
    return _rebuild(opt_state, lambda s: s._replace(health=None) if s.health is not None else s)


def find_slim_snr(opt_state) -> Optional[Any]:
    """The from-update SNR dict a measure-step ``emit_snr`` update published
    on the (possibly chained) SlimAdam state, if any."""
    _, slim_t, *_ = _opt_types()
    return find_state_field(opt_state, slim_t, "snr")


def strip_slim_snr(opt_state):
    """``opt_state`` with any published from-update SNR snapshot cleared —
    the trainer strips it once consumed, so checkpoints keep the snr-less
    layout."""
    _, slim_t, *_ = _opt_types()
    return _rebuild(opt_state, lambda s: s._replace(snr=None) if isinstance(s, slim_t) and s.snr is not None else s)


def attach_slim_snr(opt_state, snr):
    """Re-attach a from-update SNR snapshot onto the first SlimAdam state in
    a chain (the guarded step strips snr and health from the state it
    keeps, then puts the measurement back for the trainer to consume)."""
    if snr is None:
        return opt_state
    _, slim_t, *_ = _opt_types()
    done = [False]

    def attach(s):
        if isinstance(s, slim_t) and not done[0]:
            done[0] = True
            return s._replace(snr=snr)
        return s

    return _rebuild(opt_state, attach)
