"""Deterministic fault injection for the serving engine (port of
``repro/serve/faults.py``).

Everything is seedless and counter-indexed, so an injected run is exactly
reproducible: a drill can demand greedy parity between an injected drain and
a clean one. The hooks ride the port's registry (:mod:`repro_torch.injection`);
the engine only fires the named points and never imports this module:

* ``"serve.kernel"``  fired (kind, index) before every paged decode step
                      (kind ``"decode"``, index the decode-step count) and
                      prefill chunk (``"prefill"``, the global chunk count).
                      An exception raised here degrades exactly that step or
                      chunk to the kernel's plain twin (``attn_impl="plain"``);
* ``"serve.logits"``  fired (rid, n_generated) before sampling; a truthy
                      return marks the slot's logits poisoned, so the engine
                      skips sampling and retires the request with
                      ``reason="nan"``, as a genuine non-finite logit does;
* ``"serve.clock"``   fired (sched_step) once a scheduler step; a float
                      return advances the engine's virtual clock, a slow step
                      against deadlines without sleeping;
* ``"serve.step"``    fired (engine, sched_step) at the top of every
                      scheduler step; the pool squeeze reserves and returns
                      freelist pages on schedule through it.

:meth:`ServeFaultPlan.install` installs one coherent set of hooks for all
four points and returns the squeeze's pages to the freelist on exit, so a
drill never leaks pages into its post-run checks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

from .. import injection

KERNEL_POINT = "serve.kernel"
LOGITS_POINT = "serve.logits"
CLOCK_POINT = "serve.clock"
STEP_POINT = "serve.step"


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """Step- and rid-indexed serving fault schedule (all indices 0-based).

    kernel_fail_steps:   decode-step indices whose paged-attention dispatch
                         raises (the engine serves exactly that step through
                         the plain twin);
    prefill_fail_chunks: global prefill-chunk indices that raise likewise;
    poison_rids:         requests whose logits turn non-finite once they have
                         generated ``poison_after`` tokens (the engine must
                         retire them with ``reason='nan'``);
    squeeze_window:      ``[lo, hi)`` scheduler-step window during which
                         ``squeeze_pages`` pages are held out of the KV
                         freelist: external pool pressure forcing preemption
                         or backoff;
    stall_steps:         scheduler steps at which the engine's virtual clock
                         jumps ``stall_s`` seconds.
    """

    kernel_fail_steps: Tuple[int, ...] = ()
    prefill_fail_chunks: Tuple[int, ...] = ()
    poison_rids: Tuple[int, ...] = ()
    poison_after: int = 1
    squeeze_window: Optional[Tuple[int, int]] = None
    squeeze_pages: int = 0
    stall_steps: Tuple[int, ...] = ()
    stall_s: float = 0.0

    @contextlib.contextmanager
    def install(self, engine):
        """Arm every configured injection against ``engine`` for the scope.
        They show afterwards in ``engine.metrics()``: ``degraded_steps``,
        ``nan_retired``/``injected_poison``, ``injected_stalls``, and the
        preemption and backoff counters the squeeze provokes."""
        held: List[int] = []

        def kernel_hook(kind: str, index: int) -> None:
            steps = self.kernel_fail_steps if kind == "decode" else self.prefill_fail_chunks
            if index in steps:
                raise RuntimeError(f"injected paged-attention failure ({kind} #{index})")

        def logits_hook(rid: int, n_generated: int) -> bool:
            return rid in self.poison_rids and n_generated >= self.poison_after

        def clock_hook(sched_step: int) -> float:
            return self.stall_s if sched_step in self.stall_steps else 0.0

        def step_hook(eng, sched_step: int) -> None:
            if self.squeeze_window is None or self.squeeze_pages <= 0:
                return
            lo, hi = self.squeeze_window
            if sched_step == lo and not held:
                held.extend(eng.pool.reserve(self.squeeze_pages))
            elif sched_step >= hi and held:
                eng.pool.unreserve(held)
                held.clear()

        with contextlib.ExitStack() as stack:
            stack.enter_context(injection.installed(KERNEL_POINT, kernel_hook))
            stack.enter_context(injection.installed(LOGITS_POINT, logits_hook))
            stack.enter_context(injection.installed(CLOCK_POINT, clock_hook))
            stack.enter_context(injection.installed(STEP_POINT, step_hook))
            try:
                yield self
            finally:
                if held:        # the run ended inside the squeeze window
                    engine.pool.unreserve(held)
                    held.clear()


@contextlib.contextmanager
def inject_paged_kernel_failure(fail_on: Tuple[int, ...] = (1,)):
    """Make the nth paged-attention dispatch(es) raise (1-based, decode steps
    and prefill chunks counted together), the serving counterpart of
    :func:`repro_torch.train.faults.inject_kernel_failure`. Yields the shared
    ``calls``/``failed`` counter dict."""
    hook, state = injection.call_counter(
        fail_on, lambda n: RuntimeError(f"injected paged-attention failure (dispatch #{n})"))
    with injection.installed(KERNEL_POINT, lambda _kind, _idx: hook()):
        yield state
