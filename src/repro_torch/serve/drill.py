"""The serving chaos drill: an injected run must drain correctly (port of
``benchmarks/serve_drill.py``'s run and gates, as functions).

One continuous-batching run on a tight page pool is hit with every
injection :class:`~repro_torch.serve.faults.ServeFaultPlan` offers (kernel
failures on chosen decode steps and prefill chunks, poisoned logits for one
request, a freelist squeeze forcing preemption, a clock stall blowing one
request's deadline) and is held to the drill's gates:

  (a) it drains: no ``PoolExhausted`` or ``LivelockError`` escapes, every
      accepted request completes;
  (b) greedy parity with a clean run for every request neither poisoned nor
      past its deadline, prefix parity for the poisoned one;
  (c) no leak: ``used_pages == 0`` and ``alloc_count == free_count`` after
      the drain, squeeze pages included;
  (d) every injection shows in ``Engine.metrics()`` (``degraded_steps``
      once per planned kernel failure, ``nan_retired``/``injected_poison``,
      ``deadline_expired``, ``injected_stalls``, ``preempted``) within
      ``MAX_SCHED_STEPS`` scheduler steps.

:func:`admission_check` floods a backpressured engine past ``max_queue`` /
``admit_watermark``: the verdicts must be :class:`Rejected`, counted, never an
exception, and the accepted requests drain cleanly. The drill's prompts and
weights are the caller's (``python3 chip_smoke.py`` phase 15 on the card,
``tests/test_torch_serve_faults.py`` on the CPU).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..kernels import paged_attention as pa
from .engine import Engine, Request, ServeConfig
from .faults import ServeFaultPlan
from .metrics import Rejected, ServeMetrics

# benchmarks/serve_drill.py's geometry and plan: 6 requests of 8 tokens, 3
# slots over 12 pages of 4 positions. The poisoned request is submission
# index 2 (ids count up from 0 in each engine); the last request's 5 s
# deadline falls to a 10 s stall at scheduler step 1, before it can leave the
# queue of the 3-slot engine.
DRILL_SC = dict(max_seq=48, max_new_tokens=8, max_slots=3, page_size=4, pool_pages=13, prefill_chunk=4)
DRILL_PLAN = ServeFaultPlan(kernel_fail_steps=(2, 5), prefill_fail_chunks=(1,), poison_rids=(2,), poison_after=2,
                            squeeze_window=(1, 5), squeeze_pages=4, stall_steps=(1,), stall_s=10.0)
DRILL_DEADLINE_S = 5.0
MAX_SCHED_STEPS = 200


@dataclasses.dataclass
class DrillResult:
    """One injected run held to the gates. ``failures``: gates (a), (c) and
    (d); ``deviations``: gate (b). ``kernel_launches``: the paged-attention
    kernel's launches during the injected run."""
    failures: List[str]
    deviations: List[str]
    metrics: ServeMetrics
    tokens: List[List[int]]
    reasons: List[str]
    clean_tokens: List[List[int]]
    kernel_launches: int

    @property
    def ok(self) -> bool:
        return not self.failures and not self.deviations


def run_drill(cfg, params, requests: Sequence[Request], *, sc: Optional[ServeConfig] = None,
              plan: ServeFaultPlan = DRILL_PLAN, deadline_s: float = DRILL_DEADLINE_S, device=None,
              clean_tokens: Optional[List[List[int]]] = None,
              on_engine: Optional[Callable[[Engine], None]] = None) -> DrillResult:
    """Serve ``requests`` clean (unless ``clean_tokens`` gives that run's
    tokens, in submission order), then again on a fresh engine under
    ``plan`` with the last request given ``deadline_s``, and hold the
    injected run to the gates. ``on_engine(engine)`` is called on the
    injected engine before its run (an observer's hook)."""
    sc = sc if sc is not None else ServeConfig(**DRILL_SC)
    deadline_idx = len(requests) - 1
    if clean_tokens is None:
        clean = Engine(cfg, params, sc, device=device)
        rids = [clean.submit(r) for r in requests]
        done = clean.run_until_drained()
        clean_tokens = [done[r].tokens.tolist() for r in rids]

    eng = Engine(cfg, params, sc, device=device)
    if on_engine is not None:
        on_engine(eng)
    failures: List[str] = []
    deviations: List[str] = []
    rids: List[int] = []
    done = {}
    before = pa.paged_attention.launches
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with plan.install(eng):
            try:
                for i, r in enumerate(requests):
                    rid = eng.submit(dataclasses.replace(r, deadline_s=deadline_s if i == deadline_idx else None))
                    if isinstance(rid, Rejected):
                        raise RuntimeError(f"request {i} rejected ({rid.reason}): the drill's pool must admit all")
                    rids.append(rid)
                done = eng.run_until_drained()
            except Exception as e:  # noqa: BLE001 — the gate is "drains"
                failures.append(f"(a) the injected run did not drain: {type(e).__name__}: {e}")
    launches = pa.paged_attention.launches - before
    m = eng.metrics()

    # (a) every accepted request completed
    missing = sorted(set(rids) - set(done))
    if missing:
        failures.append(f"(a) requests never completed: {missing}")
    # (b) parity with the clean run
    for i, rid in enumerate(rids):
        if rid not in done:
            continue
        got, want, why = done[rid].tokens.tolist(), clean_tokens[i], done[rid].finish_reason
        if i == deadline_idx:
            if why != "deadline":
                deviations.append(f"(b) the deadline request finished with '{why}', expected 'deadline'")
        elif rid in plan.poison_rids:
            if why != "nan":
                deviations.append(f"(b) poisoned request {i} finished with '{why}', expected 'nan'")
            if got != want[:len(got)]:
                deviations.append(f"(b) poisoned request {i}'s tokens before the poison deviate from the clean run")
        elif got != want:
            deviations.append(f"(b) request {i}'s tokens deviate from the clean run under injection ('{why}')")
    # (c) no leak, squeeze pages included
    if eng.pool.used_pages != 0:
        failures.append(f"(c) page leak: {eng.pool.used_pages} pages still allocated after the drain")
    if eng.pool.alloc_count != eng.pool.free_count:
        failures.append(f"(c) alloc/free imbalance: {eng.pool.alloc_count} allocated, {eng.pool.free_count} freed")
    # (d) every injection visible in the metrics
    n_fail = len(plan.kernel_fail_steps) + len(plan.prefill_fail_chunks)
    if m.degraded_steps != n_fail:
        failures.append(f"(d) kernel injections: degraded_steps={m.degraded_steps}, planned {n_fail}")
    if m.nan_retired != len(plan.poison_rids) or m.injected_poison != len(plan.poison_rids):
        failures.append(f"(d) poison injection: nan_retired={m.nan_retired}, injected_poison={m.injected_poison}")
    if m.deadline_expired != 1:
        failures.append(f"(d) stall against the deadline: deadline_expired={m.deadline_expired}")
    if m.injected_stalls != len(plan.stall_steps):
        failures.append(f"(d) clock stalls: injected_stalls={m.injected_stalls}, planned {len(plan.stall_steps)}")
    if m.preempted < 1:
        failures.append("(d) the pool squeeze provoked no preemption")
    if m.sched_steps > MAX_SCHED_STEPS:
        failures.append(f"(d) the drain took {m.sched_steps} scheduler steps (> {MAX_SCHED_STEPS})")
    return DrillResult(failures, deviations, m, [done[r].tokens.tolist() if r in done else None for r in rids],
                       [done[r].finish_reason if r in done else None for r in rids], clean_tokens, launches)


def admission_check(cfg, params, prompts: np.ndarray, *, device=None) -> List[str]:
    """The drill's admission-control check on ``prompts`` (more than the
    queue holds) at the drill's geometry: failures, empty when the contract
    holds."""
    bp = Engine(cfg, params, ServeConfig(**DRILL_SC, max_queue=2, admit_watermark=1.0), device=device)
    verdicts = [bp.submit(Request(prompt=p)) for p in prompts]
    rejected = [v for v in verdicts if isinstance(v, Rejected)]
    accepted = [v for v in verdicts if not isinstance(v, Rejected)]
    failures = []
    if not rejected:
        failures.append("flooding past max_queue / admit_watermark rejected nothing")
    if bp.metrics().rejected != len(rejected):
        failures.append("Rejected verdicts and rejection counters disagree")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        done = bp.run_until_drained()
    if set(done) != set(accepted) or bp.pool.used_pages != 0:
        failures.append("the backpressured engine failed to drain the accepted requests cleanly")
    return failures
