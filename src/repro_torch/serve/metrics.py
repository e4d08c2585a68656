"""Serving metrics, admission results, and diagnosable failures (port of
``repro/serve/metrics.py``).

Every fault-handling decision the engine makes (NaN retirement, deadline
expiry, admission rejection, livelock backoff, budget truncation) lands in a
counter here instead of a hot-loop ``warnings.warn``;
:meth:`repro_torch.serve.engine.Engine.metrics` snapshots them into a frozen
:class:`ServeMetrics`.

* :class:`ServeCounters`: the engine's mutable tallies, with
  :meth:`ServeCounters.warn_once` for first-occurrence-only warnings.
* :class:`ServeMetrics`: immutable snapshot of counters, scheduler and pool
  gauges, and TTFT/TPOT means.
* :class:`Rejected`: ``Engine.submit``'s admission-control verdict.
* :class:`LivelockError`: raised only after the deterministic backoff fails,
  carrying the whole scheduler and pool snapshot in its message.

The JAX package's degradation and fault-injection counters
(``degraded_steps``, ``injected_stalls``, ``injected_poison``) have no
counterpart: the port neither degrades a failing kernel launch to the plain
path nor injects faults.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Set, Tuple


class ServeCounters:
    """Mutable fault and latency tallies owned by one Engine."""

    __slots__ = ("nan_retired", "deadline_expired", "budget_truncated", "truncated_max_new", "rejected_queue",
                 "rejected_pool", "livelock_backoffs", "ttft_sum_s", "ttft_n", "tpot_sum_s", "tpot_n", "_warned")

    def __init__(self) -> None:
        self.nan_retired = 0          # slots retired on a non-finite logit tap
        self.deadline_expired = 0     # requests retired or dropped past deadline
        self.budget_truncated = 0     # wall-clock budget truncations
        self.truncated_max_new = 0    # submit-time max_new_tokens clamps
        self.rejected_queue = 0       # admissions rejected: queue watermark
        self.rejected_pool = 0        # admissions rejected: pool projection
        self.livelock_backoffs = 0    # no-progress backoff rounds
        self.ttft_sum_s = 0.0         # time-to-first-token aggregate
        self.ttft_n = 0
        self.tpot_sum_s = 0.0         # time-per-output-token aggregate
        self.tpot_n = 0
        self._warned: Set[str] = set()

    def warn_once(self, code: str, message: str) -> None:
        """Warn on the first occurrence of ``code`` only; recurrence is what
        the counters are for."""
        if code not in self._warned:
            self._warned.add(code)
            warnings.warn(message, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class ServeMetrics:
    """One consistent snapshot of the engine's serving health. Gauges read
    the instant of the snapshot; counters are monotone since construction."""

    # gauges
    queue_depth: int
    active_slots: int
    free_pages: int
    used_pages: int
    page_high_water: int
    pool_capacity: int
    # scheduler counters
    admitted: int
    retired: int
    preempted: int
    sched_steps: int
    decode_steps: int
    prefill_chunks: int
    tokens_out: int
    # fault / SLO counters (mirrors ServeCounters)
    nan_retired: int
    deadline_expired: int
    budget_truncated: int
    truncated_max_new: int
    rejected_queue: int
    rejected_pool: int
    livelock_backoffs: int
    # latency aggregates (None until a request has retired with the stat)
    ttft_mean_s: Optional[float]
    tpot_mean_s: Optional[float]

    @property
    def preemption_rate(self) -> float:
        """Preemptions per admission."""
        return self.preempted / max(self.admitted, 1)

    @property
    def rejected(self) -> int:
        return self.rejected_queue + self.rejected_pool

    def to_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["preemption_rate"] = round(self.preemption_rate, 4)
        d["rejected"] = self.rejected
        return d


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Admission-control verdict from ``Engine.submit``: the request was not
    enqueued. ``reason`` is ``'queue_full'`` (queue depth at
    ``ServeConfig.max_queue``) or ``'pool_pressure'`` (projected page demand
    of everything queued + active + this request past the
    ``admit_watermark`` fraction of pool capacity)."""

    reason: str
    queue_depth: int
    projected_pages: int
    pool_capacity: int


class LivelockError(RuntimeError):
    """The scheduler made no progress for a full patience window despite
    backoff. Carries the queue, per-slot rids, pool state and the full
    :class:`ServeMetrics` snapshot, so the message alone diagnoses it."""

    def __init__(self, metrics: ServeMetrics, slot_rids: List[Optional[int]], queued_rids: Tuple[int, ...]) -> None:
        self.metrics = metrics
        self.slot_rids = list(slot_rids)
        self.queued_rids = tuple(queued_rids)
        counters = ", ".join(f"{k}={v}" for k, v in sorted(metrics.to_dict().items()))
        super().__init__(
            f"scheduler made no progress for {metrics.livelock_backoffs} backoff rounds — "
            f"queue={list(queued_rids)} (depth {metrics.queue_depth}), slot_rids={self.slot_rids}, "
            f"free_pages={metrics.free_pages}/{metrics.pool_capacity}, counters: {counters}")
