"""Continuous-batching scheduler over fixed-shape decode slots (port of
``repro/serve/scheduler.py``).

The device side of the fast path has fixed shapes: a (max_slots, 1) token
batch, a (max_slots, max_pages) page table, per-slot lengths and active
flags (:class:`repro_torch.models.transformer.PagedState`). This module runs
the host loop that keeps those shapes busy:

  * **admit**: a queued request joins the batch once a slot AND enough pages
    for its (recompute-extended) prompt are free; admission is priority
    ordered (higher ``priority`` first, FIFO within a level) and never skips
    the queue head;
  * **grow**: each decode step lazily allocates one page for a slot whose
    next write position crosses a page boundary;
  * **preempt**: when the pool is exhausted mid-decode, the youngest active
    request is evicted: its pages are released, its table row zeroed, and it
    re-enters the queue for recompute (its generated tokens ride along as
    prompt extension, so no sampled token is lost);
  * **retire**: on eos / length / budget / deadline the request's pages
    return to the freelist at once, so later admits reuse them while the
    batch keeps running.

The scheduler never touches device memory; it edits the numpy page table
the engine ships to the step. Invariants (checked by the tests): a page has
exactly one owner, a slot holds at most one request, used_pages == 0 after
the drain.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from .kvpool import KVPool, PoolExhausted


class Scheduler:
    """Slot/page bookkeeping for continuous batching. ``rid`` handles are
    opaque ints owned by the engine."""

    def __init__(self, n_slots: int, max_pages: int, pool: KVPool):
        self.pool = pool
        self.n_slots = n_slots
        self.max_pages = max_pages
        self.table = np.zeros((n_slots, max_pages), np.int32)
        self.slot_rid: List[Optional[int]] = [None] * n_slots
        self._pages: Dict[int, List[int]] = {}      # rid -> owned pages
        self._admit_seq: Dict[int, int] = {}        # rid -> admission tick
        self._tick = 0
        self.queue: Deque[int] = deque()
        self._priority: Dict[int, int] = {}         # rid -> request priority
        self._submit_seq: Dict[int, int] = {}       # rid -> submission tick
        self._submit_tick = 0
        self.admitted = 0
        self.retired = 0
        self.preempted = 0

    def submit(self, rid: int, priority: int = 0) -> None:
        """Enqueue ``rid``. Higher ``priority`` sorts ahead; within a level
        the queue is FIFO by submission order (a preempted request keeps its
        original submission tick, so it requeues ahead of every same-priority
        request that arrived after it)."""
        self._priority[rid] = priority
        self._submit_seq[rid] = self._submit_tick
        self._submit_tick += 1
        self._enqueue(rid)

    def _qkey(self, rid: int) -> Tuple[int, int]:
        return (-self._priority[rid], self._submit_seq[rid])

    def _enqueue(self, rid: int) -> None:
        key = self._qkey(rid)
        idx = len(self.queue)
        for i, other in enumerate(self.queue):
            if self._qkey(other) > key:
                idx = i
                break
        self.queue.insert(idx, rid)

    def drop_queued(self, rid: int) -> None:
        """Remove a queued (never admitted, or preempted) request outright;
        it holds no pages by construction."""
        self.queue.remove(rid)
        self._priority.pop(rid, None)
        self._submit_seq.pop(rid, None)

    def active_slots(self) -> List[Tuple[int, int]]:
        """[(slot, rid)] currently in the batch."""
        return [(i, r) for i, r in enumerate(self.slot_rid) if r is not None]

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_rid):
            if r is None:
                return i
        return None

    def _rid_in(self, slot: int) -> int:
        rid = self.slot_rid[slot]
        if rid is None:
            raise RuntimeError(f"slot {slot} holds no request")
        return rid

    def try_admit(self, rid: int, n_prompt_tokens: int) -> Optional[int]:
        """Admit the queue head into a free slot if the pool can hold its
        prompt plus one decode page of headroom (which avoids admitting and
        at once preempting into a perfectly full pool). Returns the slot, or
        None if it cannot join yet."""
        if not self.queue or self.queue[0] != rid:
            head = self.queue[0] if self.queue else None
            raise RuntimeError(f"admission never skips the queue head (head {head}, rid {rid})")
        slot = self._free_slot()
        if slot is None:
            return None
        need = self.pool.pages_for(n_prompt_tokens)
        if self.pool.free_pages < min(need + 1, self.pool.capacity):
            return None
        self.queue.popleft()
        pages = self.pool.alloc(need, rid)
        self._pages[rid] = pages
        self.table[slot, :] = 0
        self.table[slot, :len(pages)] = pages
        self.slot_rid[slot] = rid
        self._admit_seq[rid] = self._tick
        self._tick += 1
        self.admitted += 1
        return slot

    def ensure_capacity(self, slot: int, position: int) -> bool:
        """Make sure the page holding ``position`` (the next write index) is
        mapped in this slot's table row, allocating one page at the boundary.
        Returns False when the pool is exhausted (the caller decides whom to
        preempt)."""
        rid = self._rid_in(slot)
        pidx = position // self.pool.page_size
        if pidx >= self.max_pages:
            raise RuntimeError(f"request {rid} position {position} exceeds the {self.max_pages}-page table row")
        if self.table[slot, pidx] != 0:
            return True
        try:
            (page,) = self.pool.alloc(1, rid)
        except PoolExhausted:
            return False
        self._pages[rid].append(page)
        self.table[slot, pidx] = page
        return True

    def youngest_other(self, slot: int, protected: Tuple[int, ...] = ()) -> Optional[int]:
        """Latest-admitted active slot other than ``slot`` and the protected
        set: the preemption victim (evicting the youngest wastes the least
        completed work)."""
        best, best_seq = None, -1
        for i, rid in self.active_slots():
            if i == slot or i in protected:
                continue
            if self._admit_seq[rid] > best_seq:
                best, best_seq = i, self._admit_seq[rid]
        return best

    def preempt(self, slot: int) -> int:
        """Evict the request in ``slot``: release every page, zero the table
        row, requeue by its original submission tick. Returns the rid so the
        engine can reset its decode state."""
        rid = self._rid_in(slot)
        self._release(slot, rid)
        self._enqueue(rid)
        self.preempted += 1
        return rid

    def retire(self, slot: int) -> int:
        """Remove a finished request and return its pages to the freelist
        at once (admissible in this same step)."""
        rid = self._rid_in(slot)
        self._release(slot, rid)
        self._priority.pop(rid, None)
        self._submit_seq.pop(rid, None)
        self.retired += 1
        return rid

    def _release(self, slot: int, rid: int) -> None:
        self.pool.release(self._pages.pop(rid), rid)
        self._admit_seq.pop(rid, None)
        self.table[slot, :] = 0
        self.slot_rid[slot] = None

    def metrics(self) -> Dict[str, float]:
        return {
            "active": float(len(self.active_slots())),
            "queued": float(len(self.queue)),
            "page_utilization": self.pool.utilization(),
            "free_pages": float(self.pool.free_pages),
            "admitted": float(self.admitted),
            "retired": float(self.retired),
            "preempted": float(self.preempted),
            "page_high_water": float(self.pool.high_water),
        }
