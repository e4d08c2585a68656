"""Request-level serving engine: the paged fast path and the legacy
token-by-token loop (port of ``repro/serve/engine.py``).

    eng = Engine(cfg, params, ServeConfig(max_seq=256))      # on the GPU
    rid = eng.submit(Request(prompt=tokens, max_new_tokens=64, eos_id=2))
    completions = eng.run_until_drained()                     # {rid: Completion}

``submit`` enqueues (or returns :class:`~repro_torch.serve.metrics.Rejected`
under admission control); ``step`` runs one scheduler iteration (expire
deadlines, admit queued requests into free slots and chunk-prefill them,
one batched paged decode over every active slot, retire finished ones);
``run_until_drained`` loops ``step`` until nothing is queued or active,
backing off deterministically on no progress before raising
:class:`~repro_torch.serve.metrics.LivelockError`.

Every prefill chunk and decode step runs attention through the hand-written
paged-attention kernel for CUDA tensors; a failing launch raises. The JAX
engine's degradation ladder (rerunning a failed step through the dense
reference) and its fault-injection hooks are not ported.

Architectures outside the paged path (SSM mixers, jamba's hybrid among
them, and the int8 KV cache, ``kv_quant``: qwen15_32b's ``optimized()``)
serve through :meth:`Engine.generate`'s legacy loop: a batch of equal-length prompts, fed token by token through
``transformer.decode_step`` over dense per-row caches (the prefill too, as
the JAX loop does), whose Mamba layers run the hand-written selective-scan
kernel. MoE FFN slots (olmoe_1b_7b, qwen3_moe_30b_a3b, jamba) run in both
paths. ``ServeConfig(paged=False)``
forces that loop on an attention model, the parity oracle of the paged
path. The request API (``submit``) needs the paged path; the encoders
(hubert_xlarge, vit_small: no embedding, no decode step) take neither.

Sampling: greedy is ``argmax``, as in JAX. With a temperature, token ``n``
of a request draws from a ``torch.Generator`` seeded from ``(seed, n)``, so
resampling the same index after a preemption recompute gives the same
token; the legacy loop draws every row's tokens from one generator seeded
with ``ServeConfig.seed``. Those streams are the port's own; they do not
reproduce JAX's bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..models import transformer
from .kvpool import KVPool
from .metrics import LivelockError, Rejected, ServeCounters, ServeMetrics
from .scheduler import Scheduler


@dataclasses.dataclass
class ServeConfig:
    """Engine-wide serving geometry. ``temperature``/``seed`` are the
    defaults for requests that do not set their own."""
    max_new_tokens: int = 32
    max_seq: int = 512
    temperature: float = 0.0
    seed: int = 0
    # Per-request wall-clock budget (seconds): an overrun degrades to a
    # truncated response (finish_reason='budget', counted). None = no cap.
    max_wall_s: Optional[float] = None
    # Paged fast path geometry
    page_size: int = 16        # token positions per KV page
    pool_pages: Optional[int] = None   # None -> max_slots * pages(max_seq) + 1
    max_slots: int = 8         # fixed decode batch width
    prefill_chunk: int = 8     # prompt tokens per chunked-prefill step
    # Admission control (None = accept everything): submit() returns
    # Rejected('queue_full') once this many requests are queued ...
    max_queue: Optional[int] = None
    # ... and Rejected('pool_pressure') when the projected page demand of
    # everything queued + active + the new request exceeds this fraction of
    # pool capacity.
    admit_watermark: Optional[float] = None
    # None -> auto (paged when the arch supports it); False forces the
    # legacy token-by-token loop (the parity oracle in tests)
    paged: Optional[bool] = None
    # Consecutive no-progress scheduler steps tolerated (with backoff)
    # before run_until_drained raises LivelockError.
    livelock_patience: int = 16
    # Admissions frozen for this many steps at the start of a no-progress burst.
    backoff_freeze_steps: int = 2


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature``/``seed`` default to the
    engine's ServeConfig when None; seeds are non-negative. ``deadline_s``
    is an SLO relative to submission: once exceeded the request retires with
    ``finish_reason='deadline'``; queued requests past deadline are dropped
    without touching the device. Higher ``priority`` admits first (FIFO
    within a level)."""
    prompt: object                       # (S,) int tokens (list / numpy / tensor)
    max_new_tokens: Optional[int] = None
    eos_id: Optional[int] = None
    temperature: Optional[float] = None
    seed: Optional[int] = None
    deadline_s: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass
class Completion:
    """Result of one request. ``tokens`` holds only the generated suffix
    (including the eos token when one was emitted). ``finish_reason``:
    'eos' | 'length' | 'budget' | 'deadline' | 'nan'."""
    id: int
    prompt: np.ndarray
    tokens: np.ndarray
    finish_reason: str
    ttft_s: Optional[float]              # submit -> first token
    wall_s: float                        # submit -> retirement
    preemptions: int = 0
    tpot_s: Optional[float] = None       # mean time per token after the first


class _ReqState:
    """Host-side decode state for one in-flight request."""

    __slots__ = ("rid", "request", "prompt", "max_new", "generated", "ctx_len", "t_submit", "t_first",
                 "preemptions", "deadline_s", "priority")

    def __init__(self, rid: int, request: Request, prompt: np.ndarray, max_new: int, t_submit: float):
        self.rid = rid
        self.request = request
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.ctx_len = 0          # KV positions written on the device
        self.t_submit = t_submit
        self.t_first: Optional[float] = None
        self.preemptions = 0
        self.deadline_s = request.deadline_s
        self.priority = request.priority

    def ctx_tokens(self) -> np.ndarray:
        """Tokens whose KV must exist before decoding can continue: the
        prompt plus everything generated so far (a preemption recompute
        prefills this whole extended prompt, losing no sampled token)."""
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])


def _prompt_array(prompt) -> np.ndarray:
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt, np.int32).reshape(-1)


class Engine:
    """The serving engine. ``params`` is the model's ``{dotted name:
    tensor}`` dict (e.g. ``Transformer(cfg, device=...).params``); it is
    moved to ``device``, which defaults to the GPU (see
    :func:`repro_torch.resolve_device`)."""

    def __init__(self, model_cfg, params, sc: Optional[ServeConfig] = None, *, device=None):
        self.sc = sc if sc is not None else ServeConfig()
        self._paged = self.sc.paged if self.sc.paged is not None else transformer.supports_paged(model_cfg)
        if self._paged and not transformer.supports_paged(model_cfg):
            raise ValueError(f"arch '{model_cfg.name}' is outside the paged serving path; use paged=False or None")
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.params = {k: v.detach().to(self.device) for k, v in params.items()}
        self._next_rid = 0
        self._reqs: Dict[int, _ReqState] = {}
        self._done: Dict[int, Completion] = {}
        self.counters = ServeCounters()
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_out = 0
        self.sched_steps = 0        # scheduler iterations, incl. no-progress
        self._completed_total = 0
        self._no_progress = 0       # consecutive no-progress steps
        self._admit_freeze = 0      # steps with admissions suspended
        p = self.sc.page_size
        max_pages = -(-self.sc.max_seq // p)
        n_pages = self.sc.pool_pages if self.sc.pool_pages is not None else self.sc.max_slots * max_pages + 1
        self.pool = KVPool(n_pages, p)
        self.scheduler = Scheduler(self.sc.max_slots, max_pages, self.pool)
        self._pools = None          # device pools, created on first use
        # The legacy loop's step, an attribute so a caller can wrap it.
        self._decode = lambda pr, c, t: transformer.decode_step(model_cfg, pr, c, t)

    def _now(self) -> float:
        return time.monotonic()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # Request API
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> Union[int, Rejected]:
        """Validate, admission-check and enqueue one request; returns its id
        or a :class:`Rejected` verdict. Raises ValueError only for requests
        that could never run: a prompt that cannot fit ``max_seq``, or a
        footprint exceeding the whole page pool even alone."""
        if not self._paged:
            raise NotImplementedError(f"the request API needs the paged fast path, which does not cover arch "
                                      f"'{self.cfg.name}' — use generate()")
        prompt = _prompt_array(request.prompt)
        n_prompt = prompt.shape[0]
        budget = self.sc.max_seq - n_prompt
        if budget <= 0:
            raise ValueError(f"prompt length {n_prompt} leaves no room to generate within max_seq={self.sc.max_seq}")
        max_new = request.max_new_tokens if request.max_new_tokens is not None else self.sc.max_new_tokens
        if max_new > budget:
            self.counters.truncated_max_new += 1
            self.counters.warn_once(
                "truncate_max_new",
                f"truncating max_new_tokens {max_new} -> {budget}: prompt length {n_prompt} + requested tokens "
                f"would overrun max_seq={self.sc.max_seq} (counted in ServeMetrics.truncated_max_new; "
                f"warning not repeated)")
            max_new = budget
        need = self.pool.pages_for(n_prompt + max_new)
        if need > self.pool.capacity:
            raise ValueError(f"request needs {need} KV pages but the pool holds only {self.pool.capacity} — raise "
                             f"pool_pages or shrink the request")
        sched = self.scheduler
        if self.sc.max_queue is not None and len(sched.queue) >= self.sc.max_queue:
            self.counters.rejected_queue += 1
            return Rejected(reason="queue_full", queue_depth=len(sched.queue), projected_pages=need,
                            pool_capacity=self.pool.capacity)
        if self.sc.admit_watermark is not None:
            projected = self.pool.used_pages + self._queued_pages() + need
            if projected > self.sc.admit_watermark * self.pool.capacity:
                self.counters.rejected_pool += 1
                return Rejected(reason="pool_pressure", queue_depth=len(sched.queue), projected_pages=projected,
                                pool_capacity=self.pool.capacity)
        rid = self._next_rid
        self._next_rid += 1
        self._reqs[rid] = _ReqState(rid, request, prompt, max_new, t_submit=self._now())
        sched.submit(rid, priority=request.priority)
        return rid

    def _queued_pages(self) -> int:
        """Projected lifetime page demand of everything still queued."""
        return sum(self.pool.pages_for(self._reqs[rid].prompt.shape[0] + self._reqs[rid].max_new)
                   for rid in self.scheduler.queue)

    def step(self) -> Dict[str, float]:
        """One scheduler iteration: expire deadlines, admit + prefill,
        grow/preempt, one batched decode, retire. Returns per-step metrics."""
        sched = self.scheduler
        self.sched_steps += 1
        self._expire_deadlines()

        prefills = 0
        if self._admit_freeze > 0:
            self._admit_freeze -= 1      # backoff: no admissions this step
        else:
            while sched.queue:
                rid = sched.queue[0]
                st = self._reqs[rid]
                slot = sched.try_admit(rid, len(st.ctx_tokens()))
                if slot is None:
                    break
                prefills += 1
                self._prefill_into(slot, st)

        # --- make room for every active row's next write position
        ensured: List[int] = []
        for slot, rid in list(sched.active_slots()):
            if sched.slot_rid[slot] != rid:
                continue               # evicted by an earlier row's preemption
            st = self._reqs[rid]
            while True:
                if sched.ensure_capacity(slot, st.ctx_len):
                    ensured.append(slot)
                    break
                victim = sched.youngest_other(slot, tuple(ensured))
                vrid = sched.preempt(victim if victim is not None else slot)
                self._reqs[vrid].preemptions += 1
                if victim is None:
                    break              # self-preempted; no decode for it this step

        # --- one fixed-shape decode over all active slots
        step_tokens = 0
        active = sched.active_slots()
        if active:
            n = self.sc.max_slots
            tokens = np.zeros((n, 1), np.int32)
            lengths = np.zeros((n,), np.int32)
            mask = np.zeros((n,), bool)
            for slot, rid in active:
                st = self._reqs[rid]
                tokens[slot, 0] = st.generated[-1]
                lengths[slot] = st.ctx_len
                mask[slot] = True
            state = transformer.PagedState(pools=self._device_pools(), table=self._tensor(sched.table),
                                           lengths=self._tensor(lengths), active=self._tensor(mask))
            logits, ok_dev, _ = transformer.paged_decode_step(self.cfg, self.params, state, self._tensor(tokens))
            self.decode_steps += 1
            last = logits[:, -1].float().cpu().numpy()
            ok = ok_dev.cpu().numpy()
            now = self._now()
            for slot, rid in active:
                st = self._reqs[rid]
                st.ctx_len += 1        # this step wrote generated[-1]'s KV
                if not ok[slot]:
                    self._retire_nan(slot, st)
                    continue
                tok = self._sample_one(st, last[slot])
                st.generated.append(tok)
                step_tokens += 1
                eos = st.request.eos_id
                if eos is not None and tok == eos:
                    self._retire(slot, st, "eos")
                elif len(st.generated) >= st.max_new:
                    self._retire(slot, st, "length")
                elif self.sc.max_wall_s is not None and now - st.t_submit > self.sc.max_wall_s:
                    self.counters.budget_truncated += 1
                    self.counters.warn_once(
                        "wall_budget",
                        f"serve request {rid} exceeded wall-clock budget max_wall_s={self.sc.max_wall_s} after "
                        f"{len(st.generated)}/{st.max_new} tokens; returning truncated response (counted in "
                        f"ServeMetrics.budget_truncated; warning not repeated)")
                    self._retire(slot, st, "budget")
        self.tokens_out += step_tokens
        m = sched.metrics()
        m.update(step_tokens=float(step_tokens), prefills=float(prefills))
        return m

    def run_until_drained(self) -> Dict[int, Completion]:
        """Step until every admitted request has retired; returns and clears
        the accumulated completions. On a no-progress step the engine backs
        off (freezes admissions, force-retires over-deadline slots); only
        after ``livelock_patience`` consecutive stuck steps does it raise
        :class:`LivelockError`."""
        sched = self.scheduler
        self._no_progress = 0
        while sched.queue or sched.active_slots():
            before = self._progress_sig()
            self.step()
            if self._progress_sig() == before:
                self._no_progress += 1
                self._backoff()
                if self._no_progress >= self.sc.livelock_patience:
                    raise LivelockError(self.metrics(), sched.slot_rid, tuple(sched.queue))
            else:
                self._no_progress = 0
        done, self._done = self._done, {}
        return done

    def completions(self) -> Dict[int, Completion]:
        """Completions retired so far (without draining the batch)."""
        done, self._done = self._done, {}
        return done

    def metrics(self) -> ServeMetrics:
        """One consistent snapshot of serving health; no device sync."""
        c = self.counters
        sched, pool = self.scheduler, self.pool
        return ServeMetrics(
            queue_depth=len(sched.queue), active_slots=len(sched.active_slots()), free_pages=pool.free_pages,
            used_pages=pool.used_pages, page_high_water=pool.high_water, pool_capacity=pool.capacity,
            admitted=sched.admitted, retired=sched.retired, preempted=sched.preempted,
            sched_steps=self.sched_steps, decode_steps=self.decode_steps, prefill_chunks=self.prefill_chunks,
            tokens_out=self.tokens_out, nan_retired=c.nan_retired, deadline_expired=c.deadline_expired,
            budget_truncated=c.budget_truncated, truncated_max_new=c.truncated_max_new,
            rejected_queue=c.rejected_queue, rejected_pool=c.rejected_pool, livelock_backoffs=c.livelock_backoffs,
            ttft_mean_s=c.ttft_sum_s / c.ttft_n if c.ttft_n else None,
            tpot_mean_s=c.tpot_sum_s / c.tpot_n if c.tpot_n else None)

    # ------------------------------------------------------------------
    # Progress / livelock handling
    # ------------------------------------------------------------------

    def _progress_sig(self) -> Tuple[int, ...]:
        sched = self.scheduler
        return (self.tokens_out, sched.admitted, sched.retired, sched.preempted, self._completed_total)

    def _backoff(self) -> None:
        """Deterministic no-progress backoff: count the round, force-retire
        anything past its deadline, and freeze admissions at the start of a
        burst."""
        self.counters.livelock_backoffs += 1
        self._expire_deadlines()
        if self._no_progress == 1:
            self._admit_freeze = self.sc.backoff_freeze_steps

    def _expire_deadlines(self) -> None:
        """Retire every request past its deadline: queued ones are dropped
        without touching the device; active ones give up their slot and
        pages at once, returning whatever they generated."""
        now = self._now()
        sched = self.scheduler

        def expired(st: _ReqState) -> bool:
            return st.deadline_s is not None and now - st.t_submit > st.deadline_s

        for rid in [r for r in sched.queue if expired(self._reqs[r])]:
            st = self._reqs[rid]
            sched.drop_queued(rid)
            self._count_deadline(st)
            self._finish(st, "deadline")
        for slot, rid in list(sched.active_slots()):
            st = self._reqs[rid]
            if expired(st):
                self._count_deadline(st)
                self._retire(slot, st, "deadline")

    def _count_deadline(self, st: _ReqState) -> None:
        self.counters.deadline_expired += 1
        self.counters.warn_once(
            "deadline",
            f"serve request {st.rid} exceeded its deadline_s={st.deadline_s} after {len(st.generated)}/"
            f"{st.max_new} tokens; retiring with reason='deadline' (counted in ServeMetrics.deadline_expired; "
            f"warning not repeated)")

    # ------------------------------------------------------------------
    # Paged internals
    # ------------------------------------------------------------------

    def _pool_dtype(self) -> torch.dtype:
        return torch.float32 if self.cfg.dtype == torch.float32 else torch.bfloat16

    def _device_pools(self) -> Dict[str, torch.Tensor]:
        if self._pools is None:
            self._pools = transformer.init_paged_pools(self.cfg, self.pool.n_pages, self.pool.page_size,
                                                       self._pool_dtype(), self.device)
        return self._pools

    def _prefill_into(self, slot: int, st: _ReqState) -> None:
        """Chunk-prefill a freshly admitted request's whole known context
        (prompt + any pre-preemption tokens) and sample its next token."""
        ctx = st.ctx_tokens()
        n_ctx = ctx.shape[0]
        chunk = self.sc.prefill_chunk
        n_chunks = -(-n_ctx // chunk)
        row = self._tensor(self.scheduler.table[slot:slot + 1])
        logits = ok_dev = None
        n_valid = chunk
        for k in range(n_chunks):
            lo = k * chunk
            n_valid = min(chunk, n_ctx - lo)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :n_valid] = ctx[lo:lo + n_valid]
            logits, ok_dev, _ = transformer.paged_prefill_chunk(self.cfg, self.params, self._device_pools(), row,
                                                                lo, n_valid, self._tensor(buf))
            self.prefill_chunks += 1
            if self.sc.max_wall_s is not None and self._now() - st.t_submit > self.sc.max_wall_s:
                self.counters.budget_truncated += 1
                self.counters.warn_once(
                    "wall_budget",
                    f"serve request {st.rid} exceeded wall-clock budget max_wall_s={self.sc.max_wall_s} during "
                    f"prefill ({k + 1}/{n_chunks} chunks); returning prompt only (counted in "
                    f"ServeMetrics.budget_truncated; warning not repeated)")
                st.ctx_len = lo + n_valid
                self._retire(slot, st, "budget")
                return
        st.ctx_len = n_ctx
        if not bool(ok_dev):
            self._retire_nan(slot, st)
            return
        tok = self._sample_one(st, logits[0, n_valid - 1].float().cpu().numpy())
        st.generated.append(tok)
        self.tokens_out += 1
        eos = st.request.eos_id
        if eos is not None and tok == eos:
            self._retire(slot, st, "eos")
        elif len(st.generated) >= st.max_new:
            self._retire(slot, st, "length")

    def _sample_one(self, st: _ReqState, logits_row: np.ndarray) -> int:
        if st.t_first is None:
            st.t_first = self._now()
        temp = st.request.temperature if st.request.temperature is not None else self.sc.temperature
        if temp <= 0.0:
            return int(np.argmax(logits_row))
        seed = st.request.seed if st.request.seed is not None else self.sc.seed
        # Seed from (seed, token index): resampling the same index after a
        # preemption recompute draws the same token.
        state = np.random.SeedSequence([seed, len(st.generated)]).generate_state(2, np.uint64)
        gen = torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))
        probs = torch.softmax(torch.from_numpy(logits_row).double() / temp, dim=0)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _retire_nan(self, slot: int, st: _ReqState) -> None:
        """Poisoned slot: skip sampling (no garbage token escapes) and retire
        with whatever was generated before."""
        self.counters.nan_retired += 1
        self.counters.warn_once(
            "nan_logits",
            f"non-finite logits for serve request {st.rid} after {len(st.generated)} tokens; skipping sampling and "
            f"retiring with reason='nan' (counted in ServeMetrics.nan_retired; warning not repeated)")
        self._retire(slot, st, "nan")

    def _retire(self, slot: int, st: _ReqState, reason: str) -> None:
        self.scheduler.retire(slot)
        self._finish(st, reason)

    def _finish(self, st: _ReqState, reason: str) -> None:
        """Build the Completion and fold its latency stats into the
        engine-level TTFT/TPOT aggregates."""
        now = self._now()
        ttft = None if st.t_first is None else st.t_first - st.t_submit
        wall = now - st.t_submit
        tpot = None
        if ttft is not None and len(st.generated) > 1:
            tpot = (wall - ttft) / (len(st.generated) - 1)
        if ttft is not None:
            self.counters.ttft_sum_s += ttft
            self.counters.ttft_n += 1
        if tpot is not None:
            self.counters.tpot_sum_s += tpot
            self.counters.tpot_n += 1
        self._done[st.rid] = Completion(id=st.rid, prompt=st.prompt, tokens=np.asarray(st.generated, np.int32),
                                        finish_reason=reason, ttft_s=ttft, wall_s=wall,
                                        preemptions=st.preemptions, tpot_s=tpot)
        del self._reqs[st.rid]
        self._completed_total += 1

    # ------------------------------------------------------------------
    # Batch wrapper and the legacy loop
    # ------------------------------------------------------------------

    def generate(self, prompts, *, eos_id: Optional[int] = None) -> torch.Tensor:
        """prompts: (B, S_prompt) int tokens -> (B, S_prompt + new) int32 on
        the CPU. On the paged path it submits one :class:`Request` per row
        and pads the ragged completions back into a rectangle (eos_id, or
        0, as filler); otherwise it runs the legacy loop."""
        host = _prompt_array(prompts).reshape(len(prompts), -1)
        if not self._paged:
            return self._generate_legacy(torch.from_numpy(host), eos_id=eos_id)
        rids = []
        for i, row in enumerate(host):
            rid = self.submit(Request(prompt=row, eos_id=eos_id))
            if isinstance(rid, Rejected):
                raise RuntimeError(f"generate() row {i} rejected by admission control ({rid.reason}) — the "
                                   f"batch wrapper cannot shed load; use submit() directly under backpressure")
            rids.append(rid)
        done = self.run_until_drained()
        rows = [np.concatenate([host[i], done[rid].tokens]) for i, rid in enumerate(rids)]
        out = np.full((len(rows), max(len(r) for r in rows)), eos_id if eos_id is not None else 0, np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return torch.from_numpy(out)

    def _sample(self, logits: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
        """(B, 1) int32 next tokens on the device from (B, 1, vocab) logits."""
        last = logits[:, -1].float()
        if self.sc.temperature <= 0.0:
            return last.argmax(dim=-1, keepdim=True).to(torch.int32)
        probs = torch.softmax(last / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)

    def _generate_legacy(self, prompts: torch.Tensor, *, eos_id: Optional[int] = None) -> torch.Tensor:
        """The token-by-token batch loop over dense per-row caches: the
        prompt is fed one position per :func:`transformer.decode_step`, then
        each sampled token. The caches hold ``max_seq`` positions; a request
        that would overrun them is truncated (counted, warned once), and a
        prompt that fills them raises."""
        if not self.cfg.embed_inputs:
            raise NotImplementedError(f"arch '{self.cfg.name}' is encoder-only: it has no decode step")
        b, s_prompt = prompts.shape
        budget = self.sc.max_seq - s_prompt
        if budget <= 0:
            raise ValueError(f"prompt length {s_prompt} leaves no room to generate within max_seq={self.sc.max_seq}")
        max_new = self.sc.max_new_tokens
        if max_new > budget:
            self.counters.truncated_max_new += 1
            self.counters.warn_once(
                "truncate_max_new",
                f"truncating max_new_tokens {max_new} -> {budget}: prompt length {s_prompt} + requested tokens "
                f"would overrun the max_seq={self.sc.max_seq} cache (counted in ServeMetrics.truncated_max_new; "
                f"warning not repeated)")
            max_new = budget
        dtype = torch.float32 if self.cfg.dtype == torch.float32 else torch.bfloat16
        cache = transformer.init_decode_cache(self.cfg, b, self.sc.max_seq, dtype, device=self.device)
        gen = None
        if self.sc.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(self.sc.seed)
        t0 = self._now()

        def over_budget() -> bool:
            return self.sc.max_wall_s is not None and self._now() - t0 > self.sc.max_wall_s

        dev_prompts = prompts.to(self.device)
        logits = None
        for i in range(s_prompt):                      # prefill, one position a step
            logits, cache = self._decode(self.params, cache, dev_prompts[:, i:i + 1])
            self.decode_steps += 1
            if over_budget():
                # Nothing sensible can be emitted without the whole prompt:
                # the degraded response is the prompt unchanged.
                self.counters.budget_truncated += 1
                self.counters.warn_once(
                    "wall_budget",
                    f"serve batch exceeded wall-clock budget max_wall_s={self.sc.max_wall_s} during prefill "
                    f"({i + 1}/{s_prompt} tokens); returning prompt only (counted in "
                    f"ServeMetrics.budget_truncated; warning not repeated)")
                return prompts.to(torch.int32)
        out: List[torch.Tensor] = [dev_prompts.to(torch.int32)]
        done = torch.zeros((b, 1), dtype=torch.bool, device=self.device)
        for n in range(max_new):                       # decode
            nxt = self._sample(logits, gen)
            if eos_id is not None:
                done = done | (nxt == eos_id)
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            out.append(nxt)
            self.tokens_out += b
            if eos_id is not None and bool(done.all()):
                break                                  # every row finished
            if over_budget():
                self.counters.budget_truncated += 1
                self.counters.warn_once(
                    "wall_budget",
                    f"serve batch exceeded wall-clock budget max_wall_s={self.sc.max_wall_s} after {n + 1}/"
                    f"{max_new} tokens; returning truncated response (counted in ServeMetrics.budget_truncated; "
                    f"warning not repeated)")
                break
            if n + 1 == max_new:
                break                                  # the last token needs no step
            logits, cache = self._decode(self.params, cache, nxt)
            self.decode_steps += 1
        return torch.cat(out, dim=1).cpu()
