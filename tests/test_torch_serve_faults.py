"""The port's serving fault layer (``repro_torch.serve.faults``, the engine's
serving points, ``KVPool.reserve``, the fault counters) on the CPU: a twin
of every class of tests/test_serve_faults.py at its reduced gpt_small
geometries, then the same ``ServeFaultPlan`` installed on the JAX engine and
on the port's with the same weights (carried by ``repro_torch.convert``).

The clean engine is the oracle throughout: an injected run must give the
same greedy tokens or retire the affected request with a meaningful
finish_reason, never garbage tokens, never a leak. Across the packages,
tokens, finish reasons and every ``ServeMetrics`` counter must be equal (the
latency means are wall-clock readings and differ). The port degrades only on
an exception of the ``serve.kernel`` hook; one raised by the kernel path
itself propagates (the JAX engine degrades on any).
"""
import dataclasses
import warnings

import numpy as np
import pytest

from _torch_parity import jax_params
from repro_torch import injection
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.serve import (
    Engine,
    LivelockError,
    Rejected,
    Request,
    ServeConfig,
    ServeFaultPlan,
    inject_paged_kernel_failure,
)
from repro_torch.serve.drill import DRILL_DEADLINE_S, DRILL_PLAN, DRILL_SC, admission_check, run_drill
from repro_torch.serve.faults import CLOCK_POINT, KERNEL_POINT, LOGITS_POINT, STEP_POINT
from repro_torch.serve.kvpool import RESERVED_RID

pytestmark = pytest.mark.filterwarnings("ignore")

# benchmarks/serve_drill.py's engine, plan and deadline (repro_torch.serve.drill)
DRILL_DEADLINE = (5, DRILL_DEADLINE_S)     # (submission index, deadline_s)
LATENCY = ("ttft_mean_s", "tpot_mean_s")


def _mk(arch="gpt_small", **sc_kw):
    """The reduced architecture with the JAX package's weights (seed 0)."""
    _, _, _, arrays = jax_params(seed=0, arch=arch)
    return get_reduced(arch), params_from_numpy(arrays, "cpu"), ServeConfig(**sc_kw)


def _engine(cfg, params, sc):
    return Engine(cfg, params, sc, device="cpu")


def _prompt(n, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _invariants(eng):
    """No slot double-use, no page mapped twice, the table agrees with the
    pool's ownership; checked live between scheduler steps."""
    sched = eng.scheduler
    seen = {}
    for slot in range(sched.n_slots):
        rid = sched.slot_rid[slot]
        row = sched.table[slot]
        if rid is None:
            assert not row.any(), f"empty slot {slot} has mapped pages"
            continue
        for pg in row[row != 0]:
            assert pg not in seen, f"page {pg} mapped by slots {seen[pg]},{slot}"
            seen[int(pg)] = slot
            assert eng.pool.owner(int(pg)) == rid


class TestInjectionRegistry:
    def test_fire_without_hook_is_noop(self):
        assert injection.fire("test.nothing", 1, 2) is None
        for point in (KERNEL_POINT, LOGITS_POINT, CLOCK_POINT, STEP_POINT):
            assert injection.get(point) is None

    def test_installed_restores_previous_hook(self):
        with injection.installed("test.point", lambda: "outer"):
            with injection.installed("test.point", lambda: "inner"):
                assert injection.fire("test.point") == "inner"
            assert injection.fire("test.point") == "outer"
        assert injection.get("test.point") is None

    def test_call_counter_fails_on_schedule(self):
        hook, state = injection.call_counter((2,), lambda n: RuntimeError(f"boom #{n}"))
        hook()
        with pytest.raises(RuntimeError, match="boom #2"):
            hook()
        hook()
        assert state == {"calls": 3, "failed": 1}

    def test_plan_installs_all_four_points_and_removes_them(self):
        cfg, params, sc = _mk(max_seq=32, page_size=4)
        eng = _engine(cfg, params, sc)
        with ServeFaultPlan().install(eng):
            assert all(injection.get(p) is not None for p in (KERNEL_POINT, LOGITS_POINT, CLOCK_POINT, STEP_POINT))
        assert all(injection.get(p) is None for p in (KERNEL_POINT, LOGITS_POINT, CLOCK_POINT, STEP_POINT))


class TestAdmissionControl:
    def test_queue_full_rejects_without_exception(self):
        cfg, params, sc = _mk(max_seq=32, page_size=4, max_queue=1)
        eng = _engine(cfg, params, sc)
        first = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        assert isinstance(first, int)
        verdict = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        assert isinstance(verdict, Rejected)
        assert verdict.reason == "queue_full"
        assert verdict.queue_depth == 1
        m = eng.metrics()
        assert m.rejected_queue == 1 and m.rejected == 1

    def test_pool_pressure_rejects_on_projected_demand(self):
        # capacity 8 pages, watermark 0.5 -> 4 pages; each request projects
        # ceil((8 prompt + 8 new) / 4) = 4 pages, so the second must bounce.
        cfg, params, sc = _mk(max_seq=32, page_size=4, pool_pages=9, max_new_tokens=8, admit_watermark=0.5)
        eng = _engine(cfg, params, sc)
        first = eng.submit(Request(prompt=_prompt(8, cfg.vocab_size)))
        assert isinstance(first, int)
        verdict = eng.submit(Request(prompt=_prompt(8, cfg.vocab_size)))
        assert isinstance(verdict, Rejected)
        assert verdict.reason == "pool_pressure"
        assert verdict.projected_pages == 8 > 0.5 * verdict.pool_capacity
        assert eng.metrics().rejected_pool == 1

    def test_impossible_request_still_raises(self):
        cfg, params, sc = _mk(max_seq=16, page_size=4, pool_pages=3)
        eng = _engine(cfg, params, sc)
        with pytest.raises(ValueError, match="pool"):
            eng.submit(Request(prompt=_prompt(8, cfg.vocab_size)))


class TestDeadlines:
    def test_queued_request_past_deadline_is_dropped(self):
        cfg, params, sc = _mk(max_seq=32, page_size=4, max_slots=1, max_new_tokens=3)
        eng = _engine(cfg, params, sc)
        r0 = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        r1 = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size), deadline_s=0.0))
        done = eng.run_until_drained()
        assert done[r1].finish_reason == "deadline"
        assert len(done[r1].tokens) == 0
        assert done[r0].finish_reason == "length"
        assert eng.scheduler.admitted == 1      # r1 never reached a slot or the device
        assert eng.metrics().deadline_expired == 1
        assert eng.pool.used_pages == 0

    def test_active_request_retires_on_stalled_clock(self):
        cfg, params, sc = _mk(max_seq=48, page_size=4, max_new_tokens=8)
        eng = _engine(cfg, params, sc)
        rid = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size), deadline_s=60.0))
        plan = ServeFaultPlan(stall_steps=(2,), stall_s=120.0)
        with plan.install(eng):
            done = eng.run_until_drained()
        c = done[rid]
        assert c.finish_reason == "deadline"
        assert 0 < len(c.tokens) < 8       # partial progress returned
        m = eng.metrics()
        assert m.deadline_expired == 1 and m.injected_stalls == 1
        assert eng.pool.used_pages == 0
        assert eng._clock_skew == 120.0


class TestDegradation:
    def test_kernel_failure_degrades_with_token_parity(self):
        cfg, params, sc = _mk(max_seq=48, page_size=4, max_new_tokens=6, prefill_chunk=4)
        prompt = _prompt(6, cfg.vocab_size)
        clean_eng = _engine(cfg, params, sc)
        rid = clean_eng.submit(Request(prompt=prompt))
        clean = clean_eng.run_until_drained()[rid].tokens

        eng = _engine(cfg, params, sc)
        rid = eng.submit(Request(prompt=prompt))
        # dispatch 1 = the first prefill chunk, dispatch 4 = a decode step
        with inject_paged_kernel_failure(fail_on=(1, 4)) as state:
            done = eng.run_until_drained()
        assert state == {"calls": 2 + 5, "failed": 2}     # 2 chunks, 5 decode steps
        m = eng.metrics()
        assert m.degraded_steps == 2
        assert done[rid].finish_reason == "length"
        np.testing.assert_array_equal(done[rid].tokens, clean)

    def test_degraded_step_runs_the_plain_twin(self, monkeypatch):
        """A degraded decode step or chunk asks the attention for the plain
        twin; every other step for the kernel."""
        cfg, params, sc = _mk(max_seq=48, page_size=4, max_new_tokens=4, prefill_chunk=4)
        impls = []
        real = tattn._attend
        monkeypatch.setattr(tattn, "_attend", lambda *a: impls.append(a[-1]) or real(*a))
        eng = _engine(cfg, params, sc)
        eng.submit(Request(prompt=_prompt(6, cfg.vocab_size)))
        with ServeFaultPlan(kernel_fail_steps=(1,), prefill_fail_chunks=(0,)).install(eng):
            eng.run_until_drained()
        per_call = [impls[i:i + cfg.n_layers] for i in range(0, len(impls), cfg.n_layers)]
        assert all(len(set(c)) == 1 for c in per_call)
        # 2 prefill chunks, then 3 decode steps
        assert [c[0] for c in per_call] == ["plain", "kernel", "kernel", "plain", "kernel"]
        assert eng.metrics().degraded_steps == 2

    def test_kernel_path_exception_propagates_undegraded(self, monkeypatch):
        cfg, params, sc = _mk(max_seq=48, page_size=4, max_new_tokens=4, prefill_chunk=4)

        def broken(*_a):
            raise RuntimeError("paged_attention: launch failed")

        monkeypatch.setattr(tattn, "paged_attention", broken)
        eng = _engine(cfg, params, sc)
        eng.submit(Request(prompt=_prompt(6, cfg.vocab_size)))
        with ServeFaultPlan(kernel_fail_steps=(3,)).install(eng):
            with pytest.raises(RuntimeError, match="launch failed"):
                eng.step()
        m = eng.metrics()
        assert m.degraded_steps == 0 and m.prefill_chunks == 0
        assert "kernel_degraded" not in eng.counters.warned_codes

    def test_genuine_nan_logits_retire_not_crash(self):
        cfg, params, sc = _mk(max_seq=32, page_size=4, max_new_tokens=4)
        # One NaN embedding row: with tied embeddings every logit row grows a
        # NaN column, so the health tap fires at prefill.
        bad = dict(params)
        bad["embed"] = params["embed"].clone()
        bad["embed"][0] = float("nan")
        eng = _engine(cfg, bad, sc)
        rid = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        done = eng.run_until_drained()
        assert done[rid].finish_reason == "nan"
        assert len(done[rid].tokens) == 0
        m = eng.metrics()
        assert m.nan_retired == 1 and m.injected_poison == 0
        assert eng.pool.used_pages == 0

    @pytest.mark.parametrize("poison_after", [0, 2])
    def test_injected_poison_isolates_one_request(self, poison_after):
        """poison_after 0 poisons at prefill, 2 after two decoded tokens."""
        cfg, params, sc = _mk(max_seq=48, page_size=4, max_new_tokens=6)
        prompts = [_prompt(5, cfg.vocab_size, seed=s) for s in (1, 2)]
        clean_eng = _engine(cfg, params, sc)
        crids = [clean_eng.submit(Request(prompt=p)) for p in prompts]
        clean = clean_eng.run_until_drained()

        eng = _engine(cfg, params, sc)
        rids = [eng.submit(Request(prompt=p)) for p in prompts]
        plan = ServeFaultPlan(poison_rids=(rids[1],), poison_after=poison_after)
        with plan.install(eng):
            done = eng.run_until_drained()
        # the clean slot never notices its neighbour's poisoning
        assert done[rids[0]].finish_reason == "length"
        np.testing.assert_array_equal(done[rids[0]].tokens, clean[crids[0]].tokens)
        poisoned = done[rids[1]]
        assert poisoned.finish_reason == "nan"
        assert len(poisoned.tokens) == poison_after
        np.testing.assert_array_equal(poisoned.tokens, clean[crids[1]].tokens[:poison_after])
        m = eng.metrics()
        assert m.nan_retired == 1 and m.injected_poison == 1


class TestLivelock:
    def test_wedged_pool_raises_diagnosable_livelock(self):
        cfg, params, sc = _mk(max_seq=32, page_size=4, pool_pages=5, max_new_tokens=4, livelock_patience=4)
        eng = _engine(cfg, params, sc)
        # Hold every free page: the queued request can never admit, so the
        # drain must back off and then diagnose.
        held = eng.pool.reserve(eng.pool.capacity)
        assert all(eng.pool.owner(pg) == RESERVED_RID for pg in held)
        rid = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        with pytest.raises(LivelockError) as ei:
            eng.run_until_drained()
        err = ei.value
        assert err.queued_rids == (rid,)
        assert err.metrics.livelock_backoffs == 4
        assert err.metrics.free_pages == 0
        for needle in ("free_pages=0", f"queue=[{rid}]", "slot_rids"):
            assert needle in str(err)
        assert isinstance(err, RuntimeError)
        eng.pool.unreserve(held)
        assert eng.pool.free_pages == eng.pool.capacity

    def test_transient_pressure_recovers_without_error(self):
        cfg, params, sc = _mk(max_seq=32, page_size=4, pool_pages=5, max_new_tokens=4, livelock_patience=12)
        eng = _engine(cfg, params, sc)
        # Squeeze the whole pool for a few steps, then release: backoff must
        # bridge the window and the request still complete.
        plan = ServeFaultPlan(squeeze_window=(0, 4), squeeze_pages=eng.pool.capacity)
        rid = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        with plan.install(eng):
            done = eng.run_until_drained()
        assert done[rid].finish_reason == "length"
        assert eng.metrics().livelock_backoffs >= 1
        assert eng.pool.used_pages == 0

    def test_squeeze_pages_return_when_the_run_ends_inside_the_window(self):
        cfg, params, sc = _mk(max_seq=32, page_size=4, pool_pages=9, max_new_tokens=2)
        eng = _engine(cfg, params, sc)
        rid = eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        with ServeFaultPlan(squeeze_window=(0, 100), squeeze_pages=3).install(eng):
            done = eng.run_until_drained()
            assert eng.pool.used_pages == 3         # still held inside the scope
        assert done[rid].finish_reason == "length"
        assert eng.pool.used_pages == 0
        assert eng.pool.alloc_count == eng.pool.free_count


class TestWarnOnce:
    def test_truncation_warns_once_but_counts_every_time(self):
        cfg, params, sc = _mk(max_seq=8, page_size=4, max_new_tokens=32)
        eng = _engine(cfg, params, sc)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
            eng.submit(Request(prompt=_prompt(4, cfg.vocab_size)))
        truncs = [x for x in w if "truncating" in str(x.message)]
        assert len(truncs) == 1
        assert eng.counters.truncated_max_new == 2
        assert eng.counters.warned_codes == ("truncate_max_new",)

    def test_degradation_warns_once_but_counts_every_time(self):
        cfg, params, sc = _mk(max_seq=48, page_size=4, max_new_tokens=6, prefill_chunk=4)
        eng = _engine(cfg, params, sc)
        eng.submit(Request(prompt=_prompt(6, cfg.vocab_size)))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with ServeFaultPlan(kernel_fail_steps=(0, 1, 2)).install(eng):
                eng.run_until_drained()
        assert len([x for x in w if "plain attention" in str(x.message)]) == 1
        assert eng.counters.degraded_steps == 3
        assert eng.counters.warned_codes == ("kernel_degraded",)


class TestChaos:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_faults_preserve_scheduler_invariants(self, seed):
        """Seeded random workload and fault plan on a near-capacity pool:
        every scheduler step upholds the ownership invariants, every
        accepted request completes, and the pool drains to zero."""
        rng = np.random.default_rng(seed)
        cfg, params, sc = _mk(max_seq=32, page_size=4, max_slots=3, pool_pages=11, max_new_tokens=5,
                              prefill_chunk=4)
        eng = _engine(cfg, params, sc)
        n_req = 5
        prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 10))) for _ in range(n_req)]
        plan = ServeFaultPlan(
            kernel_fail_steps=tuple(int(x) for x in rng.choice(12, size=2, replace=False)),
            prefill_fail_chunks=(int(rng.integers(0, 4)),),
            poison_rids=(int(rng.integers(0, n_req)),),
            poison_after=int(rng.integers(1, 4)),
            squeeze_window=(1, 5),
            squeeze_pages=int(rng.integers(0, 5)),
        )
        with plan.install(eng):
            rids = [eng.submit(Request(prompt=p)) for p in prompts]
            assert all(isinstance(r, int) for r in rids)
            steps = 0
            while eng.scheduler.queue or eng.scheduler.active_slots():
                eng.step()
                _invariants(eng)
                steps += 1
                assert steps < 200, "chaos run failed to drain"
        done = eng.completions()
        assert set(done) == set(rids)
        assert all(c.finish_reason in ("eos", "length", "nan") for c in done.values())
        assert eng.pool.used_pages == 0
        assert eng.pool.alloc_count == eng.pool.free_count
        assert eng.metrics().degraded_steps >= 1       # at least one injection landed


# ---------------------------------------------------------------------------
# One plan on both packages' engines
# ---------------------------------------------------------------------------


def _drill(engine_cls, request_cls, plan_cls, cfg, params, sc, prompts, *, device=None):
    """serve_drill's injected run: (tokens, finish reasons, counters)."""
    eng = engine_cls(cfg, params, sc) if device is None else engine_cls(cfg, params, sc, device=device)
    idx, deadline = DRILL_DEADLINE
    with plan_cls(**dataclasses.asdict(DRILL_PLAN)).install(eng):
        rids = [eng.submit(request_cls(prompt=p, deadline_s=deadline if i == idx else None))
                for i, p in enumerate(prompts)]
        done = eng.run_until_drained()
    counters = {k: v for k, v in eng.metrics().to_dict().items() if k not in LATENCY}
    return ([done[r].tokens.tolist() for r in rids], [done[r].finish_reason for r in rids], counters,
            (eng.pool.used_pages, eng.pool.alloc_count, eng.pool.free_count))


def test_one_plan_on_both_engines_gives_equal_runs():
    from repro.serve import Engine as JaxEngine, Request as JaxRequest, ServeConfig as JaxServeConfig
    from repro.serve import ServeFaultPlan as JaxServeFaultPlan

    jcfg, jparams, _, arrays = jax_params(seed=0, arch="gpt_small")
    cfg, params = get_reduced("gpt_small"), params_from_numpy(arrays, "cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (6, 8), dtype=np.int32)
    want = _drill(JaxEngine, JaxRequest, JaxServeFaultPlan, jcfg, jparams, JaxServeConfig(**DRILL_SC), prompts)
    got = _drill(Engine, Request, ServeFaultPlan, cfg, params, ServeConfig(**DRILL_SC), prompts, device="cpu")
    assert got[0] == want[0], "tokens"
    assert got[1] == want[1], "finish reasons"
    assert got[2] == want[2], "counters"
    assert got[3] == want[3] and got[3][0] == 0, "pool accounting"
    # every injection of the plan shows (the drill's gate (d))
    m = got[2]
    assert m["degraded_steps"] == 3 and m["nan_retired"] == 1 and m["injected_poison"] == 1
    assert m["deadline_expired"] == 1 and m["injected_stalls"] == 1 and m["preempted"] >= 1
    assert got[1][2] == "nan" and got[1][5] == "deadline"


def test_drill_gates_hold_on_the_port():
    """benchmarks/serve_drill.py's gates through ``repro_torch.serve.drill``:
    (a) the run drains, (b) greedy parity with a clean run for the clean
    requests and prefix parity for the poisoned one, (c) no leak, (d) every
    injection in the metrics within 200 scheduler steps; and its admission
    check. On the CPU the paged-attention kernel never launches."""
    cfg, params, _ = _mk()
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (6, 8), dtype=np.int32)
    res = run_drill(cfg, params, [Request(prompt=p) for p in prompts], device="cpu")
    assert res.ok, res.failures + res.deviations
    assert res.reasons == ["length", "length", "nan", "length", "length", "deadline"]
    assert len(res.tokens[2]) == DRILL_PLAN.poison_after and res.tokens[5] == []
    assert res.metrics.degraded_steps == 3 and res.kernel_launches == 0
    flood = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 8), dtype=np.int32)
    assert admission_check(cfg, params, flood, device="cpu") == []


def test_drill_catches_a_deviation_and_a_missing_injection():
    """The gates are live: wrong clean tokens fail (b), a plan whose kernel
    failure lands past the run fails (d)."""
    cfg, params, _ = _mk()
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (6, 8), dtype=np.int32)
    reqs = [Request(prompt=p) for p in prompts]
    res = run_drill(cfg, params, reqs, device="cpu", clean_tokens=[[0] * 8] * 6)
    assert not res.failures and len(res.deviations) == 5
    late = dataclasses.replace(DRILL_PLAN, kernel_fail_steps=(2, 5, 10_000))
    res = run_drill(cfg, params, reqs, device="cpu", plan=late)
    assert not res.deviations and any("degraded_steps=3, planned 4" in f for f in res.failures)
