"""The port's guard policy, fault plan and learning-rate schedules against the
JAX package's on the same inputs: the same observation sequences give the
same actions, counters and lr scales; the same steps give the same fault
multipliers; schedules agree within 1e-6 relative at a grid of counts (both
compute in f32). Also the optimizer-state walkers and ``scale_by_schedule``'s
count, which rides in checkpoints at JAX's chain index.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import schedules as jax_schedules
from repro.train.faults import FaultPlan as JaxFaultPlan
from repro.train.guard import Guard as JaxGuard, GuardConfig as JaxGuardConfig
from repro_torch.configs import get_reduced
from repro_torch.core.slim_adam import ScaleBySlimAdamState
from repro_torch.models import Transformer
from repro_torch.optim import fused, schedules
from repro_torch.optim.base import ChainState
from repro_torch.train import FaultPlan, Guard, GuardConfig, find_step_health, strip_step_health
from repro_torch.train.guard import attach_slim_snr, find_slim_snr, strip_slim_snr
from repro_torch.train.trainer import make_optimizer

GUARD_KW = dict(max_bad_steps=2, min_history=4, window=8, max_rollbacks=2)


def _sequence(kind: str):
    """(loss, skipped, nonfinite) observations, from a numpy seed."""
    rng = np.random.default_rng({"calm": 0, "spikes": 1, "skips": 2, "mixed": 3}[kind])
    losses = list(5.0 - 0.05 * np.arange(40) + 0.01 * rng.standard_normal(40))
    obs = [(x, False, 0.0) for x in losses]
    if kind in ("spikes", "mixed"):
        for i in (9, 10, 20, 31):
            obs[i] = (obs[i][0] * 1e3, False, 0.0)
        obs[25] = (float("nan"), False, 0.0)
    if kind in ("skips", "mixed"):
        for i in (5, 14, 15, 16, 33):
            obs[i] = (obs[i][0], True, float(100 + i))
    return obs


@pytest.mark.parametrize("kind", ["calm", "spikes", "skips", "mixed"])
def test_guard_decisions_match_jax(kind):
    jg, tg = JaxGuard(JaxGuardConfig(**GUARD_KW)), Guard(GuardConfig(**GUARD_KW))
    for i, (loss, skipped, nf) in enumerate(_sequence(kind)):
        a, b = jg.observe(loss, skipped=skipped, nonfinite=nf), tg.observe(loss, skipped=skipped, nonfinite=nf)
        assert a == b, (i, a, b)
        if a == "rollback":
            jg.note_rollback()
            tg.note_rollback()
        assert jg.stats() == tg.stats()
    if kind != "calm":
        assert tg.counters["skipped"] + tg.counters["spikes"] > 0


@pytest.mark.parametrize("step", range(10))
def test_fault_plan_matches_jax(step):
    kw = dict(nan_grad_steps=(3,), inf_grad_steps=(5, 6), spike_steps=(6, 8), spike_scale=50.0)
    jp, tp = JaxFaultPlan(**kw), FaultPlan(**kw)
    a, b = jp.grad_scale(step), tp.grad_scale(step)
    assert (math.isnan(a) and math.isnan(b)) or a == b
    assert jp.corrupt_loss(step, 2.5) == tp.corrupt_loss(step, 2.5)
    assert jp.fault_steps == tp.fault_steps == (3, 5, 6, 8)


SCHEDULES = {
    "constant": lambda m: m.constant(3e-3),
    "linear_warmup": lambda m: m.linear_warmup(3e-3, 7),
    "cosine_decay": lambda m: m.cosine_decay(3e-3, 30, alpha=0.1),
    "warmup_cosine": lambda m: m.warmup_cosine(3e-3, 5, 40),
    "warmup_cosine_end": lambda m: m.warmup_cosine(1e-2, 0, 20, end_value=1e-4),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    js, ts = SCHEDULES[name](jax_schedules), SCHEDULES[name](schedules)
    for count in [0, 1, 2, 4, 5, 6, 7, 8, 15, 20, 29, 30, 39, 40, 41, 100]:
        want = float(js(jnp.asarray(count, jnp.int32)))
        got = ts(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0, err_msg=f"{name} at {count}")


def test_schedule_rides_the_chain_with_a_count():
    model = Transformer(get_reduced("gpt_small"), device="cpu")
    tx = make_optimizer("slim", schedules.warmup_cosine(3e-3, 2, 10), model.params, model.meta)
    state = tx.init(model.params)
    assert isinstance(state.inner_states[3], tuple) and int(state.inner_states[3].count) == 0
    grads = {k: torch.ones_like(p) for k, p in model.params.items()}
    with torch.no_grad():
        u0, state = tx.update(grads, state, model.params)
        assert int(state.inner_states[3].count) == 1
        assert all(float(u.abs().max()) == 0.0 for u in u0.values())     # warmup: lr(0) = 0
        u1, state = tx.update(grads, state, model.params)
    assert max(float(u.abs().max()) for u in u1.values()) > 0.0


def test_state_walkers():
    model = Transformer(get_reduced("gpt_small"), device="cpu")
    tx = make_optimizer("slim", 1e-3, model.params, model.meta, emit_snr=True, emit_health=True,
                        backend="fused")
    grads = {k: torch.full_like(p, 0.5) for k, p in model.params.items()}
    _, state = tx.update(grads, tx.init(model.params), model.params)
    health, snr = find_step_health(state), find_slim_snr(state)
    assert isinstance(health, fused.StepHealth) and not bool(health.bad)
    assert set(snr) == set(model.params) and any(v is not None for v in snr.values())
    clean = strip_slim_snr(strip_step_health(state))
    assert find_step_health(clean) is None and find_slim_snr(clean) is None
    assert isinstance(clean, ChainState) and isinstance(clean.inner_states[1], ScaleBySlimAdamState)
    assert find_slim_snr(attach_slim_snr(clean, snr)) is snr
    assert attach_slim_snr(clean, None) is clean
