"""The fault-tolerant slice of the port against the JAX package, on the CPU:

* the kernels' plain twins (what the wrappers run for CPU tensors) against
  the Pallas kernels in interpret mode: B1's ``with_snr``/``with_health``
  outputs, B2's ``with_health``, B3 ``adam_precond`` and B4
  ``slim_precond_batched`` in both orientations, with bf16 gradients,
  ragged shapes and gradients seeded with NaN and +-Inf. Elementwise outputs
  within 1e-6 and line sums within 1e-5 of each output's largest finite
  magnitude, at the same non-finite positions; non-finite counts equal;
* ``StepHealth`` from both fused routes and the plain backend against JAX's
  on a gradient tree seeded with NaN/Inf (counts equal, sum of squares
  within 1e-5);
* a guarded 10-step run under the same ``FaultPlan`` (a NaN step, then two
  spikes that escalate to a rollback) in both packages: losses within 1e-3
  relative (f32 reassociation accumulates over the steps) and identical
  guard counters; ``grad_accum=2`` runs likewise;
* the from-update SNR snapshots of a SlimAdam run within 1e-4 relative;
* the kernel-failure drill: the degraded-leaf count equals JAX's on both
  routes, and the degraded update equals the plain backend's within 1e-5;
  the per-leaf route equals the megaplan route within 1e-5.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_numpy, jax_params
from repro.core import rules_as_tree as jax_rules_as_tree, table3_rules as jax_table3
from repro.core.slim_adam import scale_by_slim_adam as jax_scale_by_slim_adam
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.kernels import megaplan as jmega
from repro.kernels.fused_adam import adam_precond as jax_adam_precond
from repro.kernels.slim_update import slim_precond_batched as jax_slim_precond_batched
from repro.optim import fused as jfused
from repro.optim.adam import scale_by_adam as jax_scale_by_adam
from repro.train import FaultPlan as JaxFaultPlan, GuardConfig as JaxGuardConfig, Trainer as JaxTrainer, \
    TrainerConfig as JaxTrainerConfig, inject_kernel_failure as jax_inject_kernel_failure
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import rules_as_tree, table3_rules
from repro_torch.core.slim_adam import scale_by_slim_adam
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.kernels import fused_adam, megaplan as tmega, slim_update
from repro_torch.models import Transformer
from repro_torch.optim import fused
from repro_torch.optim.adam import scale_by_adam
from repro_torch.train import FaultPlan, GuardConfig, Trainer, TrainerConfig, inject_kernel_failure

ELEMENTWISE = 1e-6
LINE_SUMS = 1e-5
TOL_STEP = 1e-5
TOL_LOSS = 1e-3
TOL_SNR = 1e-4
KW = dict(b1=0.9, b2=0.95, eps=1e-8)
DATA = dict(vocab_size=211, seq_len=16, global_batch=4, seed=5)


def _poison(x: np.ndarray, n_bad: int, seed: int) -> np.ndarray:
    """Set ``n_bad`` distinct entries to NaN, +Inf, -Inf in turn."""
    x = x.copy()
    idx = np.random.default_rng(seed).choice(x.size, n_bad, replace=False)
    x.reshape(-1)[idx] = np.array([np.nan, np.inf, -np.inf], np.float32)[np.arange(n_bad) % 3]
    return x


def _close(got, want, tol, what):
    """Same non-finite positions; the finite entries within tol."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    assert_close(np.where(fin, got, 0), np.where(fin, want, 0), tol, what)


def _lines(rng, shape):
    return (0.05 + rng.random(shape)).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


# -- kernels: plain twins against interpret-mode Pallas ----------------------------------------


@pytest.mark.parametrize("b,r,c,axis", [(1, 37, 96, 1), (2, 16, 40, 1), (1, 24, 50, 0), (3, 16, 70, 0)])
@pytest.mark.parametrize("n_bad", [0, 9])
def test_b1_flags_match_jax(b, r, c, axis, n_bad):
    rng = np.random.default_rng(b * r * c + n_bad)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g = _poison(rng.standard_normal((b, r, c)).astype(np.float32), n_bad, c)
    m = (0.1 * rng.standard_normal((b, r, c))).astype(np.float32)
    v = (0.01 * rng.random(line)).astype(np.float32)
    ins = (g, m, v, _lines(rng, line), _lines(rng, line))
    kw = dict(axis=axis, with_snr=True, with_health=True, **KW)
    want = jmega.mega_slim_update_batched(*map(jnp.asarray, ins), interpret=True, **kw)
    got = tmega.mega_slim_update_batched(*map(_t, ins), **kw)
    assert len(got) == len(want) == 7
    for name, a, w, tol in zip(("u", "m'", "v'", "s1c", "s2c"), got, want,
                               (ELEMENTWISE, ELEMENTWISE, LINE_SUMS, LINE_SUMS, LINE_SUMS)):
        _close(a, w, tol, name)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert float(got[5].sum()) == n_bad
    _close(got[6], want[6], LINE_SUMS, "ss")


@pytest.mark.parametrize("rows,cols,n_bad", [(20, 512, 0), (20, 512, 7), (5, 12, 4)])
def test_b2_health_matches_jax(rows, cols, n_bad):
    rng = np.random.default_rng(rows + cols + n_bad)
    g = _poison(rng.standard_normal((rows, cols)).astype(np.float32), n_bad, rows)
    m = (0.1 * rng.standard_normal((rows, cols))).astype(np.float32)
    v = (0.01 * rng.random((rows, cols))).astype(np.float32)
    ins = (g, m, v, _lines(rng, (rows, 1)), _lines(rng, (rows, 1)))
    want = jmega.mega_adam_update(*map(jnp.asarray, ins), with_health=True, interpret=True, **KW)
    got = tmega.mega_adam_update(*map(_t, ins), with_health=True, **KW)
    for name, a, w in zip(("u", "m'", "v'"), got, want):
        _close(a, w, ELEMENTWISE, name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    _close(got[4], want[4], LINE_SUMS, "ss")


@pytest.mark.parametrize("shape", [(37, 129), (64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_bad", [0, 5])
def test_b3_adam_precond_matches_jax(shape, dtype, n_bad):
    rng = np.random.default_rng(sum(shape) + n_bad)
    g = _poison(rng.standard_normal(shape).astype(np.float32), n_bad, 1)
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * rng.random(shape)).astype(np.float32)
    want = jax_adam_precond(_j(g, getattr(jnp, dtype)), _j(m), _j(v), count=3, with_health=True, interpret=True,
                            **KW)
    got = fused_adam.adam_precond(_t(g, getattr(torch, dtype)), _t(m), _t(v), count=3, with_health=True, **KW)
    for name, a, w in zip(("u", "m'", "v'"), got, want):
        _close(a, w, ELEMENTWISE, name)
    assert float(got[3][0]) == float(want[3][0]) == n_bad
    assert_close(got[3][1], want[3][1], LINE_SUMS, "ss")


@pytest.mark.parametrize("b,r,c,axis", [(1, 40, 96, 1), (2, 9, 130, 1), (1, 24, 50, 0), (12, 16, 70, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b4_slim_precond_matches_jax(b, r, c, axis, dtype):
    rng = np.random.default_rng(b + r + c)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g = _poison(rng.standard_normal((b, r, c)).astype(np.float32), 4, 2)
    m = (0.1 * rng.standard_normal((b, r, c))).astype(np.float32)
    v = (0.01 * rng.random(line)).astype(np.float32)
    kw = dict(axis=axis, count=2, with_snr=True, with_health=True, **KW)
    want = jax_slim_precond_batched(_j(g, getattr(jnp, dtype)), _j(m), _j(v), interpret=True, **kw)
    got = slim_update.slim_precond_batched(_t(g, getattr(torch, dtype)), _t(m), _t(v), **kw)
    for name, a, w, tol in zip(("u", "m'", "v'", "s1c", "s2c"), got, want,
                               (ELEMENTWISE, ELEMENTWISE, LINE_SUMS, LINE_SUMS, LINE_SUMS)):
        _close(a, w, tol, name)
    assert float(got[5][0]) == float(want[5][0]) == 4
    assert_close(got[5][1], want[5][1], LINE_SUMS, "ss")
    if b == 1:      # the 2-D wrappers give the same outputs without the batch dim
        fn = slim_update.slim_precond if axis == 1 else slim_update.slim_precond_major
        two = fn(_t(g[0], getattr(torch, dtype)), _t(m[0]), _t(v[0]), **{k: kw[k] for k in kw if k != "axis"})
        for a, w in zip(two, got):
            torch.testing.assert_close(a, w if w.ndim == 1 else w[0], rtol=0, atol=0, equal_nan=True)


# -- StepHealth on a poisoned tree -----------------------------------------------------------


def _poisoned_grads(arrays, seed=3):
    rng = np.random.default_rng(seed)
    g = {k: rng.standard_normal(a.shape).astype(np.float32) for k, a in arrays.items()}
    names = sorted(g)
    for k, n_bad in ((names[0], 3), (names[len(names) // 2], 5), (names[-1], 1)):
        g[k] = _poison(g[k], min(n_bad, g[k].size), 7)
    return g


@pytest.mark.parametrize("name", ["adam", "slim"])
@pytest.mark.parametrize("route", ["mega", "per_leaf", "jnp"])
def test_step_health_matches_jax(name, route):
    _, jparams, jmeta, arrays = jax_params(seed=0)
    tmeta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    tparams = params_from_numpy(arrays, "cpu")
    backend = "jnp" if route == "jnp" else "fused"
    if name == "adam":
        jtx = jax_scale_by_adam(b2=0.95, backend="jnp", emit_health=True)
        ttx = scale_by_adam(b2=0.95, backend=backend, emit_health=True, megakernel=route == "mega")
    else:
        jtx = jax_scale_by_slim_adam(jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta), backend="jnp",
                                     emit_health=True)
        ttx = scale_by_slim_adam(rules_as_tree(table3_rules(tmeta), tparams, tmeta), backend=backend,
                                 emit_health=True, megakernel=route == "mega")
    g = _poisoned_grads(arrays)
    jg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams), [jnp.asarray(g[k]) for k in arrays])
    _, jstate = jtx.update(jg, jtx.init(jparams))
    _, tstate = ttx.update({k: torch.from_numpy(x) for k, x in g.items()}, ttx.init(tparams))
    np.testing.assert_array_equal(tstate.health.nonfinite.numpy(), np.asarray(jstate.health.nonfinite))
    assert float(tstate.health.nonfinite.sum()) == 9 and bool(tstate.health.bad) and bool(jstate.health.bad)
    assert_close(tstate.health.grad_sumsq, jstate.health.grad_sumsq, LINE_SUMS, "grad_sumsq")
    clean = {k: np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0) for k, x in g.items()}
    _, tclean = ttx.update({k: torch.from_numpy(x) for k, x in clean.items()}, ttx.init(tparams))
    assert not bool(tclean.health.bad)


# -- guarded runs, grad_accum and from-update SNR against the JAX trainer -----------------------


def _trainers(optimizer, steps, *, tc_kw=None, tr_kw=None, jax_tr_kw=None, port_okw=None, ckpt=None):
    """(JAX trainer, port trainer) after ``steps`` from the same params;
    JAX on its 'jnp' backend, the port on 'fused' (plain twins)."""
    jcfg, _, _, arrays = jax_params(seed=0)
    tc_kw = dict(tc_kw or {})
    jtc = dict(tc_kw)
    ttc = dict(tc_kw)
    if "guard" in tc_kw:
        jtc["guard"], ttc["guard"] = JaxGuardConfig(**tc_kw["guard"]), GuardConfig(**tc_kw["guard"])
    if ckpt is not None:
        jtc["ckpt_dir"], ttc["ckpt_dir"] = str(ckpt / "jax"), str(ckpt / "port")
    jtr = JaxTrainer(jcfg, optimizer, 3e-3, JaxZipfLM(JaxDataConfig(**DATA)),
                     JaxTrainerConfig(total_steps=steps, log_every=1, seed=0, backend="jnp", **jtc),
                     **(jax_tr_kw or {}))
    ttr = Trainer(get_reduced("gpt_small"), optimizer, 3e-3, ZipfLM(DataConfig(**DATA)),
                  TrainerConfig(total_steps=steps, log_every=1, seed=0, backend="fused", **ttc),
                  optimizer_kw=port_okw, device="cpu", **(tr_kw or {}))
    ttr.model.load_params(params_from_numpy(arrays, "cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtr.run()
        ttr.run()
    return jtr, ttr


@pytest.mark.parametrize("megakernel", [True, False])
def test_guarded_run_matches_jax(tmp_path, megakernel):
    kw = dict(nan_grad_steps=(3,), spike_steps=(6, 7))
    jtr, ttr = _trainers("slim", 10, ckpt=tmp_path, port_okw=dict(megakernel=megakernel),
                         tc_kw=dict(ckpt_every=2, guard=dict(max_bad_steps=2, min_history=4)),
                         jax_tr_kw=dict(faults=JaxFaultPlan(**kw)), tr_kw=dict(faults=FaultPlan(**kw)))
    want, got = jtr.guard.stats(), ttr.guard.stats()
    assert got == want
    assert (got["guard_skipped"], got["guard_spikes"], got["guard_rollbacks"]) == (1.0, 2.0, 1.0)
    assert got["guard_nonfinite_total"] == sum(p.numel() for p in ttr.params.values())
    assert [m["step"] for m in ttr.metrics_log] == [m["step"] for m in jtr.metrics_log]
    np.testing.assert_allclose([m["loss"] for m in ttr.metrics_log], [m["loss"] for m in jtr.metrics_log],
                               rtol=TOL_LOSS)
    assert ttr.ckpt_failures == jtr.ckpt_failures == 0


def test_grad_accum_matches_jax():
    jtr, ttr = _trainers("adam", 4, tr_kw=dict(grad_accum=2), jax_tr_kw=dict(grad_accum=2))
    np.testing.assert_allclose([m["loss"] for m in ttr.metrics_log], [m["loss"] for m in jtr.metrics_log],
                               rtol=TOL_LOSS)
    for k, p in flat_numpy(jtr.params).items():
        assert_close(ttr.params[k].detach(), p, TOL_LOSS, k)


def test_from_update_snr_matches_jax():
    jtr, ttr = _trainers("slim", 4, tc_kw=dict(measure_snr=True, snr_early_every=2, snr_from_update=True))
    assert ttr.snr.steps == jtr.snr.steps == [2, 4]
    assert ttr._train_step_snr is not None
    for pname, by_k in jtr.snr.trajectory.items():
        assert set(ttr.snr.trajectory[pname]) == set(by_k)
        for k, traj in by_k.items():
            np.testing.assert_allclose(ttr.snr.trajectory[pname][k], traj, rtol=TOL_SNR, err_msg=f"{pname} {k}")


# -- kernel-failure drill and the per-leaf route ---------------------------------------------


@pytest.mark.parametrize("megakernel", [True, False])
def test_kernel_failure_drill_matches_jax(megakernel):
    _, jparams, jmeta, arrays = jax_params(seed=0)
    tmeta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    tparams = params_from_numpy(arrays, "cpu")
    jdims = jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta)
    tdims = rules_as_tree(table3_rules(tmeta), tparams, tmeta)
    rng = np.random.default_rng(5)
    g = {k: rng.standard_normal(a.shape).astype(np.float32) for k, a in arrays.items()}
    jg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams), [jnp.asarray(g[k]) for k in arrays])
    tg = {k: torch.from_numpy(x) for k, x in g.items()}
    jtx = jax_scale_by_slim_adam(jdims, backend="fused", megakernel=megakernel)
    ttx = scale_by_slim_adam(tdims, backend="fused", megakernel=megakernel)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax_inject_kernel_failure():
            jtx.update(jg, jtx.init(jparams))
            want = jfused.kernel_degraded_leaves()
        with inject_kernel_failure():
            u_deg, s_deg = ttx.update(tg, ttx.init(tparams))
            got = fused.kernel_degraded_leaves()
    jfused.reset_kernel_degradation()
    assert got == want > 0
    u_plain, s_plain = scale_by_slim_adam(tdims, backend="jnp").update(tg, ttx.init(tparams))
    u_kernel, s_kernel = ttx.update(tg, ttx.init(tparams))
    assert fused.kernel_degraded_leaves() == got          # no hook: nothing more degrades
    fused.reset_kernel_degradation()
    assert fused.kernel_degraded_leaves() == 0
    for k in tg:
        assert_close(u_deg[k], u_plain[k], TOL_STEP, k)
        assert_close(s_deg.nu[k], s_plain.nu[k], TOL_STEP, k)
        assert_close(u_kernel[k], u_plain[k], TOL_STEP, k)


@pytest.mark.parametrize("name", ["adam", "slim"])
def test_per_leaf_route_matches_megaplan(name):
    _, _, _, arrays = jax_params(seed=1)
    model = Transformer(get_reduced("gpt_small"), device="cpu")
    dims = rules_as_tree(table3_rules(model.meta), model.params, model.meta)

    def make(mk):
        if name == "adam":
            return scale_by_adam(b2=0.95, backend="fused", megakernel=mk, emit_health=True)
        return scale_by_slim_adam(dims, backend="fused", megakernel=mk, emit_snr=True, emit_health=True)

    rng = np.random.default_rng(9)
    g = {k: torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)) for k, a in arrays.items()}
    state = make(True).init(model.params)
    (um, sm), (ul, sl) = make(True).update(g, state), make(False).update(g, state)
    for k in g:
        assert_close(ul[k], um[k], TOL_STEP, k)
        assert_close(sl.mu[k], sm.mu[k], TOL_STEP, k)
        assert_close(sl.nu[k], sm.nu[k], TOL_STEP, k)
        if name == "slim" and sm.snr[k] is not None:
            assert_close(sl.snr[k], sm.snr[k], TOL_SNR, k)
    np.testing.assert_array_equal(sl.health.nonfinite.numpy(), sm.health.nonfinite.numpy())
    assert_close(sl.health.grad_sumsq, sm.health.grad_sumsq, LINE_SUMS, "grad_sumsq")
