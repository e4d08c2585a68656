"""The paper's baseline optimizers in the port against the JAX package, on the
CPU, from the same numpy parameters and gradients:

* the four baseline rule sets (AdaLayer, AdaLayer-LN-TL, Adam-mini v1 and
  v2) equal the JAX package's on full and reduced gpt_small, smollm_135m,
  falcon_mamba_7b and ResNet-18, with equal second-moment savings;
* 3 steps of each of the 12 ``make_optimizer`` names against the JAX
  package's 'jnp' backend, on reduced gpt_small, falcon_mamba_7b,
  smollm_135m and ResNet-18: updates and every state tensor within 1e-5 of
  each tensor's largest magnitude, the same state leaf names and shapes.
  The Adam/SlimAdam family also runs on the port's fused backend (the
  kernels' plain twins on the CPU) and its per-leaf route;
* ``multi_steps`` against the mean gradient and the JAX wrapper, and
  SlimAdam without its first moment on both backends;
* the port's megaplan puts every leaf of each baseline rule set on full
  gpt_small and ResNet-18 into a kernel group. The JAX planner sends some
  of them to jnp for the TPU's VMEM, so groups are not compared with JAX's;
* the trainer's registry, its rejections, and short loss curves.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_params
from repro.configs import get_config as jax_config, get_reduced as jax_reduced
from repro.core import baselines as jax_baselines, rules_as_tree as jax_rules_as_tree, \
    second_moment_savings as jax_savings, table3_rules as jax_table3
from repro.core.labels import flatten_with_names as jax_flatten
from repro.core.slim_adam import scale_by_slim_adam as jax_scale_by_slim_adam
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.models import resnet as jax_resnet
from repro.models.common import abstract_params as jax_abstract_params, meta_tree as jax_meta_tree
from repro.optim import adamw as jax_adamw, apply_updates as jax_apply_updates
from repro.optim.base import multi_steps as jax_multi_steps
from repro.train import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from repro.train import trainer as jax_trainer
from repro_torch.checkpoint import named_leaves
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import baselines, rules_as_tree, second_moment_savings, table3_rules
from repro_torch.core.labels import flatten_with_names
from repro_torch.core.slim_adam import scale_by_slim_adam
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.kernels import megaplan
from repro_torch.models import ResNet, ResNetConfig, Transformer
from repro_torch.optim import adamw, apply_updates, fused, multi_steps
from repro_torch.train import GuardConfig, Trainer, TrainerConfig, find_adam_nu, find_step_health
from repro_torch.train.guard import find_slim_snr, strip_step_health
from repro_torch.train.trainer import OPTIMIZERS, _SLIM_FAMILY, make_optimizer, slim_rule_dims

LR = 3e-3
TOL = 1e-5
RULE_SETS = ("adalayer_rules", "adalayer_ln_tl_rules", "adam_mini_v1_rules", "adam_mini_v2_rules")
RESNET_REDUCED = dict(stages=(1, 1), width=8, classes=10)


def _model(arch, full):
    """(JAX abstract params, JAX meta, port specs {name: ParamSpec}, port meta)."""
    if arch == "resnet18":
        kw = {} if full else RESNET_REDUCED
        jspec = jax_resnet.ResNetConfig(**kw).specs()
        jparams, jmeta = jax_abstract_params(jspec), jax_meta_tree(jspec)
        tspec = ResNetConfig(**kw).specs()
    else:
        jparams, jmeta = (jax_config(arch) if full else jax_reduced(arch)).abstract()
        tspec = (get_config(arch) if full else get_reduced(arch)).specs()
    specs = dict(flatten_with_names(tspec))
    return jparams, jmeta, specs, {k: s.meta() for k, s in specs.items()}


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ["gpt_small", "smollm_135m", "falcon_mamba_7b", "resnet18"])
@pytest.mark.parametrize("rule_set", RULE_SETS)
def test_baseline_rules_and_savings_match_jax(rule_set, arch, full):
    jparams, jmeta, specs, meta = _model(arch, full)
    want = getattr(jax_baselines, rule_set)(jmeta)
    got = getattr(baselines, rule_set)(meta)
    assert got == want
    assert second_moment_savings(specs, meta, got) == jax_savings(jparams, jmeta, want)


@pytest.mark.parametrize("model", ["gpt_small", "resnet18"])
@pytest.mark.parametrize("rule_set", RULE_SETS + ("table3_rules",))
def test_baseline_plans_put_every_leaf_in_a_kernel_group(rule_set, model):
    _, _, specs, meta = _model(model, True)
    rules = table3_rules(meta) if rule_set == "table3_rules" else getattr(baselines, rule_set)(meta)
    dims = rules_as_tree(rules, specs, meta)
    plan = megaplan.plan_megagroups([s.shape for s in specs.values()], [torch.float32] * len(specs),
                                    [dims[k] for k in specs])
    assert plan.jnp_idx == ()
    assert sorted(s.index for g in plan.groups for s in g.segments) == list(range(len(specs)))
    shapes = [(g.kind, g.batch, g.rows, g.cols) for g in plan.groups]
    if (rule_set, model) == ("adalayer_rules", "gpt_small"):
        # the embedding as one 38.6 M-element line
        assert ("minor", 1, 1, 50304 * 768) in shapes
    if (rule_set, model) == ("table3_rules", "resnet18"):
        assert [g.kind for g in plan.groups] == ["dense"] + ["major"] * 9


# -- 3 steps of every optimizer against the JAX package's 'jnp' backend ----------


def _snr_rules(meta_items):
    """A rule set for 'slim_snr' that differs from Table 3: each matrix's fan_out."""
    return {name: m.candidate_ks().get("fan_out") for name, m in meta_items}


def _grads(arrays, step):
    rng = np.random.default_rng(7 + step)
    # step 0 trips the global-norm clip, later steps do not
    return {k: (rng.standard_normal(a.shape) * (0.05 if step else 1.0)).astype(np.float32)
            for k, a in arrays.items()}


# The models the 3-step comparison runs on, all reduced: gpt_small, and the
# leaves of the other families (Mamba-1, a GQA decoder, convolutions).
THREE_STEP_MODELS = ("gpt_small", "falcon_mamba_7b", "smollm_135m", "resnet18")


@functools.lru_cache(maxsize=None)
def _jax_model(model):
    """(JAX params, JAX meta, {dotted name: numpy array}) of a reduced model
    from seed 1."""
    if model == "resnet18":
        jparams, jmeta = jax_resnet.ResNetConfig(**RESNET_REDUCED).init(jax.random.PRNGKey(1))
        return jparams, jmeta, {n: np.asarray(x) for n, x in jax_flatten(jparams)[0]}
    _, jparams, jmeta, arrays = jax_params(seed=1, arch=model)
    return jparams, jmeta, arrays


def _port_model(model):
    if model == "resnet18":
        return ResNet(ResNetConfig(**RESNET_REDUCED), device="cpu")
    return Transformer(get_reduced(model), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(name, model="gpt_small"):
    """The JAX package's 3 steps of ``name`` ('jnp' backend) on a reduced
    model: per step, {name: update} and [(state leaf name, array)]."""
    jparams, jmeta, arrays = _jax_model(model)
    rules = _snr_rules(jax_flatten(jmeta)[0]) if name == "slim_snr" else None
    jtx = jax_trainer.make_optimizer(name, LR, jparams, jmeta, rules=rules, backend="jnp")
    state = jtx.init(jparams)
    update = jax.jit(jtx.update)
    treedef = jax.tree_util.tree_structure(jparams)
    out = []
    for step in range(3):
        g = _grads(arrays, step)
        upd, state = update(jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g[k]) for k in arrays]), state,
                            jparams)
        jparams = jax_apply_updates(jparams, upd)
        out.append(({n: np.asarray(x) for n, x in jax_flatten(upd)[0]},
                    [(n, np.asarray(x)) for n, x in jax_flatten(state)[0]]))
    return out


def _routes(name):
    if name == "adam" or name in _SLIM_FAMILY:
        return ["jnp", "fused", "per_leaf"]
    return ["jnp"]


@pytest.mark.parametrize("model,name,route", [
    pytest.param(m, n, r, id=f"{n}-{r}" if m == "gpt_small" else f"{n}-{r}-{m}")
    for m in THREE_STEP_MODELS for n in OPTIMIZERS for r in _routes(n)])
def test_three_steps_match_jax(model, name, route):
    _, _, arrays = _jax_model(model)
    meta = _port_model(model).meta
    params = params_from_numpy(arrays, "cpu")
    assert list(params) == list(meta)
    rules = _snr_rules(meta.items()) if name == "slim_snr" else None
    tx = make_optimizer(name, LR, params, meta, rules=rules, backend="jnp" if route == "jnp" else "fused",
                        megakernel=route != "per_leaf")
    state = tx.init(params)
    for step, (want_u, want_state) in enumerate(_jax_run(name, model)):
        with torch.no_grad():
            upd, state = tx.update({k: torch.from_numpy(v) for k, v in _grads(arrays, step).items()}, state, params)
            apply_updates(params, upd)
        for k, u in want_u.items():
            assert_close(upd[k], u, TOL, f"step {step} update {k}")
        got_state = named_leaves(state)
        assert [(n, x.shape) for n, x in want_state] == [(n, tuple(x.shape)) for n, x in got_state]
        for (n, want), (_, got) in zip(want_state, got_state):
            assert str(got.dtype) == f"torch.{want.dtype}", n
            assert_close(got, want, TOL, f"step {step} state {n}")


def test_registry_matches_jax():
    assert OPTIMIZERS == jax_trainer.OPTIMIZERS and _SLIM_FAMILY == jax_trainer._SLIM_FAMILY
    _, jparams, jmeta, arrays = jax_params(seed=1)
    meta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    params = params_from_numpy(arrays, "cpu")
    for name in OPTIMIZERS:
        if name == "slim_snr":
            continue
        want = jax_trainer.slim_rule_dims(name, jparams, jmeta)
        got = slim_rule_dims(name, params, meta)
        if want is None:
            assert got is None, name
        else:
            leaves = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple))
            assert list(got.values()) == [tuple(d) for d in leaves], name
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adamw", LR, params, meta)


@pytest.mark.parametrize("name", [n for n in OPTIMIZERS if n != "adam" and n not in _SLIM_FAMILY])
def test_emit_flags_are_rejected_outside_their_family(name):
    _, jparams, jmeta, arrays = jax_params(seed=1)
    meta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    params = params_from_numpy(arrays, "cpu")
    for flag in ("emit_health", "emit_snr"):
        with pytest.raises(ValueError, match=flag):
            jax_trainer.make_optimizer(name, LR, jparams, jmeta, **{flag: True})
        with pytest.raises(ValueError, match=flag):
            make_optimizer(name, LR, params, meta, **{flag: True})
    assert find_adam_nu(make_optimizer(name, LR, params, meta).init(params)) is None


# -- multi_steps and the moment-less SlimAdam --------------------------------------


def test_multi_steps_matches_the_mean_gradient_and_jax():
    k = 3
    _, jparams, _, arrays = jax_params(seed=1)
    jtx = jax_multi_steps(jax_adamw(LR), k)
    jstate = jtx.init(jparams)
    treedef = jax.tree_util.tree_structure(jparams)
    params = params_from_numpy(arrays, "cpu")
    tx = multi_steps(adamw(LR, emit_health=True), k)
    state = tx.init(params)
    grads = [_grads(arrays, i + 1) for i in range(k)]
    for i, g in enumerate(grads):
        jupd, jstate = jtx.update(jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g[n]) for n in arrays]),
                                  jstate, jparams)
        with torch.no_grad():
            upd, state = tx.update({n: torch.from_numpy(x) for n, x in g.items()}, state, params)
        assert int(state.mini_step) == int(jstate.mini_step) == (i + 1) % k
        for n, u in jax_flatten(jupd)[0]:
            assert_close(upd[n], np.asarray(u), TOL, f"micro-step {i} update {n}")
        if i < k - 1:
            assert all(not bool(u.any()) for u in upd.values())
            assert find_step_health(state) is None
        jnamed = [(n, np.asarray(x)) for n, x in jax_flatten(jstate)[0]]
        tnamed = named_leaves(strip_step_health(state))
        assert [n for n, _ in jnamed] == [n for n, _ in tnamed]
        for (n, want), (_, got) in zip(jnamed, tnamed):
            assert_close(got, want, TOL, f"micro-step {i} state {n}")
    # The last micro-step applied the inner optimizer to the mean gradient,
    # summed in micro-step order (Adam's first step is g / (|g| + eps): a
    # rounding difference in an entry near eps moves it visibly).
    inner = adamw(LR)
    mean = {n: torch.zeros(a.shape) for n, a in arrays.items()}
    for g in grads:
        mean = {n: m + torch.from_numpy(g[n]) / k for n, m in mean.items()}
    with torch.no_grad():
        want, _ = inner.update(mean, inner.init(params), params)
    for n in arrays:
        assert_close(upd[n], want[n].numpy(), TOL, f"mean-gradient update {n}")
    assert find_step_health(state) is not None and find_adam_nu(state) is not None
    assert find_slim_snr(state) is None


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_slim_without_first_moment_matches_jax(backend, monkeypatch):
    """Both backends run the per-leaf plain math (the fused megaplan is
    never entered), as the JAX package's fused backend does."""
    _, jparams, jmeta, arrays = jax_params(seed=1)
    meta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    params = params_from_numpy(arrays, "cpu")
    jtx = jax_scale_by_slim_adam(jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta), use_first_moment=False)
    tx = scale_by_slim_adam(rules_as_tree(table3_rules(meta), params, meta), use_first_moment=False,
                            backend=backend)
    monkeypatch.setattr(fused, "slim_tree_update", None)
    jstate, state = jtx.init(jparams), tx.init(params)
    assert jstate.mu is None and state.mu is None
    treedef = jax.tree_util.tree_structure(jparams)
    for step in range(3):
        g = _grads(arrays, step)
        jupd, jstate = jtx.update(jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g[n]) for n in arrays]),
                                  jstate, jparams)
        upd, state = tx.update({n: torch.from_numpy(x) for n, x in g.items()}, state, params)
        assert state.mu is None
        for n, u in jax_flatten(jupd)[0]:
            assert_close(upd[n], np.asarray(u), TOL, f"step {step} update {n}")
        for n, v in jax_flatten(jstate.nu)[0]:
            assert_close(state.nu[n], np.asarray(v), TOL, f"step {step} nu {n}")


# -- the trainer -------------------------------------------------------------------

DATA = dict(vocab_size=211, seq_len=32, global_batch=4, seed=5)


@pytest.mark.parametrize("name", ["adalayer", "adam_mini_v2", "adafactor_v2", "sm3", "lion", "sgdm"])
def test_trainer_loss_curve_matches_jax(name):
    jcfg, _, _, arrays = jax_params(seed=0)
    jtr = JaxTrainer(jcfg, name, LR, JaxZipfLM(JaxDataConfig(**DATA)),
                     JaxTrainerConfig(total_steps=4, log_every=1, seed=0, backend="jnp"))
    jtr.run()
    tr = Trainer(get_reduced("gpt_small"), name, LR, ZipfLM(DataConfig(**DATA)),
                 TrainerConfig(total_steps=4, log_every=1, seed=0, backend="fused", measure_snr=True,
                               snr_early_every=2), device="cpu")
    tr.model.load_params(params_from_numpy(arrays, "cpu"))
    tr.run()
    want = [m["loss"] for m in jtr.metrics_log]
    got = [m["loss"] for m in tr.metrics_log]
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # SNR is measured for the Adam/slim family only
    assert (tr.snr.count > 0) == (name in _SLIM_FAMILY)


def test_guarded_trainer_runs_a_baseline_on_the_grad_norm():
    """Outside the Adam/slim family the guarded step has no in-pass health
    and decides on the finiteness of the gradient norm."""
    tr = Trainer(get_reduced("gpt_small"), "lion", LR, ZipfLM(DataConfig(**DATA)),
                 TrainerConfig(total_steps=3, log_every=1, guard=GuardConfig()), device="cpu")
    last = tr.run()
    assert tr.step == 3 and np.isfinite(last["loss"]) and last["step_skipped"] == 0.0
