"""AdamW and SlimAdam (Table-3 rules) in the port — both its 'fused' backend
(for CPU tensors the megaplan runs the kernels' plain twins) and its 'jnp'
backend — against the JAX package's 'jnp' backend for 3 steps from the same
parameters and gradients. State shapes and second-moment savings must be
identical; updates and moments agree within 1e-5 (relative to each
tensor's largest magnitude: f32 reassociation in sums and the global norm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_numpy, jax_params
from repro.configs import get_config as jax_config
from repro.core import rules_as_tree as jax_rules_as_tree, second_moment_savings as jax_savings, \
    table3_rules as jax_table3
from repro.core.slim_adam import slim_adam as jax_slim_adam
from repro.optim.adam import adamw as jax_adamw
from repro.optim.base import apply_updates as jax_apply_updates
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import rules_as_tree, second_moment_savings, table3_rules
from repro_torch.core.labels import flatten_with_names
from repro_torch.core.slim_adam import slim_adam
from repro_torch.kernels import megaplan
from repro_torch.models import Transformer
from repro_torch.optim import adamw, apply_updates

LR = 3e-3
TOL = 1e-5


def _optimizers(name, backend, jparams, jmeta, tparams, tmeta):
    if name == "adam":
        return jax_adamw(LR, backend="jnp"), adamw(LR, backend=backend)
    jdims = jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta)
    tdims = rules_as_tree(table3_rules(tmeta), tparams, tmeta)
    return jax_slim_adam(LR, jdims, backend="jnp"), slim_adam(LR, tdims, backend=backend)


@pytest.mark.parametrize("backend", ["fused", "jnp"])
@pytest.mark.parametrize("name", ["adam", "slim"])
def test_three_steps_match_jax(name, backend):
    _, jparams, jmeta, arrays = jax_params(seed=1)
    tmeta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    tparams = params_from_numpy(arrays, "cpu")
    jtx, ttx = _optimizers(name, backend, jparams, jmeta, tparams, tmeta)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for j_inner, t_inner in zip(jstate.inner_states, tstate.inner_states):
        if hasattr(j_inner, "nu"):
            assert ({k: v.shape for k, v in flat_numpy(j_inner.nu).items()}
                    == {k: tuple(v.shape) for k, v in t_inner.nu.items()})
    rng = np.random.default_rng(7)
    jupdate = jax.jit(jtx.update)
    for step in range(3):
        g = {k: (rng.standard_normal(a.shape) * (0.05 if step else 1.0)).astype(np.float32)
             for k, a in arrays.items()}   # step 0 trips the global-norm clip, later steps do not
        jgrads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams),
                                              [jnp.asarray(g[k]) for k in arrays])
        jupd, jstate = jupdate(jgrads, jstate, jparams)
        jparams = jax_apply_updates(jparams, jupd)
        with torch.no_grad():
            tupd, tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tparams)
            apply_updates(tparams, tupd)
        for k, u in flat_numpy(jupd).items():
            assert_close(tupd[k], u, TOL, f"step {step} update {k}")
        j_inner = [s for s in jstate.inner_states if hasattr(s, "nu")][0]
        t_inner = [s for s in tstate.inner_states if hasattr(s, "nu")][0]
        assert int(t_inner.count) == int(j_inner.count) == step + 1
        for moment in ("mu", "nu"):
            for k, v in flat_numpy(getattr(j_inner, moment)).items():
                assert_close(getattr(t_inner, moment)[k], v, TOL, f"step {step} {moment} {k}")
    for k, p in flat_numpy(jparams).items():
        assert_close(tparams[k], p, TOL, k)


@pytest.mark.parametrize("full", [False, True])
def test_second_moment_savings_match_jax(full):
    if full:
        jparams, jmeta = jax_config("gpt_small").abstract()
        specs = dict(flatten_with_names(get_config("gpt_small").specs()))
        tparams, tmeta = specs, {k: s.meta() for k, s in specs.items()}
    else:
        _, jparams, jmeta, arrays = jax_params()
        tparams = params_from_numpy(arrays, "cpu")
        tmeta = Transformer(get_reduced("gpt_small"), device="cpu").meta
    want = jax_savings(jparams, jmeta, jax_table3(jmeta))
    got = second_moment_savings(tparams, tmeta, table3_rules(tmeta))
    assert got == want
    if full:
        assert got["saved_fraction"] == pytest.approx(0.99245, abs=5e-6)


def test_megaplan_groups_match_jax_on_full_gpt_small():
    """Table-3 rules on full-width gpt_small: the port plans the same
    groups, in the same leaf order, as the JAX package (no leaf exceeds the
    TPU's VMEM gate under these rules, so routes coincide too)."""
    from repro.kernels.megaplan import plan_megagroups as jax_plan

    jparams, jmeta = jax_config("gpt_small").abstract()
    jdims = [d for d in jax.tree_util.tree_leaves(
        jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta), is_leaf=lambda x: isinstance(x, tuple))]
    jleaves = jax.tree_util.tree_leaves(jparams)
    want = jax_plan([p.shape for p in jleaves], [p.dtype for p in jleaves], jdims)
    specs = dict(flatten_with_names(get_config("gpt_small").specs()))
    meta = {k: s.meta() for k, s in specs.items()}
    dims = rules_as_tree(table3_rules(meta), specs, meta)
    got = megaplan.plan_megagroups([s.shape for s in specs.values()], [torch.float32] * len(specs),
                                   list(dims.values()))
    assert got.jnp_idx == want.jnp_idx == ()
    assert [(g.kind, g.batch, g.rows, g.cols, g.axis) for g in got.groups] == \
        [(g.kind, g.batch, g.rows, g.cols, g.axis) for g in want.groups]
    assert [(g.kind, g.batch, g.rows, g.cols) for g in got.groups] == [
        ("dense", 1, 1574, 512), ("batched", 12, 768, 1536), ("minor", 1, 105600, 768),
        ("minor", 1, 9216, 3072)]
    for g, w in zip(got.groups, want.groups):
        assert [(s.index, s.offset, s.length) for s in g.segments] == \
            [(s.index, s.offset, s.length) for s in w.segments]
