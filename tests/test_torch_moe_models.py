"""The mixture-of-experts and hybrid families in the port (reduced
olmoe_1b_7b, qwen3_moe_30b_a3b and jamba_v01_52b) against the JAX package
on the CPU, from the JAX-initialised parameters carried across by
``repro_torch.convert``, in f32:

* the parameter trees (names, shapes, tree order, meta) at reduced and full
  size, and the full configs' ``param_count``;
* forward logits and the summed MoE aux loss, the loss and every leaf's
  gradient (1e-5 of each output's largest magnitude);
* Table-3 rules, second-moment savings, the SNR candidates (and the SNR
  values measured on one second-moment tree, 1e-4), and the megaplan
  groups of the full configs;
* one Adam step and one Table-3 SlimAdam step, with the 'jnp' backend and
  with the fused backend (whose kernels' plain twins run on the CPU), on
  the expert leaves ``(layers, experts, embed, mlp)`` among the rest (1e-5);
* legacy decode logits (olmoe and the jamba hybrid, 1e-4: a few layers of
  f32 reassociation) and the paged engine's greedy tokens for olmoe
  (equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, flat_numpy, jax_params
from repro.configs import get_config as jax_config
from repro.core import measure_tree_snr as jax_measure, rules_as_tree as jax_rules_as_tree, \
    second_moment_savings as jax_savings, table3_rules as jax_table3
from repro.core.labels import flatten_with_names as jflat
from repro.core.slim_adam import slim_adam as jax_slim_adam
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.kernels.megaplan import plan_megagroups as jax_plan
from repro.models import transformer as jtf
from repro.optim.adam import adamw as jax_adamw
from repro.serve import Engine as JaxEngine, Request as JaxRequest, ServeConfig as JaxServeConfig
from repro.train.loss import lm_loss as jax_lm_loss
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import measure_tree_snr, rules_as_tree, second_moment_savings, table3_rules
from repro_torch.core.labels import flatten_with_names
from repro_torch.core.slim_adam import slim_adam
from repro_torch.kernels import megaplan
from repro_torch.models import Transformer, forward
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw, apply_updates
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.train.loss import lm_loss

ARCHS = ("olmoe_1b_7b", "qwen3_moe_30b_a3b", "jamba_v01_52b")
TOL = 1e-5
DECODE = 1e-4
LR = 3e-3


def _port(arch):
    jcfg, jparams, jmeta, arrays = jax_params(seed=0, arch=arch)
    return jcfg, jparams, jmeta, get_reduced(arch), params_from_numpy(arrays, "cpu")


def _batch(vocab, seed=3):
    return JaxZipfLM(JaxDataConfig(vocab_size=vocab, seq_len=24, global_batch=2, seed=seed)).batch(1)


def test_registry_holds_the_moe_and_hybrid_families():
    assert set(ARCHS) <= set(ARCH_IDS)
    jamba = get_config("jamba_v01_52b")
    assert {(s.mixer, s.ffn) for s in jamba.pattern} == {("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")}
    assert {(s.mixer, s.ffn) for s in get_reduced("jamba_v01_52b").pattern} == {
        ("mamba", "dense"), ("attn", "moe"), ("mamba", "moe")}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_for_field(arch):
    from repro.configs import get_reduced as jax_reduced

    for mine, theirs in ((get_config(arch), jax_config(arch)), (get_reduced(arch), jax_reduced(arch))):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if f.name in ("dtype", "param_dtype"):
                assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
            elif f.name == "pattern":
                assert [(s.mixer, s.ffn) for s in a] == [(s.mixer, s.ffn) for s in b]
            else:
                assert a == b, (f.name, a, b)
        assert mine.moe_cfg() == type(mine.moe_cfg())(**dataclasses.asdict(theirs.moe_cfg()))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_and_counts_match_jax(arch):
    _, _, jmeta, arrays = jax_params(seed=0, arch=arch)
    model = Transformer(get_reduced(arch), device="cpu")
    assert list(model.names) == list(arrays)
    assert [tuple(p.shape) for p in model.params.values()] == [a.shape for a in arrays.values()]
    assert ([dataclasses.astuple(m) for m in model.meta.values()]
            == [dataclasses.astuple(m) for _, m in jflat(jmeta)[0]])
    jfull, jfull_meta = jax_config(arch).abstract()
    specs = dict(flatten_with_names(get_config(arch).specs()))
    assert [(n, s.shape) for n, s in specs.items()] == [(n, tuple(p.shape)) for n, p in jflat(jfull)[0]]
    assert ([dataclasses.astuple(s.meta()) for s in specs.values()]
            == [dataclasses.astuple(m) for _, m in jflat(jfull_meta)[0]])
    assert get_config(arch).param_count() == jax_config(arch).param_count()
    experts = [n for n, s in specs.items() if s.axes[:2] == ("layers", "experts")]
    assert experts and all(len(specs[n].shape) == 4 for n in experts)
    if arch == "olmoe_1b_7b":
        assert get_config(arch).param_count() == 6_919_096_320
        assert dataclasses.replace(get_config(arch), n_layers=2).param_count() == 1_045_178_368
        assert specs["blocks.slot_0.moe.w_up"].shape == (16, 64, 2048, 1024)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, jparams, _, cfg, params = _port(arch)
    batch = _batch(cfg.vocab_size)
    jl, jaux = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(batch["tokens"])})
    tl, taux = forward(cfg, params, {"tokens": torch.from_numpy(batch["tokens"])})
    assert_close(tl.detach(), jl, TOL, "logits")
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, jparams, _, cfg, params = _port(arch)
    batch = _batch(cfg.vocab_size, seed=4)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, jtf.forward),
        has_aux=True)(jparams)
    want = flat_numpy(jgrads)
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = lm_loss(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}, forward)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=TOL)
    assert list(grads) == list(want)
    for name, g in grads.items():
        assert_close(g.numpy(), want[name], TOL, name)
    assert any(".moe.router" in n and float(g.abs().max()) > 0 for n, g in grads.items())


def _nu(arrays, seed=11):
    """A second-moment-like tree: positive, a per-axis scale times
    lognormal noise, so candidates land on both sides of the cutoff."""
    rng = np.random.default_rng(seed)
    nu = {}
    for k, a in arrays.items():
        scale = np.ones(a.shape)
        for axis, n in enumerate(a.shape):
            shape = [1] * a.ndim
            shape[axis] = n
            scale = scale * np.exp(rng.standard_normal(shape) * rng.uniform(0.0, 1.5))
        nu[k] = (1e-4 * scale * np.exp(0.3 * rng.standard_normal(a.shape))).astype(np.float32)
    return nu


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_savings_and_snr_candidates_match_jax(arch):
    _, jparams, jmeta, arrays = jax_params(seed=0, arch=arch)
    params = params_from_numpy(arrays, "cpu")
    meta = Transformer(get_reduced(arch), device="cpu").meta
    rules = table3_rules(meta)
    assert rules == {k: v for k, v in jax_table3(jmeta).items()}
    assert any(r for n, r in rules.items() if ".moe.w_" in n)
    assert second_moment_savings(params, meta, rules) == jax_savings(jparams, jmeta, jax_table3(jmeta))
    jm = dict(jflat(jmeta)[0])
    assert {n: dict(m.candidate_ks()) for n, m in meta.items()} == {n: dict(m.candidate_ks()) for n, m in jm.items()}
    nu = _nu(arrays)
    jnu = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams), [jnp.asarray(nu[k]) for k in arrays])
    want = jax_measure(jnu, jmeta, backend="jnp")
    for backend in ("jnp", "fused"):
        got = measure_tree_snr({k: torch.from_numpy(v) for k, v in nu.items()}, meta, backend=backend)
        assert list(got) == list(want)
        for name, by_k in want.items():
            assert set(got[name]) == set(by_k), name
            for label, v in by_k.items():
                np.testing.assert_allclose(float(got[name][label]), float(v), rtol=1e-4, err_msg=f"{name} {label}")
    # full size: savings and the fused backend's megaplan groups
    jfull, jfull_meta = jax_config(arch).abstract()
    specs = dict(flatten_with_names(get_config(arch).specs()))
    fmeta = {k: s.meta() for k, s in specs.items()}
    assert second_moment_savings(specs, fmeta, table3_rules(fmeta)) == jax_savings(jfull, jfull_meta,
                                                                                    jax_table3(jfull_meta))
    for jr, r in (({}, {}), (jax_table3(jfull_meta), table3_rules(fmeta))):
        jdims = jax.tree_util.tree_leaves(jax_rules_as_tree(jr, jfull, jfull_meta),
                                          is_leaf=lambda x: isinstance(x, tuple))
        jleaves = jax.tree_util.tree_leaves(jfull)
        wplan = jax_plan([p.shape for p in jleaves], [p.dtype for p in jleaves], jdims)
        gplan = megaplan.plan_megagroups([s.shape for s in specs.values()], [torch.float32] * len(specs),
                                         list(rules_as_tree(r, specs, fmeta).values()))
        assert gplan.jnp_idx == wplan.jnp_idx == ()
        assert [(g.kind, g.batch, g.rows, g.cols, g.axis) for g in gplan.groups] == \
            [(g.kind, g.batch, g.rows, g.cols, g.axis) for g in wplan.groups]


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("name", ["adam", "slim"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_optimizer_step_matches_jax(arch, name, backend):
    jcfg, jparams, jmeta, cfg, params = _port(arch)
    meta = Transformer(cfg, device="cpu").meta
    if name == "adam":
        jtx, ttx = jax_adamw(LR, backend="jnp"), adamw(LR, backend=backend)
    else:
        jtx = jax_slim_adam(LR, jax_rules_as_tree(jax_table3(jmeta), jparams, jmeta), backend="jnp")
        ttx = slim_adam(LR, rules_as_tree(table3_rules(meta), params, meta), backend=backend)
    rng = np.random.default_rng(7)
    g = {k: (0.05 * rng.standard_normal(tuple(p.shape))).astype(np.float32) for k, p in params.items()}
    jgrads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams), [jnp.asarray(g[k]) for k in params])
    jupd, jstate = jtx.update(jgrads, jtx.init(jparams), jparams)
    with torch.no_grad():
        tupd, tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, ttx.init(params), params)
        apply_updates(params, tupd)
    for k, u in flat_numpy(jupd).items():
        assert_close(tupd[k], u, TOL, f"update {k}")
    j_inner = [s for s in jstate.inner_states if hasattr(s, "nu")][0]
    t_inner = [s for s in tstate.inner_states if hasattr(s, "nu")][0]
    for moment in ("mu", "nu"):
        for k, v in flat_numpy(getattr(j_inner, moment)).items():
            assert tuple(getattr(t_inner, moment)[k].shape) == v.shape, k
            assert_close(getattr(t_inner, moment)[k], v, TOL, f"{moment} {k}")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "jamba_v01_52b"])
def test_legacy_decode_logits_match_jax(arch):
    jcfg, jparams, _, cfg, params = _port(arch)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 6), dtype=np.int32)
    jcache = jtf.init_decode_cache(jcfg, 3, 16, dtype=jnp.float32)
    tcache = ttf.init_decode_cache(cfg, 3, 16, torch.float32)
    for t in range(tokens.shape[1]):
        jl, jcache = jtf.decode_step(jcfg, jparams, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = ttf.decode_step(cfg, params, tcache, torch.from_numpy(tokens[:, t:t + 1]))
        assert_close(tl, jl, DECODE, f"step {t}")
    assert tcache.step == tokens.shape[1]


def test_paged_engine_tokens_match_the_jax_engine():
    jcfg, jparams, _, cfg, params = _port("olmoe_1b_7b")
    assert ttf.supports_paged(cfg) and not ttf.supports_paged(get_reduced("jamba_v01_52b"))
    kw = dict(max_seq=32, max_new_tokens=4, max_slots=2, page_size=8)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32) for n in rng.integers(3, 12, 4)]
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jrids = [jeng.submit(JaxRequest(prompt=p)) for p in prompts]
    jdone = jeng.run_until_drained()
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    rids = [eng.submit(Request(prompt=p)) for p in prompts]
    done = eng.run_until_drained()
    for jr, r in zip(jrids, rids):
        np.testing.assert_array_equal(done[r].tokens, jdone[jr].tokens)
    assert eng.metrics().admitted == len(prompts) > kw["max_slots"]


@pytest.mark.parametrize("arch,legacy", [("olmoe_1b_7b", False), ("jamba_v01_52b", True)])
def test_serve_cli_serves_the_moe_and_hybrid_families(arch, legacy, capsys):
    from repro_torch.serve.__main__ import main as serve_cli

    out = serve_cli(["--arch", arch, "--device", "cpu", "--requests", "2", "--new-tokens", "3"])
    text = capsys.readouterr().out
    assert ("legacy loop" in text) == legacy and f"arch={arch}_reduced" in text
    if legacy:
        assert out.shape == (2, 8 + 3)
    else:
        assert all(len(c.tokens) == 3 and c.finish_reason == "length" for c in out.values())


def test_launch_cli_trains_reduced_olmoe_on_the_cpu(capsys):
    from repro_torch.launch.train import main as launch_main

    launch_main(["--arch", "olmoe_1b_7b", "--reduced", "--device", "cpu", "--steps", "3", "--seq", "16",
                 "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses)), out
