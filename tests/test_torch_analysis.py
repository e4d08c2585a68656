"""The port's static contracts (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), and a seeded regression for every check, as
``tests/test_analysis.py`` seeds JAX's.

Held to the JAX package: the ``meta`` signatures and the golden file (all
119 keys, exactly), the kernel-call counts of a dry run against
``count_pallas_launches`` (exactly), the leaf routes of the 13 configs under
Table 3 and the baseline rule sets (exactly, less the leaves JAX's VMEM
gate declines), shardcheck's check count, and the guarded step under
``lr_scale`` 0.05 and ``grad_scale`` 0.5 (1e-5 of each parameter's largest
magnitude: the two packages sum the forward and backward in other orders),
and on equal gradients, in bf16 and f32, bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_params
from repro.analysis import kernelcheck as jax_kernelcheck
from repro.analysis import shardcheck as jax_shardcheck
from repro.analysis.jaxpr_tools import count_pallas_launches
from repro_torch.analysis import call_tools, kernelcheck, lint, races, registry, shardcheck, tracecheck
from repro_torch.analysis.report import PassResult
from repro_torch.kernels import build, megaplan

# An excerpt of the ptxas report of the H100 build (``-Xptxas=-v``), as
# build.py keeps it beside the library: a bf16 substitution (S1_), a
# cumulative stack and static shared memory, spills, an unsigned long long
# index type and a float4 argument.
PTXAS = """\
--- paged_attention.cu
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f818paged_cores_kernelI13__nv_bfloat16S1_Li128ELi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__caccf2de_18_paged_attention_cu_5ce215f818paged_cores_kernelI13__nv_bfloat16S1_Li128ELi64EEEvNS_6ParamsE
    56 bytes stack frame, 64 bytes spill stores, 92 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 56 bytes cumulative stack size
ptxas info    : Compile time = 512.313 ms
--- ssm_scan.cu
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__dce39ba2_11_ssm_scan_cu_d2e4a81714ssm_chunk_walkIfLi4ELb1ELb1EEEvNS_8ScanArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__dce39ba2_11_ssm_scan_cu_d2e4a81714ssm_chunk_walkIfLi4ELb1ELb1EEEvNS_8ScanArgsE
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size, 33792 bytes smem
--- ssm_scan_bwd.cu
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__defd8a60_15_ssm_scan_bwd_cu_9bb2733812ssm_bwd_walkI13__nv_bfloat16Li16EEEvNS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__defd8a60_15_ssm_scan_bwd_cu_9bb2733812ssm_bwd_walkI13__nv_bfloat16Li16EEEvNS_7BwdArgsE
    104 bytes stack frame, 120 bytes spill stores, 188 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 104 bytes cumulative stack size
--- slim_finalize.cu
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__a06203ec_16_slim_finalize_cu_4a89ab3320finalize_flat_kernelILi4ELb1ELi0EyLb1EEEvNS_8FlatArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__a06203ec_16_slim_finalize_cu_4a89ab3320finalize_flat_kernelILi4ELb1ELi0EyLb1EEEvNS_8FlatArgsE
    40 bytes stack frame, 40 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 40 bytes cumulative stack size
--- snr_stats.cu
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__ac3a4990_12_snr_stats_cu_aa46694d14snr_warp_linesI6float4Li2EEEvPKfNS_4OutsExxi' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__ac3a4990_12_snr_stats_cu_aa46694d14snr_warp_linesI6float4Li2EEEvPKfNS_4OutsExxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
--- mega_slim.cu
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b210880c_12_mega_slim_cu_03abbb5717slim_minor_kernelIfLb0ELb1ELb0ELb0ELb0EfLb1EEEvNS_8SlimArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__b210880c_12_mega_slim_cu_03abbb5717slim_minor_kernelIfLb0ELb1ELb0ELb0ELb0EfLb1EEEvNS_8SlimArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 1 barriers, 256 bytes smem
"""
KERNELS_OF_PTXAS = {"paged_cores_kernel": "paged_attention.cu", "ssm_chunk_walk": "ssm_scan.cu",
                    "ssm_bwd_walk": "ssm_scan_bwd.cu", "finalize_flat_kernel": "slim_finalize.cu",
                    "snr_warp_lines": "snr_stats.cu", "slim_minor_kernel": "mega_slim.cu"}


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------


def test_golden_file_equals_jaxs():
    port = json.loads(kernelcheck.GOLDEN_PATH.read_text())
    jax_golden = json.loads(jax_kernelcheck.GOLDEN_PATH.read_text())
    assert len(port) == 119 and port == jax_golden


def test_meta_signatures_equal_the_golden_file():
    assert registry.all_signatures() == json.loads(kernelcheck.GOLDEN_PATH.read_text())


def test_registry_matrix_matches_jaxs():
    from repro.analysis import registry as jreg

    assert [e.name for e in registry.ENTRIES] == [e.name for e in jreg.ENTRIES]
    for e, je in zip(registry.ENTRIES, jreg.ENTRIES):
        assert (e.kind, e.arg_roles) == (je.kind, je.arg_roles), e.name
        assert [v.name for v in e.variants] == [v.name for v in je.variants], e.name
        assert [(c.label, c.shape, c.axis, c.kept, c.red) for c in e.cases] == \
            [(c.label, c.shape, c.axis, c.kept, c.red) for c in je.cases], e.name


def test_registry_feeds_roofline_gates():
    from repro.analysis import registry as jreg

    lines, oversize = registry.snr_stat_lines()
    assert (lines, oversize) == jreg.snr_stat_lines() == ({"psum": 3, "local": 2, "jnp": 2}, [])
    for name, extras in registry.health_stat_outputs():
        assert extras == [(2,)], (name, extras)


def test_every_cuda_kernel_belongs_to_a_wrapper():
    named = {s for e in registry.ENTRIES for s in e.symbols} | {s for v in registry.SCAN_SYMBOLS.values() for s in v}
    assert named == set(build.kernel_names()) == set(kernelcheck.RESOURCES)


# ---------------------------------------------------------------------------
# Kernel calls of a dry run against count_pallas_launches
# ---------------------------------------------------------------------------

# tests/test_megaplan.py's mixed tree: one leaf per regime, a bf16 leaf in
# the minor group, an interleaved-K leaf, dense odd/scalar/vector leaves.
MIXED = {"minor_a": ((24, 16), (1,)), "minor_b": ((7, 16), (1,)), "bf16": ((9, 16), (1,)), "major": ((16, 24), (0,)),
         "batched": ((3, 8, 6, 4), (1,)), "inter": ((4, 6, 10), (0, 2)), "dense_odd": ((33, 5), ()),
         "scalar": ((), ()), "size1": ((1, 4), (1,)), "vec": ((37,), (0,))}


def _trees(tree: str):
    """({name: jax array}, {name: meta tensor}, {name: dims}) of a tree."""
    if tree == "mixed":
        dt = {k: jnp.bfloat16 if k == "bf16" else jnp.float32 for k in MIXED}
        jparams = {k: jnp.ones(s, dt[k]) for k, (s, _) in MIXED.items()}
        tparams = {k: torch.empty(s, dtype=torch.bfloat16 if k == "bf16" else torch.float32, device="meta")
                   for k, (s, _) in MIXED.items()}
        return jparams, tparams, {k: d for k, (_, d) in MIXED.items()}
    from repro.core import rules_as_tree as jax_rules_as_tree, table3_rules as jax_table3
    from repro_torch.configs import get_reduced
    from repro_torch.core import rules_as_tree, table3_rules

    jcfg, jp, jmeta, arrays = jax_params(0)
    tparams, meta = get_reduced("gpt_small").abstract()
    assert list(arrays) == list(tparams)
    dims = rules_as_tree(table3_rules(meta), tparams, meta)
    jdims = jax.tree.leaves(jax_rules_as_tree(jax_table3(jmeta), jp, jmeta), is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(d) for d in jdims] == [tuple(dims[k]) for k in tparams]
    return jp, tparams, {k: tuple(d) for k, d in zip(tparams, jdims)}


def _jax_dims(jparams, dims):
    if isinstance(jparams, dict) and set(jparams) == set(dims):
        return dims
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jparams), [dims[k] for k in dims])


def _optimizers(name: str, route: str, dims, jdims):
    from repro.core.slim_adam import scale_by_slim_adam as jax_slim
    from repro.optim import scale_by_adam as jax_adam
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.optim import scale_by_adam

    kw = {} if route == "mega" else dict(megakernel=False, bucket_min_size=0)
    if name == "slim":
        return jax_slim(jdims, backend="fused", **kw), scale_by_slim_adam(dims, backend="fused", **kw)
    return jax_adam(backend="fused", **kw), scale_by_adam(backend="fused", **kw)


@pytest.mark.parametrize("tree", ["mixed", "gpt_small"])
@pytest.mark.parametrize("route", ["mega", "per_leaf"])
@pytest.mark.parametrize("name", ["slim", "adam"])
def test_kernel_calls_equal_pallas_launches(name, route, tree):
    jparams, tparams, dims = _trees(tree)
    jtx, ttx = _optimizers(name, route, dims, _jax_dims(jparams, dims))
    jg = jax.tree.map(jnp.ones_like, jparams)
    want = count_pallas_launches(lambda gg, ss: jtx.update(gg, ss, jparams), jg, jtx.init(jparams))
    tg = {k: torch.empty_like(p) for k, p in tparams.items()}
    got = call_tools.count_kernel_calls(lambda gg, ss: ttx.update(gg, ss, tparams), tg, ttx.init(tparams))
    assert got == want > 0
    if route == "mega" and name == "slim":
        shapes = [tuple(p.shape) for p in tparams.values()]
        plan = megaplan.plan_megagroups(shapes, [p.dtype for p in tparams.values()], [dims[k] for k in tparams])
        assert got == len(plan.groups)


@pytest.mark.parametrize("bucket_min_size,launches", [(64, 2), (65, 1)])
def test_bucket_boundary_calls_equal_pallas_launches(bucket_min_size, launches):
    from repro.optim import scale_by_adam as jax_adam
    from repro_torch.optim import scale_by_adam

    jparams = {"a": jnp.ones((8, 8)), "b": jnp.ones((8, 8))}
    jtx = jax_adam(backend="fused", megakernel=False, bucket_min_size=bucket_min_size)
    want = count_pallas_launches(lambda gg, ss: jtx.update(gg, ss), jparams, jtx.init(jparams))
    tparams = {k: torch.empty((8, 8), device="meta") for k in jparams}
    ttx = scale_by_adam(backend="fused", megakernel=False, bucket_min_size=bucket_min_size)
    got = call_tools.count_kernel_calls(lambda gg, ss: ttx.update(gg, ss), dict(tparams), ttx.init(tparams))
    assert got == want == launches


def test_dry_run_takes_meta_tensors_only():
    from repro_torch.kernels import snr_stats

    with pytest.raises(ValueError, match="meta"):
        call_tools.count_kernel_calls(snr_stats.snr_stats_batched, torch.ones(1, 2, 4), axis=1)
    v = torch.empty(2, 8, 128, device="meta")
    assert call_tools.kernel_call_counts(snr_stats.snr_stats_batched, v, axis=1) == {"snr_stats_batched": 1}
    assert call_tools.entry_signature(snr_stats.snr_stats_batched, v, axis=0) == [((2, 128), torch.float32)] * 2


# ---------------------------------------------------------------------------
# Leaf routes against JAX's VMEM gate
# ---------------------------------------------------------------------------

RULE_SETS = ("table3", "adalayer", "adalayer_ln_tl", "adam_mini_v1", "adam_mini_v2")
# The leaves JAX's strip_fits sends to jnp (their canonical line outruns 8
# MiB of VMEM at 5 f32 buffers) and the port's gate admits, by config and
# rule set: their count. Table 3 has none in any config.
DECLINED = {
    "falcon_mamba_7b": {"adalayer": 5, "adalayer_ln_tl": 4, "adam_mini_v1": 4},
    "jamba_v01_52b": {"adalayer": 58, "adalayer_ln_tl": 56, "adam_mini_v1": 56, "adam_mini_v2": 2},
    "qwen3_moe_30b_a3b": {"adalayer": 9, "adalayer_ln_tl": 7, "adam_mini_v1": 5},
    "olmoe_1b_7b": {"adalayer": 9, "adalayer_ln_tl": 7, "adam_mini_v1": 5},
    "command_r_35b": {"adalayer": 8, "adalayer_ln_tl": 7, "adam_mini_v1": 7, "adam_mini_v2": 2},
    "deepseek_67b": {"adalayer": 9, "adalayer_ln_tl": 7, "adam_mini_v1": 7, "adam_mini_v2": 2},
    "smollm_135m": {"adalayer": 4, "adalayer_ln_tl": 3, "adam_mini_v1": 3},
    "qwen15_32b": {"adalayer": 9, "adalayer_ln_tl": 7, "adam_mini_v1": 7, "adam_mini_v2": 2},
    "hubert_xlarge": {"adalayer": 7, "adalayer_ln_tl": 6, "adam_mini_v1": 4},
    "internvl2_26b": {"adalayer": 9, "adalayer_ln_tl": 7, "adam_mini_v1": 7, "adam_mini_v2": 2},
    "gpt_small": {"adalayer": 8, "adalayer_ln_tl": 7, "adam_mini_v1": 5, "adam_mini_v2": 1},
    "gpt_medium": {"adalayer": 8, "adalayer_ln_tl": 7, "adam_mini_v1": 5, "adam_mini_v2": 1},
    "vit_small": {"adalayer": 6, "adalayer_ln_tl": 6, "adam_mini_v1": 4},
}


def _rules(name: str):
    from repro.core import baselines as jb, table3_rules as jax_table3
    from repro_torch.core import baselines as tb, table3_rules

    if name == "table3":
        return jax_table3, table3_rules
    return getattr(jb, f"{name}_rules"), getattr(tb, f"{name}_rules")


@pytest.mark.parametrize("arch", list(DECLINED))
def test_leaf_routes_match_jax_but_its_vmem_gate(arch):
    """Every leaf of the full config routes as JAX's does, except the
    leaves whose line JAX's VMEM declines; the port's megaplan holds those
    too, and the launch difference is exactly the groups they form."""
    from repro.configs import get_config as jax_config
    from repro.core import rules_as_tree as jax_rules_as_tree
    from repro.core.labels import flatten_with_names as jax_flatten
    from repro.kernels import megaplan as jm
    from repro.kernels.ops import leaf_plan as jax_leaf_plan
    from repro.kernels.slim_update import PRECOND_BUFS
    from repro.kernels.tiling import strip_fits as jax_strip_fits
    from repro_torch.configs import get_config
    from repro_torch.core import rules_as_tree
    from repro_torch.kernels.ops import leaf_plan

    jabs, jmeta = jax_config(arch).abstract()
    jleaves = dict(jax_flatten(jabs)[0])
    params, meta = get_config(arch).abstract()
    assert list(jleaves) == list(params)
    names = list(params)
    declined = {}
    for rule_set in RULE_SETS:
        jrules, trules = _rules(rule_set)
        try:
            jd = jax.tree.leaves(jax_rules_as_tree(jrules(jmeta), jabs, jmeta), is_leaf=lambda x: isinstance(x, tuple))
        except ValueError:
            with pytest.raises(ValueError):
                rules_as_tree(trules(meta), params, meta)
            continue
        td = rules_as_tree(trules(meta), params, meta)
        assert [tuple(d) for d in jd] == [tuple(td[k]) for k in names]
        out = []
        for i, (name, d) in enumerate(zip(names, jd)):
            jplan = jax_leaf_plan(jleaves[name].shape, jnp.float32, tuple(d))
            tplan = leaf_plan(tuple(params[name].shape), torch.float32, tuple(d))
            if jplan.route != tplan.route:
                assert (jplan.route, tplan.route) == ("jnp", "slim"), name
                assert not jax_strip_fits(tplan.cn.cols if tplan.cn.axis == 1 else tplan.cn.rows, PRECOND_BUFS)
                out.append(i)
            elif tplan.route == "slim":
                assert tuple(tplan.cn) == tuple(jplan.cn), name
        jp = jm.plan_megagroups([jleaves[k].shape for k in names], [jnp.float32] * len(names), [tuple(d) for d in jd])
        tp = megaplan.plan_megagroups([tuple(params[k].shape) for k in names], [torch.float32] * len(names),
                                      [tuple(td[k]) for k in names])
        assert tp.jnp_idx == tuple(i for i in jp.jnp_idx if i not in out)
        jkeys = {(g.kind, g.batch, g.red) for g in jp.groups if g.kind != "dense"}
        tkeys = {(g.kind, g.batch, g.red) for g in tp.groups if g.kind != "dense"}
        assert [g.kind for g in tp.groups].count("dense") == [g.kind for g in jp.groups].count("dense")
        new_keys = {megaplan._slim_key(leaf_plan(tuple(params[names[i]].shape), torch.float32, tuple(jd[i])).cn)
                    for i in out}
        assert tkeys == jkeys | new_keys
        assert len(tp.groups) - len(jp.groups) == len(new_keys - jkeys)
        for g in tp.groups:   # a group JAX also has keeps its leaves, plus the declined ones of its key
            jg = [x for x in jp.groups if x.kind == g.kind and (g.kind == "dense" or (x.batch, x.red) == (g.batch, g.red))]
            want = {s.index for s in jg[0].segments} if jg else set()
            assert {s.index for s in g.segments} - want <= set(out)
        if out:
            declined[rule_set] = len(out)
    assert declined == DECLINED[arch]


# ---------------------------------------------------------------------------
# shardcheck and the guarded step against JAX
# ---------------------------------------------------------------------------


def test_shardcheck_matches_jax():
    got, want = shardcheck.run(), jax_shardcheck.run()
    assert not got.findings, [str(f) for f in got.findings]
    assert got.checks == want.checks > 1000
    assert got.detail == want.detail


def test_guarded_step_matches_jax():
    """One guarded Table-3 SlimAdam step on reduced gpt_small from JAX's
    init, lr_scale 0.05 and grad_scale 0.5: every parameter within 1e-5 of
    its largest magnitude of JAX's, and its metrics' verdict the same."""
    from repro.core import rules_as_tree as jax_rules_as_tree, table3_rules as jax_table3
    from repro.core.slim_adam import slim_adam as jax_slim_adam
    from repro.train.step import make_train_step as jax_step
    from repro_torch.configs import get_reduced
    from repro_torch.core import rules_as_tree, table3_rules
    from repro_torch.core.slim_adam import slim_adam
    from repro_torch.models import Transformer
    from repro_torch.train.step import make_train_step

    jcfg, jp, jmeta, arrays = jax_params(0)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    controls = {"lr_scale": 0.05, "grad_scale": 0.5}
    jtx = jax_slim_adam(3e-3, jax_rules_as_tree(jax_table3(jmeta), jp, jmeta), emit_health=True)
    jnew, _, jm = jax.jit(jax_step(jcfg, jtx, guard=True))(
        jp, jtx.init(jp), {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        {k: jnp.asarray(v, jnp.float32) for k, v in controls.items()})
    model = Transformer(get_reduced("gpt_small"), device="cpu")
    model.load_params({k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
    ttx = slim_adam(3e-3, rules_as_tree(table3_rules(model.meta), model.params, model.meta), emit_health=True)
    _, tm = make_train_step(model, ttx, guard=True)(
        ttx.init(model.params), {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()},
        controls)
    assert float(tm["step_skipped"]) == float(jm["step_skipped"]) == 0.0
    from repro.core.labels import flatten_with_names as jax_flatten

    for name, leaf in jax_flatten(jnew)[0]:
        assert_close(model.params[name].detach().numpy(), np.asarray(leaf), 1e-5, name)


@pytest.mark.parametrize("dense,lr_scale,grad_scale", [(False, 0.05, 0.3), (False, 0.05, 0.5), (True, 0.05, 0.3),
                                                       (True, 0.3, 0.05)])
def test_guarded_step_matches_jax_on_equal_gradients(monkeypatch, dense, lr_scale, grad_scale):
    """The guarded step after its gradients, held to JAX's on bf16
    parameters bit for bit: both packages' steps get the same seeded
    gradients (exact in bf16), which their loss functions are swapped for,
    so that only the controls, SlimAdam's update (Table 3, or ``dense``:
    every leaf unreduced, Adam's form) and ``apply_updates`` decide the
    parameters. A control that is no bf16 number (0.3, 0.05) shows one
    rounded otherwise than JAX rounds it, and an f32 update rounded to bf16
    before the add shows a second rounding: in the Table-3 step at grad_scale
    0.3 both are seeded and must differ from JAX's. tracecheck's rule (``jax_rule`` with
    ``apply_updates``) is held to JAX's output the same way. Tolerance: none
    (equal bits). The two optimizers' f32 updates differ in their last bits
    (other orders of operations), which rounding to bf16 hides at these
    draws and scales: a Table-3 step at lr_scale 0.3 shows 3 elements one
    bf16 step apart, and the f32 step is ``test_guarded_step_matches_jax``'s."""
    import dataclasses

    import repro.train.step as jax_step_mod
    import repro_torch.train.step as step_mod
    from repro.core import rules_as_tree as jax_rules_as_tree, table3_rules as jax_table3
    from repro.core.labels import flatten_with_names as jax_flatten
    from repro.core.slim_adam import slim_adam as jax_slim_adam
    from repro_torch.configs import get_reduced
    from repro_torch.core import rules_as_tree, table3_rules
    from repro_torch.core.slim_adam import slim_adam
    from repro_torch.models import Transformer
    from repro_torch.optim.base import apply_updates

    jdt, tdt = jnp.bfloat16, torch.bfloat16
    jcfg, jp, jmeta, arrays = jax_params(0)
    jcfg = dataclasses.replace(jcfg, param_dtype=jdt)
    jp = jax.tree.map(lambda a: a.astype(jdt), jp)
    names = [n for n, _ in jax_flatten(jp)[0]]
    rng = np.random.default_rng(5)
    grads = {n: np.asarray(jnp.asarray(rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.01, jdt)
                           .astype(jnp.float32)) for n, leaf in jax_flatten(jp)[0]}

    def jax_loss(cfg, p, batch, fwd):   # d/dp = grads, exactly
        leaves = dict(jax_flatten(p)[0])
        loss = sum(jnp.sum(leaves[n].astype(jnp.float32) * grads[n]) for n in names)
        return loss, {"loss": loss}

    def port_grad_fn(model, **kw):
        return lambda batch: ({n: torch.from_numpy(grads[n].copy()).to(tdt) for n in names}, {})

    monkeypatch.setattr(jax_step_mod, "lm_loss", jax_loss)
    monkeypatch.setattr(step_mod, "make_grad_fn", port_grad_fn)
    controls = {"lr_scale": lr_scale, "grad_scale": grad_scale}
    jdims = jax_rules_as_tree(jax_table3(jmeta), jp, jmeta)
    if dense:
        jdims = jax.tree.map(lambda d: (), jdims, is_leaf=lambda x: isinstance(x, tuple))
    jtx = jax_slim_adam(3e-3, jdims, emit_health=True)
    tokens = jnp.zeros((2, 16), jnp.int32)
    jnew, _, jm = jax_step_mod.make_train_step(jcfg, jtx, guard=True)(
        jp, jtx.init(jp), {"tokens": tokens, "labels": tokens},
        {k: jnp.asarray(v, jnp.float32) for k, v in controls.items()})
    want = {n: torch.from_numpy(np.asarray(leaf.astype(jnp.float32))) for n, leaf in jax_flatten(jnew)[0]}

    def port_model():
        model = Transformer(dataclasses.replace(get_reduced("gpt_small"), param_dtype=tdt), device="cpu")
        model.load_params({k: torch.from_numpy(np.array(v)).to(tdt) for k, v in arrays.items()})
        dims = rules_as_tree(table3_rules(model.meta), model.params, model.meta)
        return model, slim_adam(3e-3, {k: () for k in dims} if dense else dims, emit_health=True)

    def port_step():
        model, ttx = port_model()
        _, tm = step_mod.make_train_step(model, ttx, guard=True)(ttx.init(model.params), {}, controls)
        assert float(tm["step_skipped"]) == float(jm["step_skipped"]) == 0.0
        return model

    def differing(params):
        return {n: c for n in names if (c := int((params[n].float() != want[n]).sum()))}

    model = port_step()
    if grad_scale == 0.3 and not dense:   # Adam's first update does not see the gradients' scale
        # Seeded: each of the two roundings the step once had moves bits.
        with monkeypatch.context() as mp:
            mp.setattr(step_mod, "scale_by_control", lambda tree, value: {k: t * float(value) for k, t in tree.items()})
            assert differing(port_step().params), "a control multiplied as a Python float went unseen"
        with monkeypatch.context() as mp:
            mp.setattr(step_mod, "apply_updates",
                       lambda params, updates: [p.add_(updates[k].to(p.dtype)) for k, p in params.items()])
            assert differing(port_step().params), "an update rounded to bf16 before the add went unseen"
    rule, rtx = port_model()
    with torch.no_grad():
        g = tracecheck.jax_rule(port_grad_fn(rule)(None)[0], grad_scale)
        updates, _ = rtx.update(g, rtx.init(rule.params), rule.params)
        apply_updates(rule.params, tracecheck.jax_rule(updates, lr_scale))
    for what, params in (("step", model.params), ("tracecheck rule", rule.params)):
        assert not differing(params), f"{what}: elements differing from JAX's guarded step: {differing(params)}"
        assert all(params[n].dtype == tdt for n in names)


# ---------------------------------------------------------------------------
# Seeded regressions, one per check
# ---------------------------------------------------------------------------


def test_ptxas_report_parses():
    rows = build.resource_report(PTXAS, KERNELS_OF_PTXAS)
    assert [(r.kernel, r.args) for r in rows] == [
        ("paged_cores_kernel", ("__nv_bfloat16", "__nv_bfloat16", 128, 64)),
        ("ssm_chunk_walk", ("float", 4, True, True)),
        ("ssm_bwd_walk", ("__nv_bfloat16", 16)),
        ("finalize_flat_kernel", (4, True, 0, "unsigned long long", True)),
        ("snr_warp_lines", ("float4", 2)),
        ("slim_minor_kernel", ("float", False, True, False, False, False, "float", True)),
    ]
    assert [(r.registers, r.spill_stores, r.spill_loads, r.static_smem) for r in rows] == [
        (80, 64, 92, 0), (128, 8, 8, 33_792), (128, 120, 188, 0), (64, 40, 52, 0), (32, 0, 0, 0), (22, 0, 0, 256)]
    result = PassResult("resources")
    kernelcheck.check_resources(rows, result, KERNELS_OF_PTXAS)
    assert not result.findings, [str(f) for f in result.findings]
    res = {r.kernel: r for r in kernelcheck.resources(rows)}
    assert res["paged_cores_kernel"].dynamic_smem == 4 * 32 * (2 * 128 * 2 + 16) + 4 * (64 * 132 + 64 * 33 + 192) \
        + 4 * 256
    assert res["ssm_bwd_walk"].dynamic_smem == 56_320 and res["ssm_bwd_walk"].blocks_per_sm == 4


def _seeded(old: str, new: str):
    assert old in PTXAS
    result = PassResult("resources")
    kernelcheck.check_resources(build.resource_report(PTXAS.replace(old, new), KERNELS_OF_PTXAS), result,
                                KERNELS_OF_PTXAS)
    return {f.check for f in result.findings}


def test_new_spill_flagged():
    # snr_warp_lines is declared spill-free
    assert _seeded("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\nptxas info    : Used 32",
                   "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\nptxas info    : Used 32") == {"spill"}


def test_shared_memory_over_budget_flagged():
    assert _seeded("33792 bytes smem", "233792 bytes smem") >= {"smem"}


def test_register_file_overrun_flagged():
    # slim_minor_kernel runs up to 1024 threads: 80 registers need 81,920,
    # so not one block fits an SM
    assert _seeded("Used 22 registers", "Used 80 registers") == {"regs", "blocks"}


def test_undeclared_kernel_flagged():
    result = PassResult("resources")
    kernelcheck.check_resources(build.resource_report(PTXAS, KERNELS_OF_PTXAS), result,
                                {**KERNELS_OF_PTXAS, "rogue_kernel": "rogue.cu"})
    assert {f.check for f in result.findings} == {"declared"}


BAD_CU = """
#include <cuda_bf16.h>
__device__ __forceinline__ float twice(const __nv_bfloat16* g, long long i) {
  return __bfloat162float(__hmul(g[i], g[i]));
}
"""
GOOD_CU = """
#include <cuda_bf16.h>
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
"""


def test_raw_bf16_arithmetic_flagged():
    result = PassResult("kernelcheck")
    kernelcheck.check_bf16_source("rogue.cu", BAD_CU, result)
    assert {f.check for f in result.findings} == {"dtype"} and len(result.findings) == 2
    result = PassResult("kernelcheck")
    kernelcheck.check_bf16_source("ssm_scan.cu", GOOD_CU, result)
    assert not result.findings


def test_bf16_store_not_from_float_flagged():
    src = ("__device__ __forceinline__ void put(__nv_bfloat16& dst, float v) { dst = v; }\n"
           "__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }\n")
    result = PassResult("kernelcheck")
    kernelcheck.check_bf16_source("ssm_scan_bwd.cu", src, result)
    assert [f.check for f in result.findings] == ["dtype"] and "put stores" in result.findings[0].message
    result = PassResult("kernelcheck")
    kernelcheck.check_bf16_source("ssm_scan_bwd.cu", src.replace("dst = v", "dst = __float2bfloat16_rn(v)"), result)
    assert not result.findings


def test_overlapping_tiles_flagged():
    """A split walk whose pass 2 writes the line outputs from every piece
    (a kernel that lost its ``k == 0`` guard): v' written nseg times."""
    plan = megaplan.plan_slim(1, 2, registry.JAX_FIT_EDGE_RED, 1, sms=132, aligned=True)
    assert plan.form == megaplan.FORM_SPLIT and plan.nseg > 1
    good = races.slim_owners(plan, partial=False, snr=False, health=False, reduce=False)
    result = PassResult("races")
    races.check_owners(good, result, "seeded")
    assert not result.findings
    lines = [races.Write("apply", w.block, "v_out", np.array([plan.lines - 1 - w.block // plan.nseg]))
             for w in good.writes if w.launch == "apply" and w.output == "u"]
    bad = races.Owners([w for w in good.writes if w.output != "v_out"] + lines, good.sizes, good.workspaces)
    result = PassResult("races")
    races.check_owners(bad, result, "seeded")
    assert [f.check for f in result.findings] == ["race-once"]


# (batch, rows, cols, axis) views where the split walks combine: a SPLIT
# line, a MAJOR tile of rows, and a ragged one of each.
COMBINED_VIEWS = [(1, 2, registry.JAX_FIT_EDGE_RED, 1), (1, 4608, 1536, 0), (3, 5, 70_001, 1), (2, 9_000, 77, 0)]


@pytest.mark.parametrize("view", COMBINED_VIEWS)
def test_combine_grids_are_the_planners(view):
    """B10's and B12's combine and B5/B8/B9's take the grid their plan
    states (the wrappers pass ``combine_blocks`` to the entry points): just
    enough blocks to reach every line, and the race pass walks exactly that
    grid. Exact integer arithmetic."""
    b, r, c, axis = view
    plan = megaplan.plan_slim(b, r, c, axis, sms=132, aligned=True)
    assert plan.form in (megaplan.FORM_SPLIT, megaplan.FORM_MAJOR)
    span = megaplan.SLIM_THREADS if plan.form == megaplan.FORM_MAJOR else 8
    assert (plan.combine_blocks - 1) * span < plan.lines <= plan.combine_blocks * span
    owners = races.slim_owners(plan, partial=True, snr=True, health=True, reduce=False)
    assert max(w.block for w in owners.writes if w.launch == "combine") == plan.combine_blocks - 1
    split = races._ss.plan_split(b, r, c, axis, sms=132, aligned=True)
    if split.nseg > 1:
        assert (split.combine_blocks - 1) * 8 < split.lines <= split.combine_blocks * 8


def test_short_combine_grid_flagged(monkeypatch):
    """A combine grid one block short of its lines (a planner that drifted
    from the kernel's index arithmetic) leaves line outputs unwritten."""
    plan = megaplan.plan_slim(1, 4608, 1536, 0, sms=132, aligned=True)
    short = megaplan.SlimPlan.combine_blocks.fget(plan) - 1
    monkeypatch.setattr(megaplan.SlimPlan, "combine_blocks", property(lambda self: short))
    result = PassResult("races")
    races.check_owners(races.slim_owners(plan, partial=True, snr=False, health=False, reduce=False), result,
                       "seeded")
    assert {f.check for f in result.findings} == {"race-once"}
    assert all("written by no block" in f.message for f in result.findings)


@pytest.mark.parametrize("rows,cols,with_health", [(1, 4, False), (24, 512, True), (7, 36, True),
                                                   (50_000, 512, False)])
def test_adam_grid_fits_the_declared_block(rows, cols, with_health):
    """B2's grid, which ``mega_adam_update`` launches: 32 to 256 threads in
    whole warps (the entry point refuses others; kernelcheck declares 256),
    at most 16 blocks an SM of 132, and every element written once."""
    blocks, threads = megaplan.adam_grid(rows, cols, with_health)
    assert 32 <= threads <= 256 and threads % 32 == 0 and 1 <= blocks <= 132 * 16
    if with_health:
        owners = races.adam_health_owners(rows, cols)
    else:
        owners = races.elementwise_owners(rows * cols, True, blocks, threads, ("u", "m_out", "v_out"))
    result = PassResult("races")
    races.check_owners(owners, result, f"adam_grid{(rows, cols, with_health)}")
    assert not result.findings and result.checks == len(owners.sizes)


def test_shared_workspace_slot_flagged():
    plan = megaplan.plan_slim(1, 2, registry.JAX_FIT_EDGE_RED, 1, sms=132, aligned=True)
    good = races.slim_owners(plan, partial=True, snr=True, health=True, reduce=True)
    writes = [w._replace(index=w.index // 2) if w.output == "work" else w for w in good.writes]
    result = PassResult("races")
    races.check_owners(races.Owners(writes, good.sizes, good.workspaces), result, "seeded")
    assert "race-workspace" in {f.check for f in result.findings}


def test_partial_owner_placement_flagged():
    from repro_torch.sharding.logical import ShardingContext, param_specs, use_sharding
    from repro_torch.sharding.shardspec import SpecMesh, plan_sharded_leaf

    cfg, params, meta, dims = shardcheck.arch_leaves("gpt_small")
    mesh = SpecMesh({"data": 16, "model": 16})
    with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
        specs = param_specs(meta, params)
    corrupted = 0
    for name, leaf in params.items():
        plan = plan_sharded_leaf(tuple(leaf.shape), leaf.dtype, tuple(dims[name]), specs[name], mesh)
        if plan.regime != "psum" or not plan.owner:
            continue
        ok = PassResult("shardcheck")
        shardcheck.check_leaf_plan(plan, tuple(leaf.shape), tuple(dims[name]), mesh, ok, "clean")
        assert not ok.findings
        bad = plan._replace(owner=tuple(plan.owner[:-1] or (("bogus",) + plan.owner[0][1:],)))
        res = PassResult("shardcheck")
        shardcheck.check_leaf_plan(bad, tuple(leaf.shape), tuple(dims[name]), mesh, res, "seeded")
        assert any(f.check == "owner-all-or-nothing" for f in res.findings)
        corrupted += 1
        if corrupted >= 2:
            break
    assert corrupted


def test_step_branching_on_a_control_flagged(monkeypatch):
    """The step as it stood before this check: it branches on the control's
    value and multiplies by the Python float, so a bf16 gradient is scaled
    by 0.3, not by bf16(0.3) as JAX scales it."""
    from repro_torch.train import step as step_module

    def branching(tree, value):
        v = float(value)
        return tree if v == 1.0 else {k: t * v for k, t in tree.items()}

    monkeypatch.setattr(step_module, "scale_by_control", branching)
    result = tracecheck.run()
    assert {f.check for f in result.findings} == {"controls-used"}
    assert all("bfloat16, grad_scale 0.3" in f.where for f in result.findings)


def test_step_ignoring_its_controls_flagged(monkeypatch):
    from repro_torch.train import step as step_module

    monkeypatch.setattr(step_module, "scale_by_control", lambda tree, value: tree)
    model, tx, batch = tracecheck.reduced_setup()
    result = PassResult("tracecheck")
    tracecheck.check_controls_used(lambda m, t: step_module.make_train_step(m, t, guard=True), model, tx, batch,
                                   result, "seeded")
    assert result.findings and {f.check for f in result.findings} == {"controls-used"}


def test_launches_that_follow_a_control_flagged():
    result = PassResult("tracecheck")
    tracecheck.check_launch_stable(lambda c: {"mega_slim_update_batched": 3 + (c["lr_scale"] != 1.0)}, result)
    assert [f.check for f in result.findings] == ["launch-stable"]
    result = PassResult("tracecheck")
    tracecheck.check_launch_stable(lambda c: {"mega_slim_update_batched": 3}, result)
    assert not result.findings


def test_drifted_golden_key_flagged(tmp_path):
    golden = json.loads(kernelcheck.GOLDEN_PATH.read_text())
    key = sorted(golden)[0]
    golden[key] = [["9x9x9", "float64"]]
    drifted = tmp_path / "golden.json"
    drifted.write_text(json.dumps(golden))
    result, _ = kernelcheck.run(golden_path=drifted)
    assert [(f.check, f.where) for f in result.findings] == [("golden", key)]


def test_full_size_variant_output_flagged():
    entry = registry.ENTRY_MAP["slim_precond_batched"]
    case, variant = entry.cases[0], entry.variants[1]
    result = PassResult("kernelcheck")
    kernelcheck.check_extra_outputs(entry, case, variant, result, "seeded", extras=[(case.shape, torch.float32)])
    assert [f.check for f in result.findings] == ["okept"]


class TestLint:
    def test_library_loaded_outside_kernels_flagged(self, tmp_path):
        hits = lint.lint_source("import ctypes\nlib = ctypes.CDLL('x.so')\n", "repro_torch/optim/rogue.py")
        assert [r for r, _, _ in hits] == ["RPR001"]
        assert not lint.lint_source("import ctypes\nlib = ctypes.CDLL('x.so')\n", "repro_torch/kernels/build.py")
        pkg = tmp_path / "repro_torch"
        (pkg / "optim").mkdir(parents=True)
        (pkg / "optim" / "rogue.cu").write_text("__global__ void k() {}\n")
        assert [h[0] for h in lint.lint_tree(pkg)] == ["RPR001"]

    def test_host_read_in_a_wrapper_flagged(self):
        hits = lint.lint_source(
            "import torch\n"
            "def wrapper(g, count):\n"
            "    n = g.sum().item()\n"
            "    bc = float(count)\n"
            "    flag = int(g.dtype == torch.bfloat16)\n"
            "    return n, bc, flag\n"
            "def wrapper_plain(g):\n"
            "    return g.sum().item()\n",
            "repro_torch/kernels/rogue.py")
        assert [(r, line) for r, line, _ in hits] == [("RPR002", 3), ("RPR002", 4)]

    def test_optional_state_field_without_default_flagged(self):
        hits = lint.lint_source("from typing import NamedTuple, Optional\nclass FooState(NamedTuple):\n"
                                "    count: object\n    snr: Optional[object]\n", "repro_torch/core/rogue.py")
        assert [r for r, _, _ in hits] == ["RPR003"]

    def test_non_atomic_checkpoint_publish_flagged(self):
        hits = lint.lint_source("import os, shutil\ndef save(stage, final, ptr):\n    os.rename(stage, final)\n"
                                "    shutil.move(stage, final)\n    os.replace(final, ptr)\n"
                                "    open(ptr / 'LATEST', 'w')\n", "repro_torch/checkpoint/rogue.py")
        assert [r for r, _, _ in hits].count("RPR004") == 4


# ---------------------------------------------------------------------------
# The real tree, and the CLI
# ---------------------------------------------------------------------------


def test_real_tree_is_green_on_every_device_free_pass():
    result, computed = kernelcheck.run()
    assert not result.findings and len(computed) == 119, [str(f) for f in result.findings]
    for run in (races.run, lint.run, tracecheck.run):
        r = run()
        assert not r.findings, [str(f) for f in r.findings]
    assert races.run().checks > 1000


def test_cli_gate(capsys, monkeypatch):
    from repro_torch.analysis.__main__ import main

    assert main(["--only", "lint,races"]) == 0
    out = capsys.readouterr().out
    assert "lint" in out and "PASS" in out and "FAIL" not in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--only", "resources"]) == 1
    out = capsys.readouterr().out
    assert "no CUDA device" in out and "FAIL" in out
    with pytest.raises(SystemExit):
        main(["--only", "nonsense"])
