"""The decode step on a (data=2, model=2) mesh of 4 gloo CPU processes
(``_torch_ranks.run_ranks``) in JAX's decode layout: each rank holds its
stored parameter shards (``launch.train.stored_weights``), its rows of the
tokens and its block of the decode cache (``init_decode_cache`` under the
context: the KV cache's positions and the SSM state's ``d_inner`` over
``model``), and ``make_serve_step`` runs every region in its all-reduce
form. Held against the port unsharded, JAX's unsharded ``make_serve_step``
and JAX's ``make_serve_step`` jitted with ``decode_cache_specs`` shardings on
``jax.make_mesh((2, 2), ..., axis_types=(AxisType.Auto,) * 2)`` (one oracle
subprocess with 4 forced host devices), from the same parameters
(``convert.params_from_numpy`` of JAX's init), in f32:

* reduced olmoe_1b_7b (experts over ``model``), falcon_mamba_7b (the scan's
  plain twin on the CPU), jamba_v01_52b (Mamba and attention, dense and
  MoE), gpt_small (3 heads: attention's counted fallback; learned
  positions), ``qwen15_32b.optimized()`` (the int8 cache, qkv biases), and
  olmoe and gpt_small with ``vocab_size=212`` (the vocabulary-parallel
  lookup and head, untied and tied; 211 stays whole);
* a 32-position cache (16 a model rank), 10 prompt tokens then 12 greedy
  steps, which write across the block boundary; and a 31-position cache,
  whole on every rank;
* each step's logits within 1e-5 of max|logit| and identical greedy
  tokens; each rank's cache blocks against the unsharded cache's cut; the
  regions counted in their parallel forms (or the fallback where JAX's
  conditions fail);
* bf16 activations for olmoe and falcon, the same tokens fed to every run:
  within one bf16 rounding step of JAX's mesh, or twice the packages'
  unsharded bf16 gap where that is more.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import assert_close, jax_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TOL_BF16 = 2.0**-7   # one bf16 rounding step of the logits' largest magnitude (test_torch_tp.py)
ROWS, PROMPT, STEPS = 4, 10, 22
CASES = {
    "olmoe": dict(arch="olmoe_1b_7b"),
    "falcon": dict(arch="falcon_mamba_7b"),
    "jamba": dict(arch="jamba_v01_52b"),
    "gpt_small": dict(arch="gpt_small"),
    "qwen_int8": dict(arch="qwen15_32b", optimized=True),
    "olmoe_v212": dict(arch="olmoe_1b_7b", fields={"vocab_size": 212}),
    "gpt_small_v212": dict(arch="gpt_small", fields={"vocab_size": 212}),
}
WHOLE_CACHE = ("olmoe", "jamba", "qwen_int8")   # also on 31 positions, which 2 model ranks do not divide
BF16 = ("olmoe", "falcon")
# each case's regions a step: (kind, parallel) per layer slot kind, and the vocabulary's
REGIONS = {"olmoe": {"attn": 1, "moe": 1}, "falcon": {"ssm": 1}, "jamba": {"ssm": 1, "mlp": 1, "attn": 1, "moe": 1},
           "gpt_small": {"attn": 0, "mlp": 1}, "qwen_int8": {"attn": 1, "mlp": 1}}

ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, importlib, pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.launch.dryrun import decode_cache_specs
from repro.models import transformer as jtf
from repro.sharding.logical import ShardingContext, param_specs, use_sharding
from repro.train.step import make_serve_step

work = sys.argv[1]
spec = pickle.load(open(os.path.join(work, "spec.pkl"), "rb"))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)


def config(case):
    cfg = get_reduced(case["arch"])
    if case.get("optimized"):
        mod = importlib.import_module("repro.configs." + case["arch"])
        opt, full = mod.optimized(), mod.config()
        cfg = dataclasses.replace(cfg, **{f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)
                                          if getattr(opt, f.name) != getattr(full, f.name)})
    fields = {k: getattr(jnp, v) if k == "dtype" else v for k, v in case.get("fields", {}).items()}
    return dataclasses.replace(cfg, **fields)


def serve(cfg, params, step, cache, tokens, steps):
    logits, nexts, tok = [], [], None
    for t in range(steps):
        if t < tokens.shape[1]:
            tok = jnp.asarray(tokens[:, t:t + 1])
        tok, lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg[:, 0], np.float32))
        nexts.append(np.asarray(tok[:, 0]))
    return np.stack(logits), np.stack(nexts)


out = {}
for name, case in spec.items():
    cfg = config(case)
    params, meta = cfg.init(jax.random.PRNGKey(0))
    b = case["tokens"].shape[0]
    cache = jtf.init_decode_cache(cfg, b, case["max_seq"], dtype=cfg.dtype)
    res = {"plain": serve(cfg, params, jax.jit(make_serve_step(cfg)), cache, case["tokens"], case["steps"])}
    ctx = ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)
    with use_sharding(ctx):
        named = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree, is_leaf=lambda x: isinstance(x, P))
        p_sh = named(param_specs(meta, params))
        c_sh = named(decode_cache_specs(ctx, cache))
        t_sh = NamedSharding(mesh, ctx.spec_for(("batch", None), (b, 1)))
        step = jax.jit(make_serve_step(cfg), in_shardings=(p_sh, c_sh, t_sh), out_shardings=(t_sh, None, c_sh))
        res["mesh"] = serve(cfg, jax.device_put(params, p_sh), step, jax.device_put(cache, c_sh), case["tokens"],
                            case["steps"])
    out[name] = res
pickle.dump(out, open(os.path.join(work, "jax_out.pkl"), "wb"))
print("ok")
"""


def _arrays(case):
    """JAX's init of the case's config (seed 0) as {dotted name: array}."""
    import dataclasses

    import jax

    from repro.configs import get_reduced as jax_reduced
    from repro.core.labels import flatten_with_names

    if not case.get("fields", {}).get("vocab_size"):
        return jax_params(seed=0, arch=case["arch"])[3]
    cfg = dataclasses.replace(jax_reduced(case["arch"]), vocab_size=case["fields"]["vocab_size"])
    params, _ = cfg.init(jax.random.PRNGKey(0))
    return {name: np.asarray(leaf) for name, leaf in flatten_with_names(params)[0]}


def _runs():
    """{run name: case} of every (case, cache length, dtype) run."""
    rng = np.random.default_rng(11)
    runs = {}
    for name, case in CASES.items():
        arrays = _arrays(case)
        vocab = case.get("fields", {}).get("vocab_size", 211)
        tokens = rng.integers(0, vocab, (ROWS, PROMPT)).astype(np.int32)
        for s in (32, 31) if name in WHOLE_CACHE else (32,):
            runs[f"{name}_{s}"] = dict(case, arrays=arrays, tokens=tokens, steps=STEPS, max_seq=s)
        if name in BF16:   # the same tokens fed at every step
            fields = dict(case.get("fields", {}), dtype="bfloat16")
            runs[f"{name}_bf16"] = dict(case, fields=fields, arrays=arrays, max_seq=32, steps=STEPS,
                                        tokens=rng.integers(0, vocab, (ROWS, STEPS)).astype(np.int32))
    return runs


def _port(case):
    """The port unsharded: each step's logits and next tokens, the cache."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import transformer

    cfg = ranks.decode_config(case)
    cache = transformer.init_decode_cache(cfg, ROWS, case["max_seq"], cfg.dtype)
    return ranks.serve_tokens(cfg, params_from_numpy(case["arrays"], "cpu"), cache,
                              torch.from_numpy(case["tokens"]), case["steps"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle (subprocess) beside the port's 4 ranks and the port
    unsharded."""
    work = tmp_path_factory.mktemp("decode_mesh")
    cases = _runs()
    (work / "spec.pkl").write_bytes(pickle.dumps({k: {f: v for f, v in c.items() if f != "arrays"}
                                                  for k, c in cases.items()}))
    (work / "oracle.py").write_text(ORACLE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, str(work / "oracle.py"), str(work)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        mesh = ranks.run_ranks(ranks.decode_mesh, work, cases, timeout_s=240.0)
        port = {}
        for name, case in cases.items():
            logits, nexts, cache = _port(case)
            port[name] = {"logits": logits, "next": nexts, "cache": ranks._cache_np(cache)}
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return dict(cases=cases, mesh=mesh, port=port, jax=pickle.loads((work / "jax_out.pkl").read_bytes()))


def _rows(x, r):
    """Rank ``r``'s rows (its data block) of a (steps, rows, ...) array."""
    d = r["coords"]["data"]
    n = x.shape[1] // 2
    return x[:, d * n:(d + 1) * n]


F32 = [f"{n}_32" for n in CASES] + [f"{n}_31" for n in WHOLE_CACHE]


@pytest.mark.parametrize("run", F32)
@pytest.mark.parametrize("against", ["port", "jax", "jax_mesh"])
def test_decode_on_the_mesh_matches(runs, run, against):
    """Every rank's logits at every step within 1e-5 of max|logit| and its
    greedy tokens identical: against the port unsharded, JAX unsharded and
    JAX's step under its (2, 2) mesh."""
    if against == "port":
        want = (runs["port"][run]["logits"], runs["port"][run]["next"])
    else:
        want = runs["jax"][run]["plain" if against == "jax" else "mesh"]
    for r in runs["mesh"]:
        got = r[run]
        assert_close(got["logits"], _rows(want[0], r), TOL, f"{run} logits rank {r['coords']}")
        np.testing.assert_array_equal(got["next"], _rows(want[1], r), err_msg=f"{run} tokens rank {r['coords']}")
        assert got["step"] == STEPS


@pytest.mark.parametrize("run", F32)
def test_model_ranks_agree_bit_for_bit(runs, run):
    """The two model ranks of a data row hold the same logits and tokens."""
    by_data = {}
    for r in runs["mesh"]:
        by_data.setdefault(r["coords"]["data"], []).append(r[run])
    for a, b in by_data.values():
        np.testing.assert_array_equal(a["logits"], b["logits"])
        np.testing.assert_array_equal(a["next"], b["next"])


def _cut(full, shape, r):
    """This rank's block of a whole cache tensor (periods, rows, ...) of a
    local ``shape``: its rows, and along any other dim its model block."""
    out = full
    for d, (g, n) in enumerate(zip(full.shape, shape)):
        if g != n:
            i = r["coords"]["data"] if d == 1 else r["coords"]["model"]
            out = np.take(out, np.arange(i * n, (i + 1) * n), axis=d)
    return out


@pytest.mark.parametrize("run", F32)
def test_cache_blocks_match_the_unsharded_cut(runs, run):
    """Each rank's KV cache (int8 rows and scales too) and SSM state after
    the last step against its cut of the unsharded cache: positions over
    ``model`` where 2 divides them (16 a rank of 32; 31 whole), ``d_inner``
    over ``model``, rows over ``data``."""
    want = runs["port"][run]["cache"]
    s = runs["cases"][run]["max_seq"]
    for r in runs["mesh"]:
        got = r[run]["cache"]
        assert set(got) == set(want)
        for slot, tensors in want.items():
            for g, w in zip(got[slot], tensors):
                if g.ndim == 5 and w.shape[2] == s:   # a KV cache: (periods, rows, positions, KV, hd)
                    assert g.shape[2] == (s // 2 if s % 2 == 0 else s), (run, slot, g.shape)
                assert_close(g, _cut(w, g.shape, r), TOL, f"{run} {slot} rank {r['coords']}")


@pytest.mark.parametrize("run", F32 + [f"{n}_bf16" for n in BF16])
def test_every_region_takes_its_decode_form(runs, run):
    """Per step, each layer's mixer and FFN region in its all-reduce form
    (gpt_small's 3 heads: attention's fallback, as JAX's); the embedding
    lookup and the head vocabulary-parallel where 2 divides the
    vocabulary."""
    name = run.rsplit("_", 1)[0]
    case = CASES[name]
    cfg = ranks.decode_config(case)
    per_slot = {}
    for slot in cfg.pattern:
        for kind in (slot.mixer if slot.mixer != "mamba" else "ssm", slot.ffn if slot.ffn != "dense" else "mlp"):
            if kind:
                per_slot[kind] = per_slot.get(kind, 0) + cfg.n_periods
    base = name.replace("_v212", "")
    want = {f"decode_{k}": {"parallel": n * STEPS * REGIONS[base][k], "fallback": n * STEPS * (1 - REGIONS[base][k])}
            for k, n in per_slot.items()}
    vocab = "parallel" if cfg.vocab_size % 2 == 0 else "fallback"
    for k in ("embed", "head"):
        want[f"decode_{k}"] = {"parallel": 0, "fallback": 0, vocab: STEPS}
    for r in runs["mesh"]:
        assert r[run]["regions"] == want, (run, r[run]["regions"])


def _gap(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", BF16)
def test_bf16_decode_on_the_mesh_matches_jax(runs, name):
    """bf16 activations, the same tokens fed: the mesh's logits within one
    bf16 rounding step of JAX's step under its mesh, or twice what the two
    packages' unsharded bf16 steps already differ where that is more."""
    run = f"{name}_bf16"
    jax = runs["jax"][run]
    bar = max(TOL_BF16, 2 * _gap(runs["port"][run]["logits"], jax["plain"][0]))
    for r in runs["mesh"]:
        assert_close(r[run]["logits"], _rows(jax["mesh"][0], r), bar, f"{run} rank {r['coords']}")


@pytest.mark.parametrize("name", BF16)
def test_bf16_decode_on_the_mesh_matches_the_port(runs, name):
    """The same against the port unsharded in bf16: within one bf16
    rounding step, or twice the packages' unsharded bf16 gap."""
    run = f"{name}_bf16"
    port = runs["port"][run]["logits"]
    bar = max(TOL_BF16, 2 * _gap(port, runs["jax"][run]["plain"][0]))
    for r in runs["mesh"]:
        assert_close(r[run]["logits"], _rows(port, r), bar, f"{run} rank {r['coords']}")


@pytest.mark.parametrize("run", F32)
def test_one_device_decode_matches_jax(runs, run):
    """Without a process mesh the step runs in the LOCAL layout, as before
    this layout existed: the port's logits within 1e-5 of JAX's unsharded
    step, the same greedy tokens, the cache whole."""
    port, jax = runs["port"][run], runs["jax"][run]["plain"]
    assert_close(port["logits"], jax[0], TOL, run)
    np.testing.assert_array_equal(port["next"], jax[1])
    for tensors in port["cache"].values():
        assert tensors[0].shape[1] == ROWS
