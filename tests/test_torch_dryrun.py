"""The dry run on the ``meta`` device (``repro_torch.launch.dryrun``) and the
configs' sharding overrides, held to the JAX package's ``repro/launch``.

The JAX side runs in one subprocess with 512 host devices (the dry run's
XLA flag), specs and shapes only, except for the two reduced cells whose
dot FLOPs it compiles as ``repro/launch/dryrun.py:134-222`` does. The
port's dry runs run in subprocesses of their own (each holds a fake
process group of its mesh's size).

* ``smollm_135m.optimized()`` equals JAX's field for field, and its
  parameter specs on a device-free mesh of the production shape equal JAX's;
* ``--list`` prints JAX's table;
* ``model_flops_estimate`` and ``pick_grad_accum`` at JAX's 3 GiB budget
  equal JAX's for every runnable (arch, shape, mesh);
* a rank's parameter and optimizer bytes equal the sum of JAX's
  ``shard_shape`` x itemsize for the train_4k cells of deepseek_67b,
  olmoe_1b_7b and falcon_mamba_7b on the single-pod mesh;
* matmul FLOPs a rank of reduced gpt_small and smollm_135m at a short train
  shape on a (2, 2) mesh against JAX's compiled dot FLOPs (see
  ``DOT_TOL``), and the dry run initialises no CUDA context.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
BYTES_ARCHS = ("deepseek_67b", "olmoe_1b_7b", "falcon_mamba_7b")
# reduced cells whose dot FLOPs both sides count: (arch, seq, global batch)
DOT_CELLS = (("gpt_small", 64, 8), ("smollm_135m", 64, 8))
DOT_TOL = 0.02
BUDGET = 3 * 2**30

ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses, math, pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCH_IDS, SHAPES, cell_supported, get_config, get_reduced, input_specs
from repro.configs import smollm_135m
from repro.core import rules_as_tree, table3_rules
from repro.core.labels import flatten_with_names
from repro.core.slim_adam import slim_adam
from repro.launch import dryrun, hlo_analysis
from repro.launch.mesh import make_production_mesh
from repro.sharding.logical import ShardingContext, param_specs, use_sharding
from repro.sharding.state_shardings import opt_state_specs
from repro.train.step import make_train_step

work = sys.argv[1]
spec = pickle.load(open(os.path.join(work, "spec.pkl"), "rb"))
out = {}
meshes = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}

def cell_cfg(arch, shape):
    cfg = get_config(arch, param_dtype=jnp.bfloat16)
    seq = SHAPES[shape][0]
    if cfg.pos == "learned" and cfg.max_position < seq + 1:
        cfg = dataclasses.replace(cfg, max_position=seq + 1)
    return cfg

# the optimized config's specs on the production mesh
opt_cfg = smollm_135m.optimized()
out["optimized_specs"] = {}
for kind, mesh in meshes.items():
    with use_sharding(ShardingContext(mesh, rules=dict(opt_cfg.sharding_overrides) or None)):
        abs_p, meta = opt_cfg.abstract()
        out["optimized_specs"][kind] = {n: tuple(s) for n, s in flatten_with_names(param_specs(meta, abs_p))[0]}
out["optimized_fields"] = {f.name: (str(getattr(opt_cfg, f.name)) if "dtype" in f.name else getattr(opt_cfg, f.name))
                           for f in dataclasses.fields(opt_cfg) if f.name != "pattern"}

# model FLOPs and grad_accum of every runnable cell
flops = {}
for mesh_kind, mesh in meshes.items():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if not cell_supported(arch, shape)[0]:
                continue
            cfg = cell_cfg(arch, shape)
            n = sum(math.prod(p.shape) for p in jax.tree.leaves(cfg.abstract()[0]))
            info = {"n_params": n, "shape": shape}
            flops[(arch, shape, mesh_kind)] = (dryrun.model_flops_estimate(cfg, info),
                                               dryrun.pick_grad_accum(cfg, shape, mesh))
out["flops"] = flops

# a rank's parameter and optimizer bytes (train_4k, single, Table-3 SlimAdam, 'jnp')
mesh = meshes["single"]
named = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree, is_leaf=lambda x: isinstance(x, P))
shard_bytes = {}
for arch in spec["bytes_archs"]:
    cfg = cell_cfg(arch, "train_4k")
    with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
        params, meta = cfg.abstract()
        p_specs = param_specs(meta, params)
        tx = slim_adam(3e-4, rules_as_tree(table3_rules(meta), params, meta), backend="jnp")
        opt = jax.eval_shape(tx.init, params)
        o_specs = opt_state_specs(opt, params, p_specs, owner_mesh=None)
        count = lambda tree, specs: sum(math.prod(sh.shard_shape(x.shape)) * jnp.dtype(x.dtype).itemsize
                                        for x, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(named(specs))))
        shard_bytes[arch] = {"params": count(params, p_specs), "opt": count(opt, o_specs)}
out["bytes"] = shard_bytes

# dot FLOPs of the reduced cells, compiled as build_cell compiles a train cell
small = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
dots = {}
for arch, seq, gb in spec["dot_cells"]:
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=jnp.bfloat16)
    ctx = ShardingContext(small, rules=dict(cfg.sharding_overrides) or None)
    with use_sharding(ctx):
        params_abs, meta = cfg.abstract()
        p_specs = param_specs(meta, params_abs)
        p_sh = jax.tree.map(lambda s: NamedSharding(small, s), p_specs, is_leaf=lambda x: isinstance(x, P))
        batch = {k: jax.ShapeDtypeStruct((gb, seq), jnp.int32) for k in ("tokens", "labels")}
        b_sh = {k: NamedSharding(small, ctx.spec_for(("batch", None), (gb, seq))) for k in batch}
        tx = slim_adam(3e-4, rules_as_tree(table3_rules(meta), params_abs, meta), backend="jnp")
        opt_abs = jax.eval_shape(tx.init, params_abs)
        o_sh = jax.tree.map(lambda s: NamedSharding(small, s), opt_state_specs(opt_abs, params_abs, p_specs),
                            is_leaf=lambda x: isinstance(x, P))
        step = make_train_step(cfg, tx, grad_accum=1, grad_shardings=p_sh)
        jitted = jax.jit(step, in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None),
                         donate_argnums=(0, 1))
        compiled = jitted.lower(params_abs, opt_abs, batch).compile()
        dots[arch] = hlo_analysis.analyze(compiled.as_text()).dot_flops
out["dots"] = dots

# the decode caches' specs of every decode cell (repro/launch/dryrun.py:63-86)
from repro.configs import decode_input_specs
cache_specs = {}
for mesh_kind, mesh in meshes.items():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if SHAPES[shape][2] != "decode" or not cell_supported(arch, shape)[0]:
                continue
            cfg = cell_cfg(arch, shape)
            ctx = ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)
            with use_sharding(ctx):
                specs = dryrun.decode_cache_specs(ctx, decode_input_specs(cfg, shape)["cache"])
            cache_specs[(arch, shape, mesh_kind)] = {k: [tuple(e) for e in c] for k, c in specs.slots.items()}
out["cache_specs"] = cache_specs
pickle.dump(out, open(os.path.join(work, "jax_out.pkl"), "wb"))
print("ok")
"""


# every decode cell's cache on the production mesh of argv[1], as rank 0
# holds it (init_decode_cache under the context) and as its global shape
PORT_CACHES = r"""
import json, sys
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported
from repro_torch.launch import dryrun
from repro_torch.models import transformer
from repro_torch.sharding import ShardingContext, use_sharding

mesh = dryrun.make_meta_mesh(*dryrun.PRODUCTION[sys.argv[1]])
out = {}
for arch in ARCH_IDS:
    for shape, (seq, gb, kind) in SHAPES.items():
        if kind != "decode" or not cell_supported(arch, shape)[0]:
            continue
        cfg = dryrun.cell_config(arch, shape)
        whole = transformer.abstract_decode_cache(cfg, gb, seq)
        ctx = ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)
        with use_sharding(ctx):
            local = transformer.abstract_decode_cache(cfg, gb, seq)
        specs = dryrun.decode_cache_specs(ctx, whole)
        out[f"{arch} {shape}"] = {k: [[list(t.shape) for t in whole.slots[k]], [list(t.shape) for t in c],
                                      [[e if e is None or isinstance(e, str) else list(e) for e in sp]
                                       for sp in specs.slots[k]]] for k, c in local.slots.items()}
print(json.dumps(out))
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}


def _port_cell(tmp: Path, *args) -> dict:
    """One port dry run in a process of its own; its JSON record."""
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(tmp)],
                          capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout[proc.stdout.index("{"):])


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX oracle beside the port's reduced dry runs."""
    work = tmp_path_factory.mktemp("dryrun")
    (work / "spec.pkl").write_bytes(pickle.dumps(dict(bytes_archs=BYTES_ARCHS, dot_cells=DOT_CELLS)))
    (work / "oracle.py").write_text(ORACLE)
    proc = subprocess.Popen([sys.executable, str(work / "oracle.py"), str(work)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())
    try:
        port = {arch: _port_cell(work, "--arch", arch, "--reduced", "--shape", "train_4k", "--seq", str(seq),
                                 "--batch", str(gb), "--mesh-shape", "2,2", "--grad-accum", "1")
                for arch, seq, gb in DOT_CELLS}
        _, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return dict(jax=pickle.loads((work / "jax_out.pkl").read_bytes()), port=port)


def test_smollm_optimized_equals_jax_field_for_field():
    import jax.numpy as jnp

    from repro.configs import smollm_135m as jsm
    from repro_torch.configs import get_optimized, smollm_135m as tsm

    mine, theirs = tsm.optimized(), jsm.optimized()
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        elif f.name == "pattern":
            assert [(s.mixer, s.ffn) for s in a] == [(s.mixer, s.ffn) for s in b]
        else:
            assert a == b, (f.name, a, b)
    assert mine.sharding_overrides and get_optimized("smollm_135m") == mine


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_optimized_param_specs_equal_jax_on_the_production_mesh(jax_side, mesh_kind):
    """Under smollm_135m.optimized()'s overrides (pure data parallelism)
    every parameter spec on a device-free mesh of the production shape
    equals JAX's on the same mesh of host devices."""
    from repro_torch.configs import smollm_135m
    from repro_torch.sharding import ShardingContext, SpecMesh, param_specs, use_sharding

    cfg = smollm_135m.optimized()
    shape = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}[mesh_kind]
    with use_sharding(ShardingContext(SpecMesh(shape), rules=dict(cfg.sharding_overrides))):
        abstract, meta = cfg.abstract()
        got = {k: tuple(s) for k, s in param_specs(meta, abstract).items()}
    want = jax_side["jax"]["optimized_specs"][mesh_kind]
    assert set(got) == set(want)
    for k in want:
        a, b = list(got[k]), list(want[k])
        n = max(len(a), len(b))
        assert a + [None] * (n - len(a)) == b + [None] * (n - len(b)), (k, got[k], want[k])


def test_list_prints_jax_table():
    jax_out = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--list"], capture_output=True,
                             text=True, env=_env(), timeout=300)
    port_out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"], capture_output=True,
                              text=True, env=_env(), timeout=300)
    assert jax_out.returncode == port_out.returncode == 0
    assert port_out.stdout == jax_out.stdout
    assert port_out.stdout.count("RUN") == 39


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_model_flops_and_grad_accum_equal_jax(jax_side, mesh_kind):
    """Every runnable (arch, shape) on the production mesh: the model-FLOPs
    estimate and ``pick_grad_accum`` at JAX's 3 GiB budget, exactly."""
    import math

    from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported
    from repro_torch.launch import dryrun
    from repro_torch.sharding import SpecMesh

    mesh = SpecMesh({"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}[mesh_kind])
    want = jax_side["jax"]["flops"]
    n = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if not cell_supported(arch, shape)[0]:
                continue
            cfg = dryrun.cell_config(arch, shape)
            seq, gb, _ = SHAPES[shape]
            info = {"n_params": sum(math.prod(p.shape) for p in cfg.abstract()[0].values()), "shape": shape,
                    "seq": seq, "global_batch": gb}
            got = (dryrun.model_flops_estimate(cfg, info), dryrun.pick_grad_accum(cfg, shape, mesh, budget=BUDGET))
            assert got == want[(arch, shape, mesh_kind)], (arch, shape)
            n += 1
    assert n == 39


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_rank_bytes_equal_jax_shard_shapes(jax_side, arch):
    """train_4k on the single-pod mesh, Table-3 SlimAdam on 'jnp' (the dry
    run's default): a rank's parameter and optimizer-state bytes, reckoned
    by ``launch.train.reckon_bytes`` (which ``dryrun.build_cell`` holds the
    built state to), equal JAX's shard shapes times their itemsizes."""
    from repro_torch.launch import dryrun, train as launch
    from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding

    cfg = dryrun.cell_config(arch, "train_4k")
    mesh = SpecMesh({"data": 16, "model": 16})
    with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
        got = launch.reckon_bytes(cfg, "slim", 3e-4, mesh, backend="jnp")
    assert got == jax_side["jax"]["bytes"][arch]


def dense_dots(cfg, rows: int, seq: int, tp: int, *, heads: int, kv: int, vocab_cols: int, head_tokens: int,
               remat: bool) -> int:
    """Matmul FLOPs a rank of one train step of a dense decoder, op by op:
    each layer's q, k, v and o projections and the two score products over
    ``rows`` x ``seq`` tokens with ``heads`` query and ``kv`` key heads, the
    MLP with ``d_ff / tp`` columns, the tied head over ``head_tokens``
    tokens and ``vocab_cols`` columns; the backward twice the forward (input
    and weight gradients); with ``remat`` each layer's forward again, less
    its last product (PyTorch's non-reentrant checkpoint stops recomputing
    once the backward has what it saved)."""
    d, hd, L = cfg.d_model, cfg.hd, cfg.n_layers
    t = rows * seq
    attn = (2 * t * d * heads * hd + 2 * 2 * t * d * kv * hd + 2 * t * heads * hd * d
            + 2 * 2 * rows * heads * seq * seq * hd)
    mlp = (3 if cfg.gated_mlp else 2) * 2 * t * d * (cfg.d_ff // tp)
    last = 2 * t * (cfg.d_ff // tp) * d
    head = 2 * head_tokens * d * vocab_cols
    return 3 * (L * (attn + mlp) + head) + (L * (attn + mlp - last) if remat else 0)


def _split(n: int, tp: int) -> int:
    """A dim's block a rank under JAX's padded split (whole below the axis)."""
    return -(-n // tp) if n >= tp else n


# JAX's GSPMD cuts smollm_135m's one KV head's projections by sequence in
# parts of the step, 1,179,648 FLOPs a layer below the padded-head split
GSPMD_RESIDUAL = {"gpt_small": 0, "smollm_135m": 3 * 1_179_648}


@pytest.mark.parametrize("cell", DOT_CELLS, ids=[c[0] for c in DOT_CELLS])
def test_dot_flops_a_rank_match_jax(jax_side, cell):
    """Matmul FLOPs a rank of one train step (Table-3 SlimAdam, 'jnp',
    grad_accum 1) on a (2, 2) mesh. The port's ``FlopCounterMode`` count
    differs from JAX's compiled dot FLOPs by what the two steps compute
    otherwise, accounted op by op (PERF.md): the port's attention takes the
    whole-region fallback (3 heads on each model rank; JAX pads them to 4
    and splits 2 a rank), its head runs on the rank's own positions over the
    whole vocabulary (JAX: every position, the padded vocabulary split),
    and shard storage rematerializes each layer (the reduced configs have
    ``remat=False``). The port's count equals its op-by-op model exactly;
    JAX's equals the same model with JAX's choices, less GSPMD's cut of a
    single KV head, within ``DOT_TOL``. The run keeps no CUDA context and
    counts the regions as the model assumes."""
    from repro_torch.configs import get_reduced

    arch, seq, gb = cell
    cfg = get_reduced(arch)
    rows, tp = gb // 2, 2
    rec = jax_side["port"][arch]
    port = dense_dots(cfg, rows, seq, tp, heads=cfg.n_heads, kv=cfg.n_kv_heads, vocab_cols=cfg.vocab_size,
                      head_tokens=rows * seq // tp, remat=True)
    like_jax = dense_dots(cfg, rows, seq, tp, heads=_split(cfg.n_heads, tp), kv=_split(cfg.n_kv_heads, tp),
                          vocab_cols=_split(cfg.vocab_size, tp), head_tokens=rows * seq, remat=cfg.remat)
    want = jax_side["jax"]["dots"][arch]
    assert rec["dot_flops_per_dev"] == port
    assert abs(want - (like_jax - GSPMD_RESIDUAL[arch])) <= DOT_TOL * want, (want, like_jax)
    assert rec["cuda_initialized"] is False
    # each region in the forward and again in the remat recompute
    assert rec["regions"]["mlp"] == {"parallel": 2 * cfg.n_layers, "fallback": 0}
    assert rec["regions"]["attn"] == {"parallel": 0, "fallback": 2 * cfg.n_layers}


def test_sweep_writes_records_and_summary(tmp_path):
    """``launch.sweep`` on two cells of the single-pod mesh: falcon's
    long_500k runs in a subprocess of its own (one process group a
    process), hubert's is skipped by ``cell_supported``; one JSON a cell and
    ``summary.csv`` beside them."""
    import csv

    from repro_torch.launch import sweep

    assert sweep.main(["--mesh", "single", "--archs", "falcon_mamba_7b", "hubert_xlarge", "--shapes", "long_500k",
                       "--out", str(tmp_path)]) == 0
    rows = {r["arch"]: r for r in csv.DictReader(open(tmp_path / "summary.csv"))}
    assert rows["falcon_mamba_7b"]["status"] == "ok" and rows["falcon_mamba_7b"]["fits"] == "True"
    assert rows["hubert_xlarge"]["status"] == "skipped" and "encoder-only" in rows["hubert_xlarge"]["reason"]
    rec = json.loads((tmp_path / "falcon_mamba_7b__long_500k__single.json").read_text())
    assert rec["n_chips"] == 256 and rec["launches"] == {"ssm_scan": 64} and rec["cuda_initialized"] is False


def _norm_spec(spec, ndim):
    """A spec's entries as tuples of axis names, padded to ndim."""
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    return out + [()] * (ndim - len(out))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_decode_cells_hold_the_rank_block_of_jax_cache_layout(jax_side, mesh_kind):
    """Every decode cell that ``cell_supported`` admits (decode_32k, and
    long_500k for the SSM models), on the production mesh: the cache specs
    of ``decode_cache_specs`` equal JAX's (rows over the batch axes, the KV
    positions and the SSM ``d_inner`` over ``model``), and the cache rank 0
    holds (``init_decode_cache`` under the context) is the global cache cut
    by them."""
    proc = subprocess.run([sys.executable, "-c", PORT_CACHES, mesh_kind], capture_output=True, text=True,
                          env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    shape = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}[mesh_kind]
    want = {k: v for k, v in jax_side["jax"]["cache_specs"].items() if k[2] == mesh_kind}
    assert sorted(got) == sorted(f"{a} {s}" for a, s, _ in want) and len(got) >= 10
    split = set()
    for (arch, shp, _), jslots in want.items():
        cell = got[f"{arch} {shp}"]
        assert set(cell) == set(jslots)
        for slot, (whole, local, specs) in cell.items():
            for g, l, sp, jsp in zip(whole, local, specs, jslots[slot]):
                entries = _norm_spec(sp, len(g))
                assert entries == _norm_spec(jsp, len(g)), (arch, shp, slot, sp, jsp)
                cut = [n // int(np.prod([shape[a] for a in e])) for n, e in zip(g, entries)]
                assert l == cut, (arch, shp, slot, g, l, entries)
                split.update(a for e in entries[2:] for a in e)
    assert split == {"model"}   # the positions or d_inner of some cell over model, nothing else


def test_decode_cell_gathers_no_whole_weights(tmp_path):
    """olmoe_1b_7b's decode_32k on the single-pod mesh: the step's own
    memory stays below one model rank's share of the whole bf16 weights (no
    weight is gathered: the activations move), and the cache rank 0 holds
    is its 1/16 of the rows and of the positions."""
    rec = _port_cell(tmp_path, "--arch", "olmoe_1b_7b", "--shape", "decode_32k", "--mesh", "single")
    from repro_torch.launch.dryrun import cell_config

    cfg = cell_config("olmoe_1b_7b", "decode_32k")
    whole = 2 * cfg.param_count()
    assert rec["peak_categories"]["Activation"] < whole / 16, rec["peak_categories"]
    assert rec["persistent_bytes"]["params"] < whole / 128
    seq, gb = 32768, rec["global_batch"]
    kv = cfg.n_layers * gb * seq * cfg.n_kv_heads * cfg.hd * 2 * 2
    # k and v in bf16; each layer's fill index and the two (1,) f32 scale placeholders whole
    assert rec["persistent_bytes"]["cache"] == kv // 256 + cfg.n_layers * 12
    assert rec["regions"]["decode_attn"] == {"parallel": cfg.n_layers, "fallback": 0}
    assert rec["regions"]["decode_moe"] == {"parallel": cfg.n_layers, "fallback": 0}
    assert rec["fits"] and "gathered whole" not in rec["decode_layout"]


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "falcon_mamba_7b"])
def test_reduced_decode_cell_equals_the_mesh_step(tmp_path, arch):
    """A reduced decode cell on a (2, 2) mesh (``--mesh-shape 2,2 --reduced
    --seq 32 --batch 4``): its bytes a rank (parameter shards and cache
    block) and its collectives (calls and bytes by kind) equal those of the
    same step on 4 gloo CPU ranks; its predicted launches are B15 once a
    Mamba layer (the CPU runs the scan's plain twin and launches nothing)."""
    import _torch_ranks as ranks

    from repro_torch.configs import get_reduced

    rec = _port_cell(tmp_path, "--arch", arch, "--reduced", "--shape", "decode_32k", "--seq", "32", "--batch", "4",
                     "--mesh-shape", "2,2")
    steps = ranks.run_ranks(ranks.decode_cell_step, tmp_path, arch, 32, 4)
    cfg = get_reduced(arch)
    for r in steps:
        assert r["bytes"] == rec["persistent_bytes"], (r["coords"], r["bytes"], rec["persistent_bytes"])
        assert r["collectives"] == rec["collectives"], (r["coords"], r["collectives"], rec["collectives"])
        assert r["launches"] == {}
    mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_periods
    assert rec["launches"] == ({"ssm_scan": mamba} if mamba else {})
    assert rec["collectives"]["psum"]["calls"] > 0   # the regions' partial sums over model


def test_train_cell_counts_the_held_shards_once(tmp_path):
    """A reduced train cell on a (2, 2) mesh: the dry run's peak within 5 %
    of the same step's on 4 gloo CPU ranks, where the rank's parameter and
    optimizer-state storages are counted once however the step views them
    (the dry run counted them again at each view: 1.28x)."""
    import _torch_ranks as ranks

    rec = _port_cell(tmp_path, "--arch", "gpt_small", "--reduced", "--shape", "train_4k", "--seq", "32", "--batch",
                     "8", "--mesh-shape", "2,2", "--grad-accum", "1", "--backend", "fused")
    steps = ranks.run_ranks(ranks.train_cell_peak, tmp_path, "gpt_small", 32, 8)
    for r in steps:
        assert r["bytes"] == rec["persistent_bytes"], (r["coords"], r["bytes"], rec["persistent_bytes"])
        assert 0.95 <= rec["peak_bytes"] / r["peak"] <= 1.05, (r["coords"], rec["peak_bytes"], r["peak"])
