"""The port's forward on a (data=2, model=2) mesh of 4 gloo CPU processes
(``_torch_ranks.run_ranks``) against the port unsharded and the JAX
package on ``jax.make_mesh((2, 2), ..., axis_types=(AxisType.Auto,) * 2)``
(one oracle subprocess with 4 forced host devices), from the same numpy
inputs, in f32:

* each tensor-, sequence- and expert-parallel layer on x cut to each
  rank's rows and part of the sequence, the weights whole: the dense MLP
  gated and not, attention with ``kv % tp == 0`` and with ``kv < tp``, the
  Mamba mixer (the plain scan twin on the CPU) and the MoE (G = 2 groups,
  experts over ``model``). Outputs, the aux loss and the gradients of x and
  of every parameter (summed over the ranks) within 1e-5 of the port
  unsharded (the MoE under a ``SpecMesh``, for its groups), of the split
  form (``_torch_split``: the model ranks' partial sums added in one
  process), and of JAX's layer under the mesh; with bf16 activations within
  one bf16 rounding step of the split form, and of JAX's bf16 layer under
  the mesh or twice the two packages' unsharded bf16 gap where that is
  more; every region taken in its parallel form;
* reduced gpt_small (3 heads: its attention takes JAX's whole-region
  fallback, counted), olmoe_1b_7b and falcon_mamba_7b through the sharded
  trainer (Adam, the fused backend) against JAX's sharded ``Trainer`` from
  the same initial parameters: losses within 1e-4; the Trainer under a
  ``SpecMesh`` (unsharded, the mesh's MoE groups) too; gpt_small and
  olmoe on 31 positions, which the model axis does not divide (every
  region whole, each rank scoring its own positions), against the port
  unsharded (1e-5); reduced internvl2_26b's loss on its text positions and
  every gradient on the mesh against unsharded, in both layouts (1e-5);
* moment-less SlimAdam (``use_first_moment=False``) on the owner-parity
  leaf set of ``test_torch_sharded.py``: u and each rank's nu shards
  against JAX's sharded run within 1e-5, no first moment kept.
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import _torch_split
from _torch_parity import assert_close, jax_params
from test_torch_sharded import DIMS, SHAPES, SPECS, _inputs, _nu_spec, _slice

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
B, S, D = 4, 8, 16
ARCHS = ("gpt_small", "olmoe_1b_7b", "falcon_mamba_7b")
DATA = dict(seq_len=32, global_batch=4, seed=5)
LR, STEPS = 3e-3, 3
MOMENTLESS_STEPS = 3
# A sequence the model axis does not divide: the ranks of a model group hold
# it whole (JAX's fallback in every region) and score their own positions.
WHOLE = ("gpt_small", "olmoe_1b_7b")
WHOLE_DATA = dict(seq_len=31, global_batch=4, seed=6)
BF16 = ("mlp_gated", "attn_kv2", "attn_kv1", "ssm")
# bf16 activations: the mesh, JAX's mesh and the split form add bf16 partial
# sums, but each product's f32 accumulation may block differently over the
# rows a rank holds, the rows the one process holds and XLA's; one bf16
# rounding step of the output's largest magnitude (7 fraction bits) bounds
# the difference.
TOL_BF16 = 2.0**-7


def _params(kind, rng):
    n = lambda *shape: (0.2 * rng.standard_normal(shape)).astype(np.float32)   # noqa: E731
    if kind == "mlp":
        return {"w_up": n(D, 32), "w_down": n(32, D), "w_gate": n(D, 32)}
    if kind.startswith("attn"):
        kv = 2 if kind == "attn_kv2" else 1
        return {"wq": n(D, 4, 8), "wk": n(D, kv, 8), "wv": n(D, kv, 8), "wo": n(4, 8, D)}
    if kind == "ssm":
        di, st = 32, 4
        return {"in_proj": n(D, 2 * di), "conv_w": n(di, 4), "conv_b": n(di), "x_proj": n(di, 1 + 2 * st),
                "dt_proj": n(1, di), "dt_bias": (0.1 * rng.standard_normal(di) - 2.0).astype(np.float32),
                "a_log": np.log(np.tile(np.arange(1, st + 1, dtype=np.float32), (di, 1))), "d_skip": n(di),
                "out_proj": n(di, D)}
    e, f = 4, 16
    return {"router": (rng.standard_normal((D, e))).astype(np.float32), "w_up": n(e, D, f), "w_down": n(e, f, D),
            "w_gate": n(e, D, f)}


def _cases():
    """{name: dict(kind, cfg, jcfg, params, x, w)}: the layer's config for
    the port and, where it differs, for JAX."""
    rng = np.random.default_rng(29)
    attn = dict(d_model=D, n_heads=4, head_dim=8)
    specs = {
        "mlp_gated": ("mlp", dict(gated=True), S),
        "mlp_gelu": ("mlp", dict(gated=False), S),
        "attn_kv2": ("attn", dict(attn, n_kv_heads=2), S),
        "attn_kv1": ("attn", dict(attn, n_kv_heads=1), S),
        "ssm": ("ssm", dict(d_model=D, d_inner=32, d_state=4, d_conv=4), S),
        # 64 tokens a group: capacity 20 of 32 per expert, so tokens drop
        "moe": ("moe", dict(n_experts=4, top_k=2, d_model=D, d_ff=16, capacity_factor=0.6), 32),
    }
    out = {}
    for name, (kind, cfg, s) in specs.items():
        p = _params(name if kind == "attn" else kind, rng)
        if name == "mlp_gelu":
            p.pop("w_gate")
        jcfg = dict(cfg, chunk=4) if kind == "ssm" else cfg
        out[name] = dict(kind=kind, cfg=cfg, jcfg=jcfg, params=p,
                         x=rng.standard_normal((B, s, D)).astype(np.float32),
                         w=rng.standard_normal((B, s, D)).astype(np.float32))
    for name in BF16:   # the same layers with bf16 activations
        out[f"{name}_bf16"] = dict(out[name], dtype=torch.bfloat16)
    return out


ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_reduced
from repro.core.slim_adam import scale_by_slim_adam
from repro.data import DataConfig, ZipfLM
from repro.models import attention, mlp_moe, ssm
from repro.sharding.logical import ShardingContext, use_sharding
from repro.train import Trainer, TrainerConfig

work = sys.argv[1]
spec = pickle.load(open(os.path.join(work, "spec.pkl"), "rb"))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {"layers": {}, "whole": {}, "loss": {}}


def layer(kind, cfg):
    if kind == "mlp":
        return lambda p, x: (mlp_moe.mlp_forward(p, x, gated=cfg["gated"]), 0.0)
    if kind == "attn":
        c = attention.AttnConfig(**cfg)
        return lambda p, x: (attention.attention_forward(p, x, c), 0.0)
    if kind == "ssm":
        c = ssm.SSMConfig(**cfg)
        return lambda p, x: (ssm.ssm_forward(p, x, c), 0.0)
    c = mlp_moe.MoEConfig(**cfg)
    return lambda p, x: mlp_moe.moe_forward(p, x, c)


def run_layer(case):
    fn = layer(case["kind"], case["jcfg"])
    w = jnp.asarray(case["w"])
    act = jnp.bfloat16 if case["bf16"] else jnp.float32

    def loss(x, p):
        y, aux = fn(p, x)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(case["x"], act), {k: jnp.asarray(v) for k, v in case["params"].items()})
    return dict(y=np.asarray(y, np.float32), aux=float(aux), gx=np.asarray(gx, np.float32),
                gp={k: np.asarray(v) for k, v in gp.items()})


for name, case in spec["cases"].items():   # bf16: JAX's layer unsharded too
    if case["bf16"]:
        out["whole"][name] = run_layer(case)
with use_sharding(ShardingContext(mesh)):
    for name, case in spec["cases"].items():
        out["layers"][name] = run_layer(case)
    for arch in spec["archs"]:
        cfg = get_reduced(arch)
        tr = Trainer(cfg, "adam", spec["lr"], ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **spec["data"])),
                     TrainerConfig(total_steps=spec["steps"], log_every=1, seed=0, backend="fused"))
        tr.run()
        out["loss"][arch] = [m["loss"] for m in tr.metrics_log]

grads = {k: jnp.asarray(v) for k, v in spec["grads"].items()}
specs = {k: P(*[tuple(e) if isinstance(e, list) else e for e in v]) for k, v in spec["specs"].items()}
tx = scale_by_slim_adam(spec["dims"], use_first_moment=False, backend="fused", mesh=mesh, param_specs=specs)
state = tx.init({k: jnp.zeros_like(v) for k, v in grads.items()})
for _ in range(spec["momentless_steps"]):
    u, state = jax.jit(tx.update)(grads, state)
out["momentless"] = dict(u={k: np.asarray(v) for k, v in u.items()}, nu={k: np.asarray(v) for k, v in state.nu.items()},
                         mu=state.mu)
pickle.dump(out, open(os.path.join(work, "jax_out.pkl"), "wb"))
print("ok")
"""


def _vlm_batches():
    """Reduced internvl2_26b's batches: 4 frontend rows + 12 text tokens (16
    positions: each model rank's 8 hold 4 or 0 frontend rows), and + 11
    (15 positions, which 2 model ranks do not divide)."""
    rng = np.random.default_rng(3)
    out = {}
    for name, s_text in (("sp", 12), ("whole", 11)):
        tokens = rng.integers(0, 211, (4, s_text)).astype(np.int32)
        out[name] = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
                     "frontend_embeds": rng.standard_normal((4, 4, 64)).astype(np.float32)}
    return out


def _port_layer(case, split=False):
    """The port's layer in one process: unsharded, or in the split form
    over 2 model ranks (the MoE under a ``SpecMesh`` with a ``data`` axis of
    2, for its G = 2 groups): y, aux and the gradients of ``sum(y * w) +
    aux``."""
    from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding

    params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"]).to(case.get("dtype", torch.float32)).requires_grad_(True)
    groups = ShardingContext(SpecMesh({"data": 2})) if case["kind"] == "moe" else None
    with use_sharding(groups), (_torch_split.split_regions(2, rows=2) if split else contextlib.nullcontext()):
        y, aux, grads = ranks.layer_grads(ranks._layer_fn(case["kind"], case["cfg"]), params, x,
                                          torch.from_numpy(case["w"]), 1.0)
    return dict(y=y.detach().float().numpy(), aux=None if aux is None else float(aux.detach()),
                gx=grads[0].float().numpy(), gp={k: g.numpy() for k, g in zip(params, grads[1:])})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle (subprocess) beside the port's 4 ranks."""
    import pickle

    work = tmp_path_factory.mktemp("tp")
    cases = _cases()
    g, _ = _inputs()
    spec = dict(cases=cases, archs=ARCHS, lr=LR, data=DATA, steps=STEPS, grads=g, dims=DIMS, specs=SPECS,
                momentless_steps=MOMENTLESS_STEPS)
    spec["cases"] = {k: {f: v for f, v in c.items() if f != "dtype"} | {"bf16": "dtype" in c}
                     for k, c in cases.items()}
    (work / "spec.pkl").write_bytes(pickle.dumps(spec))
    script = work / "oracle.py"
    script.write_text(ORACLE)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    jax_proc = subprocess.Popen([sys.executable, str(script), str(work)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
    try:
        layers = ranks.run_ranks(ranks.tp_layers, work, {k: {f: v for f, v in c.items() if f != "jcfg"}
                                                         for k, c in cases.items()})
        arrays = {arch: jax_params(seed=0, arch=arch)[3] for arch in ARCHS}
        trainer = ranks.run_ranks(ranks.tp_trainer, work, arrays, DATA, LR, STEPS, timeout_s=240.0)
        momentless = ranks.run_ranks(ranks.momentless_updates, work, g, SPECS, DIMS, MOMENTLESS_STEPS)
        whole = ranks.run_ranks(ranks.tp_trainer, work, {a: arrays[a] for a in WHOLE}, WHOLE_DATA, LR, STEPS)
        vlm = ranks.run_ranks(ranks.vlm_grads, work, _vlm_batches())
        _, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    jax_out = pickle.loads((work / "jax_out.pkl").read_bytes())
    return dict(cases=cases, layers=layers, trainer=trainer, momentless=momentless, jax=jax_out, whole=whole, vlm=vlm,
                port={name: _port_layer(c) for name, c in cases.items()},
                split={name: _port_layer(c, split=True) for name, c in cases.items()})


def _assemble(blocks):
    """The whole (B, S, D) output from the 4 ranks' (rows, sequence) blocks."""
    b, s = blocks[0]["y"].shape[:2]
    out = np.zeros((2 * b, 2 * s) + blocks[0]["y"].shape[2:], np.float32)
    for r in blocks:
        d, m = r["coords"]["data"], r["coords"]["model"]
        out[d * b:(d + 1) * b, m * s:(m + 1) * s] = r["y"]
    return out


LAYERS = ["mlp_gated", "mlp_gelu", "attn_kv2", "attn_kv1", "ssm", "moe"]


def _hold(runs, name, want, tol):
    """The 4 ranks' outputs, aux loss and gradients against ``want``;
    ``tol`` a float, or ``tol(quantity)`` of 'y', 'gx' or a parameter
    name."""
    bar = tol if callable(tol) else (lambda _: tol)
    got = [r[name] | {"coords": r["coords"]} for r in runs["layers"]]
    assert_close(_assemble(got), want["y"], bar("y"), f"{name} y")
    if runs["cases"][name]["kind"] == "moe":
        for r in got:
            np.testing.assert_allclose(r["aux"], want["aux"], rtol=tol)
    for r in got:   # every rank holds the gradients summed over the ranks
        assert_close(r["gx"], want["gx"], bar("gx"), f"{name} dx")
        for k in want["gp"]:
            assert_close(r["gp"][k], want["gp"][k], bar(k), f"{name} d{k}")


def _gap(a, b, what):
    """max|a - b| / max|b| of one quantity of two layer results."""
    x, y = (a["gp"][what], b["gp"][what]) if what in b["gp"] else (a[what], b[what])
    return float(np.abs(x - y).max() / np.abs(y).max())


@pytest.mark.parametrize("name", LAYERS)
@pytest.mark.parametrize("against", ["port", "split", "jax"])
def test_layer_on_the_mesh_matches(runs, name, against):
    """Against the port unsharded, the split form, and JAX's layer under
    the mesh."""
    want = runs["jax"]["layers"][name] if against == "jax" else runs[against][name]
    _hold(runs, name, want, TOL)


@pytest.mark.parametrize("name", BF16)
def test_bf16_layer_on_the_mesh_matches_jax(runs, name):
    """With bf16 activations the mesh reduce-scatters bf16 partial sums, as
    JAX's layer under its (2, 2) mesh does: outputs and gradients within one
    bf16 rounding step of JAX's, or within twice what the two packages' bf16
    layers already differ unsharded where that is more. Both accumulate in
    f32 and round to bf16 at the same operations, but in another order (the
    Mamba scan: JAX's chunked associative form against a sequential one),
    and a gradient summed over tokens that cancel carries a rounding flip
    at the summands' magnitude: unsharded, the SSM's dt_proj gradient is
    1.5e-2 of its largest apart between the packages."""
    key = f"{name}_bf16"
    want, port, jax = runs["jax"]["layers"][key], runs["port"][key], runs["jax"]["whole"][key]
    _hold(runs, key, want, lambda what: max(TOL_BF16, 2 * _gap(port, jax, what)))


@pytest.mark.parametrize("name", BF16)
def test_bf16_layer_on_the_mesh_matches_the_split_form(runs, name):
    """With bf16 activations the mesh's reduce-scattered bf16 partial sums
    are what the split form adds in one process: within one bf16 rounding
    step."""
    _hold(runs, f"{name}_bf16", runs["split"][f"{name}_bf16"], TOL_BF16)


@pytest.mark.parametrize("name", LAYERS + [f"{n}_bf16" for n in BF16])
def test_every_layer_takes_its_parallel_region(runs, name):
    kind = runs["cases"][name]["kind"]
    for r in runs["layers"]:
        assert r[name]["regions"] == {kind: {"parallel": 1, "fallback": 0}}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_trainer_matches_jax(runs, arch):
    want = runs["jax"]["loss"][arch]
    for r in runs["trainer"]:
        assert len(r[arch]["loss"]) == STEPS
        np.testing.assert_allclose(r[arch]["loss"], want, rtol=1e-4)
        assert r[arch]["loss"] == runs["trainer"][0][arch]["loss"]


def test_sharded_trainer_regions(runs):
    """Forward regions a step (no remat in the reduced configs): gpt_small's
    3 heads do not split over 2 model ranks, so its attention takes JAX's
    fallback; every other region its parallel form."""
    layers = {"gpt_small": 3, "olmoe_1b_7b": 2, "falcon_mamba_7b": 4}
    want = {"gpt_small": {"attn": (0, 3), "mlp": (3, 0)}, "olmoe_1b_7b": {"attn": (2, 0), "moe": (2, 0)},
            "falcon_mamba_7b": {"ssm": (4, 0)}}
    for r in runs["trainer"]:
        for arch, kinds in want.items():
            got = {k: (v["parallel"], v["fallback"]) for k, v in r[arch]["regions"].items()}
            assert got == {k: (p * STEPS, f * STEPS) for k, (p, f) in kinds.items()}, (arch, got, layers[arch])


def test_trainer_under_a_spec_mesh_runs_unsharded_with_the_mesh_groups(runs):
    """Under a device-free ``SpecMesh`` of the mesh's shape the Trainer runs
    in one process, unsharded, and its MoE dispatches in the mesh's G = 2
    groups: its losses equal JAX's sharded Trainer's (1e-4)."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_reduced("olmoe_1b_7b")
    with use_sharding(ShardingContext(SpecMesh({"data": 2, "model": 2}))):
        tr = Trainer(cfg, "adam", LR, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **DATA)),
                     TrainerConfig(total_steps=STEPS, log_every=1, seed=0, backend="fused"), device="cpu")
        assert tr.mesh is None and not tr.sharded
        tr.model.load_params(params_from_numpy(jax_params(seed=0, arch="olmoe_1b_7b")[3], "cpu"))
        tr.run()
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log], runs["jax"]["loss"]["olmoe_1b_7b"], rtol=1e-4)


@pytest.mark.parametrize("arch", WHOLE)
def test_sharded_trainer_on_a_sequence_the_model_axis_does_not_divide(runs, arch):
    """31 positions over 2 model ranks: every region runs whole (counted as
    the fallback), each rank scores its 16 or 15 positions, the MoE's
    load-balance sums and its expert-parallel outputs cross the model axis
    on those parts, and the losses equal the port's unsharded run's (the
    MoE's under a ``SpecMesh`` with its G = 2 groups) within 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_reduced(arch)
    with use_sharding(ShardingContext(SpecMesh({"data": 2})) if cfg.n_experts else None):
        tr = Trainer(cfg, "adam", LR, ZipfLM(DataConfig(vocab_size=cfg.vocab_size, **WHOLE_DATA)),
                     TrainerConfig(total_steps=STEPS, log_every=1, seed=0, backend="fused"), device="cpu")
        tr.model.load_params(params_from_numpy(jax_params(seed=0, arch=arch)[3], "cpu"))
        tr.run()
    want = [m["loss"] for m in tr.metrics_log]
    kinds = {"gpt_small": {"attn": "fallback", "mlp": "fallback"}, "olmoe_1b_7b": {"attn": "fallback",
                                                                                     "moe": "parallel"}}[arch]
    for r in runs["whole"]:
        np.testing.assert_allclose(r[arch]["loss"], want, rtol=1e-5)
        got = r[arch]["regions"]
        assert set(got) == set(kinds) and all(got[k][form] == cfg.n_layers * STEPS and got[k]["parallel" if form ==
                                                  "fallback" else "fallback"] == 0 for k, form in kinds.items()), got


@pytest.mark.parametrize("name", ["sp", "whole"])
def test_vlm_loss_on_the_mesh_scores_the_text_positions_once(runs, name):
    """Reduced internvl2_26b with remat: the prepended frontend positions
    lie in one model rank's part, the text in both; each rank scores its
    own text positions and divides by its share of the mesh's, so the
    loss and every gradient equal the unsharded port's (1e-5), in the
    sequence-parallel layout (16 positions) and with the sequence whole (15,
    which the model axis does not divide: every region's fallback)."""
    form = "parallel" if name == "sp" else "fallback"
    for r in runs["vlm"]:
        got = r[name]
        np.testing.assert_allclose(got["loss"][0], got["loss"][1], rtol=1e-5)
        for k, (a, b) in got["grads"].items():
            assert_close(a, b, TOL, k)
        assert got["regions"] == {k: {"parallel": 4 if form == "parallel" else 0,
                                      "fallback": 4 if form == "fallback" else 0} for k in ("attn", "mlp")}


def test_momentless_slim_adam_on_the_mesh_matches_jax(runs):
    jax = runs["jax"]["momentless"]
    assert jax["mu"] is None
    for r in runs["momentless"]:
        assert r["mu"] is None
        for k in SHAPES:
            assert_close(r["u"][k], jax["u"][k], TOL, f"u {k}")
            assert_close(r["nu"][k], _slice(jax["nu"][k], _nu_spec(k), r["coords"]), TOL, f"nu {k}")
    assert all(r["sumsq"] == runs["momentless"][0]["sumsq"] for r in runs["momentless"])
