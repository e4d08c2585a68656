"""Dry run of one (arch x shape x mesh) cell on the ``meta`` device (port of
``repro/launch/dryrun.py``): whether the cell fits one H100 a rank, and
what one step costs a rank, without running it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek_67b \\
        --shape train_4k --mesh single --optimizer slim
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Needs no GPU. The process becomes rank 0 of the production mesh, (data=16,
model=16) or (pod=2, data=16, model=16), over PyTorch's ``fake`` process
group (``launch.mesh.fake_world``: its collectives move no data), and runs
the cell's step once on ``meta`` tensors, which hold no data:

* train: ``launch.train.build``'s state (the parameters and the optimizer
  state as this rank's shards, exactly what the launcher holds) and its
  step, built with ``grad_shardings``; ``grad_accum`` from
  :func:`pick_grad_accum` unless given;
* prefill: the forward over this rank's rows, argmax of the logits;
* decode: ``train.step.make_serve_step`` in JAX's decode layout
  (``repro/launch/dryrun.py:204-217``): this rank's block of the decode
  cache under :func:`decode_cache_specs` (rows over the batch axes, the KV
  caches' positions and the SSM states' ``d_inner`` over ``model``), the
  stored shards read where they lie (``sharding.logical.dot``: activations
  move over ``data`` and ``model``, no weight is gathered). ``--seq`` and
  ``--batch`` size the cache and the rows.

The record (JSON, under ``build/dryrun/`` by default, never under
``benchmarks/``): the cell's status (skips by ``cell_supported``),
``n_params``, ``grad_accum``, the config's ``sharding_overrides``,
optimizer and backend; the rank's persistent bytes (``reckon_bytes``; a
decode cell's parameter shards and its block of the cache), the
peak of one step a rank by category (``torch.distributed._tools
.mem_tracker.MemTracker`` over the step, the persistent bytes tracked
from its start)
and whether it fits the card's memory; matmul FLOPs a rank
(``torch.utils.flop_counter.FlopCounterMode``, the counterpart of JAX's
``hlo_dot_flops_per_dev``); the bytes every operation reads and writes;
the collectives' calls and bytes by kind (``Mesh.collective_stats``); the
kernel launches the card would make (the wrappers' calls on ``meta``,
``kernels.meta_call_counts``: nothing is launched); ``model_flops_global``/``_per_dev``, ``useful_flops_ratio`` and
the roofline terms with the card's constants (``launch.mesh``).

These are reckonings on ``meta`` for the card named there, not times: no
number here was measured on a device. Reduced and custom cells
(``--reduced``, ``--seq``, ``--batch``, ``--mesh-shape``; ``cfg=`` from
Python) size the configurations a test or ``chip_smoke.py`` runs, on their
own meshes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

from ..configs import ARCH_IDS, SHAPES, cell_supported, get_config, get_reduced, input_specs
from ..models.transformer import decode_cache_specs  # noqa: F401 — JAX's name, ``repro.launch.dryrun``'s
from ..sharding.shardspec import PartitionSpec as P
from . import mesh as mesh_mod

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# pick_grad_accum's default budget: JAX's 3 GiB of its chip's 16 GiB, the
# same share of the card's memory (the derivation is in its docstring)
DEFAULT_BUDGET = mesh_mod.HBM_PER_GPU * 3 // 16

PRODUCTION = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# Sharding assignment
# ---------------------------------------------------------------------------


def batch_specs(ctx, batch_abstract: Dict[str, Any]) -> Dict[str, P]:
    """Each batch leaf's spec: its leading dim over the ``batch`` rule."""
    return {k: ctx.spec_for(["batch"] + [None] * (v.ndim - 1), tuple(v.shape)) for k, v in batch_abstract.items()}


def pick_grad_accum(cfg, shape_name: str, mesh, *, budget: int = DEFAULT_BUDGET,
                    seq: Optional[int] = None, global_batch: Optional[int] = None) -> int:
    """The micro-batch count whose activation estimate fits ``budget``
    bytes: JAX's arithmetic (``repro/launch/dryrun.py:92-131``), the
    estimate's three terms (the layer carries kept for the backward, ~3 f32
    copies of the CE logits, the Mamba slots' full-S f32 residuals), the
    first count of 1, 2, 4, ... 256 that fits and splits the global batch.

    The default budget is JAX's share of the chip's memory, 3 GiB of 16
    (JAX calibrated it: an estimate of 2.9 GiB measured 11.1 GiB with the
    fp32 transients and optimizer temporaries, 3.8x), on the card's
    85,017,493,504 bytes (``torch.cuda.get_device_properties(0)
    .total_memory`` on an NVIDIA H100 80GB HBM3 at 700.00 W): 14.84 GiB.
    The card's own measurement gives the same factor: falcon_mamba_7b cut
    to 8 layers, 2 x 2048, bf16, Table-3 SlimAdam on one card (chip_smoke
    phase 7g, PERF.md §5) peaked at 28.80 GiB, 20.54 GiB of it above the
    parameters and first moments (8.26 GiB), against this estimate's 5.48
    GiB: 3.75x. A full budget then reaches ~55.7 GiB of the step's own
    memory, leaving ~23.5 GiB of the card's 79.18 GiB for the persistent
    shards, the same 30 % JAX leaves."""
    seq_, gb, kind = SHAPES[shape_name]
    seq = seq_ if seq is None else seq
    gb = gb if global_batch is None else global_batch
    if kind != "train":
        return 1
    n_dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    n_tp = mesh.shape.get("model", 1)
    extra = 2.0 if any(s.mixer == "mamba" for s in cfg.pattern) else 1.0
    # sequence parallelism shards the carries and the CE logits' sequence
    sp = n_tp if seq % n_tp == 0 else 1
    mamba_slots = sum(1 for s in cfg.pattern if s.mixer == "mamba")
    d_inner = cfg.ssm_expand * cfg.d_model
    d_inner_local = d_inner // n_tp if d_inner % n_tp == 0 else d_inner
    for accum in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        b_local = max(gb // accum // n_dp, 1)
        carries = cfg.n_layers * b_local * (seq // sp) * cfg.d_model * 2 * extra
        ce = 3 * b_local * (seq // sp) * cfg.vocab_size * 4
        ssm_live = mamba_slots * b_local * seq * d_inner_local * 64
        if carries + ce + ssm_live <= budget and gb % accum == 0 and (gb // accum) >= n_dp:
            return accum
    return 256


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------


def cell_config(arch: str, shape: str, *, variant: str = "default", reduced: bool = False,
                seq: Optional[int] = None):
    """The cell's config, as JAX's ``build_cell`` makes it: the full (or
    reduced, or ``optimized()``) config with bf16 parameters, the
    learned-position table widened to the sequence where it is shorter."""
    if variant == "optimized":
        from ..configs import get_optimized

        cfg = get_optimized(arch, reduced=reduced)
    elif variant == "default":
        cfg = get_reduced(arch) if reduced else get_config(arch)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    seq = SHAPES[shape][0] if seq is None else seq
    if cfg.pos == "learned" and cfg.max_position < seq + 1:
        # the paper's GPT has a 1024-position table; longer cells need more
        cfg = dataclasses.replace(cfg, max_position=seq + 1)
    return cfg


def build_cell(arch: str, shape: str, mesh, *, optimizer: str = "slim", grad_accum: Optional[int] = None,
               variant: str = "default", backend: str = "jnp", cfg=None, seq: Optional[int] = None,
               global_batch: Optional[int] = None, cache_dtype=torch.bfloat16):
    """(step, its arguments, the sharding context, info, cfg): the cell's
    step on ``mesh`` (a ``launch.mesh.Mesh`` on ``meta``) and its abstract
    inputs, as ``repro/launch/dryrun.py:134-222`` builds them. ``cfg``
    replaces :func:`cell_config`'s; ``seq``/``global_batch`` replace the
    shape's; ``cache_dtype`` is a decode cell's KV cache's (JAX's
    ``decode_input_specs``: bf16). ``info`` holds ``persistent`` (the rank's
    bytes of parameter and optimizer-state shards, checked against
    ``reckon_bytes``)."""
    from ..launch import train as launch
    from ..models import transformer
    from ..sharding import ShardingContext, use_sharding
    from ..train.step import make_serve_step

    seq_, gb_, kind = SHAPES[shape]
    seq = seq_ if seq is None else seq
    gb = gb_ if global_batch is None else global_batch
    cfg = cfg if cfg is not None else cell_config(arch, shape, variant=variant, seq=seq)
    ctx = ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)
    info: Dict[str, Any] = {"arch": arch, "shape": shape, "kind": kind, "seq": seq, "global_batch": gb,
                            "sharding_overrides": {k: v for k, v in cfg.sharding_overrides}}
    with use_sharding(ctx):
        abstract, meta = cfg.abstract()
        info["n_params"] = sum(math.prod(p.shape) for p in abstract.values())
        if kind == "train":
            batch = {k: torch.empty((gb,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
                     for k, v in input_specs(cfg, shape).items()}
            if seq != seq_:
                batch = {k: torch.empty((gb, seq) + tuple(v.shape[2:]), dtype=v.dtype, device="meta")
                         for k, v in batch.items()}
            accum = grad_accum or pick_grad_accum(cfg, shape, mesh, seq=seq, global_batch=gb)
            name = "slim" if optimizer == "slim" else "adam"
            run = launch.build(cfg, name, 3e-4, mesh, backend=backend, grad_accum=accum)
            held = run.persistent_bytes()
            reckoned = launch.reckon_bytes(cfg, name, 3e-4, mesh, backend=backend)
            if held != reckoned:
                raise AssertionError(f"{arch} {shape}: the rank holds {held} bytes, reckoned {reckoned}")
            info.update(optimizer="slim_adam(table3)" if name == "slim" else "adamw", opt_backend=backend,
                        grad_accum=accum, persistent=held)
            # counted in the step's peak from its start ('Other'): the step reads the parameter and
            # optimizer-state shards through views, which would otherwise count each again
            info["held"] = list(run.model.params.values()) + _tensors(run.opt_state)
            return run.step, (run.opt_state, batch), ctx, info, cfg
        stored = launch.stored_weights(cfg, mesh)
        info["persistent"] = {"params": sum(t.numel() * t.element_size() for t in stored.values()), "opt": 0}
        if kind == "prefill":
            if seq != seq_ or gb != gb_:
                raise ValueError("a prefill cell takes its shape's sequence and batch")
            batch = input_specs(cfg, shape)
            batch = {k: mesh.shard(batch[k], s) for k, s in batch_specs(ctx, batch).items()}

            def prefill(batch):
                with torch.no_grad():
                    logits, _ = transformer.forward(cfg, stored, batch)
                return torch.argmax(logits, dim=-1).to(torch.int32)

            return prefill, (batch,), ctx, info, cfg
        # decode: JAX's layout, this rank's block of the cache (init_decode_cache
        # under the context cuts it by decode_cache_specs)
        cache = transformer.abstract_decode_cache(cfg, gb, seq, cache_dtype)
        tokens = mesh.shard(torch.empty((gb, 1), dtype=torch.int32, device="meta"),
                            ctx.spec_for(("batch", None), (gb, 1)))
        info["persistent"]["cache"] = sum(t.numel() * t.element_size() for c in cache.slots.values() for t in c)
        info["decode_layout"] = ("rows over the batch axes; KV positions (seq_kv) and SSM d_inner over model; "
                                 "the stored shards read where they lie, activations moved, no weight gathered")
        # counted in the step's peak from its start ('Other'), however the step touches them
        info["held"] = list(stored.values()) + _tensors(cache)
        serve = make_serve_step(cfg)

        def decode(cache, tokens):
            return serve(stored, cache, tokens)

        return decode, (cache, tokens), ctx, info, cfg


def model_flops_estimate(cfg, info) -> float:
    """MODEL_FLOPS (global): 6 N D for a train step, 2 N D otherwise, with
    an MoE's expert parameters scaled by top_k / n_experts (JAX's
    ``dryrun.py:225``)."""
    n = info["n_params"]
    _, _, kind = SHAPES[info["shape"]]
    seq, gb = info["seq"], info["global_batch"]
    if cfg.n_experts:
        from ..core.labels import flatten_with_names

        params_abs, meta = cfg.abstract()
        metas = dict(flatten_with_names(meta))
        total = expert = 0
        for name, p in flatten_with_names(params_abs):
            sz = math.prod(p.shape)
            total += sz
            if "experts" in metas[name].axes and metas[name].role != "moe_router":
                expert += sz
        n = total - expert + expert * cfg.top_k / cfg.n_experts
    tokens = seq * gb if kind != "decode" else gb
    return (6.0 if kind == "train" else 2.0) * n * tokens


# ---------------------------------------------------------------------------
# One step on meta, counted
# ---------------------------------------------------------------------------


class _Traffic:
    """A dispatch mode summing the bytes every non-view operation reads and
    writes (each tensor input once, each output once): the memory term of
    the roofline, unfused, as HLO's ``traffic_bytes`` counts per
    instruction."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not getattr(func, "is_view", False) and func.namespace == "aten":
                    outer.bytes += sum(t.numel() * t.element_size() for t in _tensors((args, kwargs, out)))
                return out

        self.bytes = 0
        self.mode = Mode()


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def measure(fn, args, mesh, held=()) -> Dict[str, Any]:
    """Run ``fn(*args)`` once on ``meta`` under the counters: matmul FLOPs,
    bytes moved, the peak of the memory the step allocates by category
    (with the tensors of ``held``, the parameter and optimizer-state
    shards or a decode cell's stored shards and cache, counted from the
    start as 'Other': a view of a tensor made
    before the step would otherwise count it once it is touched), the
    collectives by kind and the kernel wrappers' calls on ``meta``, the
    launches the card would make (each reset first)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from .. import kernels
    from ..sharding import logical

    kernels.reset_launch_counts()
    mesh.collective_stats(reset=True)
    logical.region_counts(reset=True)
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    mem = MemTracker()
    if held:
        mem.track_external(*held)
    t0 = time.perf_counter()
    with mem, flops, traffic.mode:
        fn(*args)
    seconds = time.perf_counter() - t0
    snap = mem.get_tracker_snapshot("peak")
    dev = snap.get(torch.device("meta"), next(iter(snap.values()), {}))
    categories = {str(getattr(k, "value", k)): int(v) for k, v in dev.items() if k != "Total"}
    return {"dot_flops": int(flops.get_total_flops()), "traffic_bytes": int(traffic.bytes),
            "step_peak": int(dev.get("Total", 0)), "step_categories": categories,
            "collectives": {k: {"calls": int(v["calls"]), "bytes": int(v["bytes"])}
                            for k, v in mesh.collective_stats(reset=True).items()},
            "launches": {k: v for k, v in kernels.meta_call_counts().items() if v},
            "regions": logical.region_counts(reset=True), "step_s": seconds}


def make_meta_mesh(shape: Sequence[int], axes: Sequence[str]):
    """Rank 0 of a ``prod(shape)``-rank mesh over the fake group, on ``meta``
    (the process's one default group: call once a process)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        mesh_mod.fake_world(math.prod(shape))
    return mesh_mod.make_mesh(tuple(shape), tuple(axes), device="meta")


def run_cell(arch: str, shape: str, mesh_kind: str, *, optimizer: str = "slim", grad_accum: Optional[int] = None,
             out_dir: Optional[Path] = RESULTS_DIR, variant: str = "default", backend: str = "jnp", mesh=None,
             **cell_kw) -> Dict[str, Any]:
    """The record of one cell (see the module docstring); written to
    ``out_dir`` (None: not written). ``mesh``: a meta mesh to run on
    (default: the production mesh of ``mesh_kind``); ``cell_kw``: what
    :func:`cell_config` and :func:`build_cell` take to cut the cell, or
    ``cfg=`` a config to run as it is."""
    ok, reason = cell_supported(arch, shape)
    record: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if not ok:
        record.update(status="skipped", reason=reason)
        return record
    if mesh is None:
        mesh = make_meta_mesh(*PRODUCTION[mesh_kind])
    reduced = cell_kw.pop("reduced", False)
    t0 = time.perf_counter()
    cfg = cell_kw.pop("cfg", None) or cell_config(arch, shape, variant=variant, reduced=reduced,
                                                  seq=cell_kw.get("seq"))
    fn, args, ctx, info, cfg = build_cell(arch, shape, mesh, optimizer=optimizer, grad_accum=grad_accum,
                                          variant=variant, backend=backend, cfg=cfg, **cell_kw)
    from ..sharding import use_sharding

    held = info.pop("held", ())
    with use_sharding(ctx):
        counted = measure(fn, args, mesh, held)
    record.update(info)
    n_chips = mesh.size
    persistent = info.pop("persistent")
    record.pop("persistent", None)
    # the step's peak counts the held shards (and a decode cell's cache) from the start
    peak = counted["step_peak"]
    record.update(status="ok", n_chips=n_chips, mesh_shape=dict(mesh.shape), card=mesh_mod.CARD,
                  build_s=round(time.perf_counter() - t0 - counted["step_s"], 2), step_s=round(counted["step_s"], 2),
                  persistent_bytes=persistent, peak_bytes=peak, peak_categories=counted["step_categories"],
                  fits=bool(peak <= mesh_mod.HBM_PER_GPU), dot_flops_per_dev=counted["dot_flops"],
                  traffic_bytes_per_dev=counted["traffic_bytes"], collectives=counted["collectives"],
                  launches=counted["launches"], regions=counted["regions"],
                  cuda_initialized=torch.cuda.is_initialized())
    compute_t = counted["dot_flops"] / mesh_mod.PEAK_FLOPS_BF16
    memory_t = counted["traffic_bytes"] / mesh_mod.HBM_BW
    collective_t = sum(v["bytes"] for v in counted["collectives"].values()) / mesh_mod.LINK_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t, "collective_s": collective_t}
    record["roofline"] = dict(terms, dominant=max(terms, key=terms.get)[:-2])
    mf = model_flops_estimate(cfg, record)
    record["model_flops_global"] = mf
    record["model_flops_per_dev"] = mf / n_chips
    if counted["dot_flops"] > 0:
        record["useful_flops_ratio"] = (mf / n_chips) / counted["dot_flops"]
        bound = max(terms.values())
        record["roofline_fraction"] = (mf / n_chips / mesh_mod.PEAK_FLOPS_BF16) / bound if bound > 0 else 0.0
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = "" if optimizer == "slim" else f"_{optimizer}"
        if variant != "default":
            suffix += f"_{variant}"
        if backend != "jnp":
            suffix += f"_{backend}"
        out_path = Path(out_dir) / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
        out_path.write_text(json.dumps(record, indent=2, default=str))
        record["out_path"] = str(out_path)
    return record


def list_cells() -> str:
    """JAX's RUN/SKIP table of every (arch, shape)."""
    lines = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, reason = cell_supported(arch, shape)
            lines.append(f"{arch:22s} {shape:12s} {'RUN' if ok else 'SKIP: ' + reason}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, required=False)
    ap.add_argument("--shape", choices=list(SHAPES), required=False)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--optimizer", choices=("slim", "adam"), default="slim")
    ap.add_argument("--backend", choices=("jnp", "fused"), default="jnp",
                    help="optimizer route; 'fused' counts the kernels' predicted launches on the shards")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--variant", default="default")
    ap.add_argument("--list", action="store_true", help="list all runnable cells")
    ap.add_argument("--out", default=str(RESULTS_DIR), help="directory of the JSON records")
    # a cut or custom cell (tests, chip_smoke)
    ap.add_argument("--mesh-shape", default=None, help="e.g. 2,2: a mesh of that shape over the production axes")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None, help="global batch")
    args = ap.parse_args(argv)

    if args.list:
        print(list_cells())
        return 0
    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape are required without --list")
    mesh = None
    kind = args.mesh
    if args.mesh_shape:
        shape = tuple(int(s) for s in args.mesh_shape.split(","))
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = make_meta_mesh(shape, axes) if cell_supported(args.arch, args.shape)[0] else None
        kind = "x".join(map(str, shape))
    rec = run_cell(args.arch, args.shape, kind, optimizer=args.optimizer, grad_accum=args.grad_accum,
                   out_dir=Path(args.out), variant=args.variant, backend=args.backend, mesh=mesh,
                   reduced=args.reduced, seq=args.seq, global_batch=args.batch)
    print(json.dumps(rec, indent=2, default=str))
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
