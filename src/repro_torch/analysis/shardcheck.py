"""shardcheck — ``ShardLeafPlan`` geometry over the config zoo x mesh
matrix (a port of ``repro/analysis/shardcheck.py``).

All on the device-free :class:`repro_torch.sharding.shardspec.SpecMesh`:
every arch is abstracted on ``meta`` (``cfg.abstract()``: nothing
allocated), its Table-3 dims and logical parameter specs derived, and every
leaf planned on every mesh of the matrix. Checked contracts:

  * **owner-all-or-nothing** — a psum leaf's owner placement covers every
    non-trivial psum axis or none. A partial placement is wrong: shards
    along an unplaced axis each add an identical ``b2 * v`` copy into the
    all-reduce, inflating the moment.
  * **owner-even** — each placed axis divides its dim's remaining local
    extent, replayed in placement order, and ``nu_spec`` realises the whole
    ``owner_factor``.
  * **psum-jnp-zero** — no psum leaf on the production (data=16, model=16)
    mesh falls off the partial-stats/finalize kernel pair (B10/B11, B12/B13).
  * **plan-cn** — ``finalize == 'kernel'`` iff the plan carries the local
    ``CanonND`` the dispatcher replays.
  * **state-mirror** — ``opt_state_specs`` accepts the (optimizer state,
    parameters, specs) triple with owner-mesh resolution on.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import torch

from ..configs import ARCH_IDS, get_config
from ..core import rules_as_tree, table3_rules
from ..core.slim_adam import slim_adam
from ..sharding.logical import ShardingContext, param_specs, use_sharding
from ..sharding.shardspec import (ShardLeafPlan, SpecMesh, local_shape, owner_factor, plan_sharded_leaf,
                                  regime_counts, spec_entries)
from ..sharding.state_shardings import opt_state_specs
from .report import PassResult

# The production 16x16 mesh (the psum_jnp == 0 promise), pure FSDP, and an
# asymmetric FSDP x TP shape with non-square owner factors.
MESHES: Tuple[Tuple[str, Dict[str, int]], ...] = (
    ("prod-16x16", {"data": 16, "model": 16}),
    ("fsdp-8", {"data": 8}),
    ("asym-4x8", {"data": 4, "model": 8}),
)

PROD_MESH = MESHES[0][0]


def arch_leaves(arch: str):
    """(cfg, parameters on ``meta``, meta, Table-3 dims) of one arch, its
    parameters in bf16 as the JAX pass abstracts them."""
    cfg = get_config(arch, param_dtype=torch.bfloat16)
    params_abs, meta = cfg.abstract()
    dims = rules_as_tree(table3_rules(meta), params_abs, meta)
    return cfg, params_abs, meta, dims


def check_leaf_plan(plan: ShardLeafPlan, shape, dims, mesh, result: PassResult, where: str) -> None:
    """The per-leaf geometry contracts (reusable on hand-built plans)."""
    sizes = dict(mesh.shape)
    dset = {d % len(shape) for d in dims}
    red_shape = tuple(1 if i in dset else s for i, s in enumerate(shape))

    result.checks += 1
    if plan.regime == "psum" and (plan.finalize == "kernel") != (plan.cn is not None):
        result.add("plan-cn", where, f"finalize={plan.finalize!r} but cn is "
                                     f"{'set' if plan.cn is not None else 'missing'}: the dispatcher would replay a "
                                     f"plan the gate never approved")
    if plan.regime != "psum":
        return

    nontrivial = {a for a in plan.psum_axes if int(sizes.get(a, 1)) > 1}
    placed = {a for a, _ in plan.owner}
    result.checks += 1
    if plan.owner and placed != nontrivial:
        result.add("owner-all-or-nothing", where,
                   f"owner placement covers axes {sorted(placed)} but the psum group is {sorted(nontrivial)}: a "
                   f"partial placement inflates the moment by each unplaced axis's size")
    if not plan.owner:
        return

    result.checks += 1
    entries = spec_entries(plan.red_spec, len(red_shape))
    local = [s // math.prod(int(sizes.get(a, 1)) for a in e) for s, e in zip(red_shape, entries)]
    for a, d in plan.owner:
        f = int(sizes.get(a, 1))
        if local[d] <= 1 or local[d] % f:
            result.add("owner-even", where, f"owner axis {a!r} (size {f}) placed on dim {d} whose remaining local "
                                            f"extent {local[d]} it does not divide")
            return
        local[d] //= f

    result.checks += 1
    a_factor = owner_factor(plan, mesh)
    red_local = local_shape(red_shape, plan.red_spec, mesh)
    nu_local = local_shape(red_shape, plan.nu_spec, mesh)
    if math.prod(nu_local) * a_factor != math.prod(red_local):
        result.add("owner-even", where, f"nu_spec realises a {math.prod(red_local) // max(1, math.prod(nu_local))}x "
                                        f"dedupe but owner placement claims {a_factor}x: a spec entry fell back to "
                                        f"replicated")


def run() -> PassResult:
    t0 = time.monotonic()
    result = PassResult("shardcheck")
    counts_by_mesh: Dict[str, Dict[str, int]] = {}
    for arch in ARCH_IDS:
        cfg, params_abs, meta, dims = arch_leaves(arch)
        opt_abs = slim_adam(3e-4, dims).init(params_abs)
        for mesh_name, mesh_shape in MESHES:
            mesh = SpecMesh(mesh_shape)
            with use_sharding(ShardingContext(mesh, rules=dict(cfg.sharding_overrides) or None)):
                p_specs = param_specs(meta, params_abs)
            plans: List[ShardLeafPlan] = []
            for name, leaf in params_abs.items():
                plan = plan_sharded_leaf(tuple(leaf.shape), leaf.dtype, tuple(dims[name]), p_specs[name], mesh)
                plans.append(plan)
                check_leaf_plan(plan, tuple(leaf.shape), tuple(dims[name]), mesh, result, f"{arch}/{mesh_name}/{name}")
            counts = regime_counts(plans)
            agg = counts_by_mesh.setdefault(mesh_name, {})
            for k, v in counts.items():
                agg[k] = agg.get(k, 0) + v
            result.checks += 1
            if mesh_name == PROD_MESH and counts["psum_jnp"]:
                result.add("psum-jnp-zero", f"{arch}/{mesh_name}",
                           f"{counts['psum_jnp']} psum leaves fell off the partial-stats/finalize kernel pair on the "
                           f"production mesh (counts: {counts})")
            result.checks += 1
            try:
                opt_state_specs(opt_abs, params_abs, p_specs, owner_mesh=mesh)
            except Exception as e:  # noqa: BLE001 - any failure is a finding
                result.add("state-mirror", f"{arch}/{mesh_name}",
                           f"opt_state_specs rejected the state/param/spec triple: {e}")
    result.detail = "; ".join(f"{m}: " + " ".join(f"{k}={v}" for k, v in sorted(c.items()) if v)
                              for m, c in counts_by_mesh.items())
    result.seconds = time.monotonic() - t0
    return result
