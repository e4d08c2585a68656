"""races — every output element of a kernel call is written by exactly one
block of one launch (the counterpart of ``repro/analysis/races.py``).

The TPU kernels may share an output block across a sequential grid axis and
read-modify-write it (the ``(2,)`` health accumulator); JAX's pass checks
that such an axis is never ``parallel`` and that the body reads the block.
CUDA blocks run in parallel and in no order, and no port kernel uses
atomics: a sum across blocks goes through a second launch that combines the
blocks' partials in a fixed order (``slim_partial_combine``,
``snr_combine``, ``paged_combine_kernel``, ``health_reduce_kernel``,
``ssm_bwd_combine``). So the contract here is stronger and simpler:

  * **race-once** — every element of every output of a call is written by
    exactly one block of one of its launches (no element twice, none left
    unwritten, none outside the output);
  * **race-workspace** — every slot of a workspace (the f64 shares of a
    split walk, B14's per-piece partials) is written by at most one block.

Decided on the CPU from the plans: for each registry case (on a card of
132 SMs and one of 8, so that the split forms are reached too) and a few
views where the planners split further, the planner's grid is walked with
the kernels' own index arithmetic, as each ``.cu`` file states it, and every
write is counted. The grids are the ones the wrappers launch: each comes
from the planner or sizing function whose numbers the wrapper passes to
its entry point (``plan_slim``, ``plan_split``, ``plan_finalize``,
``plan_paged``, ``megaplan.adam_grid``, ``fused_adam.elementwise_blocks``),
combines included; only a fixed one-block reduce is the source's own. This is the counterpart of ``aliased_grid_dims``
(``repro/analysis/jaxpr_tools.py:310``). On the card, reruns of every
wrapper on the same inputs give equal bits (``chip_smoke.py``'s contracts
phase), which a race would break.

The pass also checks the megaplan's segment tables, as JAX's does: the
grouped launches are race-free only if each group's segments tile its
super-tensor exactly once.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from ..kernels import fused_adam as _fa
from ..kernels import megaplan as _mp
from ..kernels import paged_attention as _pa
from ..kernels import slim_update as _su
from ..kernels import snr_stats as _ss
from . import registry
from .report import PassResult

SMS = (132, 8)
_REDUCE = "reduce"


class Write(NamedTuple):
    """The elements ``index`` of ``output`` that one block of one launch
    writes."""

    launch: str
    block: int
    output: str
    index: np.ndarray


class Owners(NamedTuple):
    """Every write of one call, with the sizes of its outputs and which of
    them are workspaces (at most once) rather than outputs (exactly once)."""

    writes: List[Write]
    sizes: Dict[str, int]
    workspaces: Tuple[str, ...] = ()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _arange(a: int, b: int) -> np.ndarray:
    return np.arange(a, b, dtype=np.int64)


def check_owners(owners: Owners, result: PassResult, where: str) -> None:
    """race-once and race-workspace over one call's writes."""
    by_out: Dict[str, List[Write]] = {}
    for w in owners.writes:
        if w.output not in owners.sizes:
            result.checks += 1
            result.add("race-once", where, f"launch {w.launch} block {w.block} writes {w.output!r}, which the "
                                           f"call does not output")
            continue
        by_out.setdefault(w.output, []).append(w)
    for name, size in sorted(owners.sizes.items()):
        result.checks += 1
        ws = by_out.get(name, [])
        idx = np.concatenate([w.index for w in ws]) if ws else np.zeros(0, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= size):
            bad = next(w for w in ws if w.index.size and (w.index.min() < 0 or w.index.max() >= size))
            result.add("race-once", where, f"{name}: launch {bad.launch} block {bad.block} writes outside the "
                                           f"output's {size} elements")
            continue
        counts = np.bincount(idx, minlength=size)
        twice = np.flatnonzero(counts > 1)
        workspace = name in owners.workspaces
        if twice.size:
            e = int(twice[0])
            who = [(w.launch, w.block) for w in ws if (w.index == e).any()]
            result.add("race-workspace" if workspace else "race-once", where,
                       f"{name}[{e}] is written by {len(who)} blocks {who[:4]} ({twice.size} such elements): "
                       f"blocks run in no order, so the last writer wins")
        if not workspace and (counts == 0).any():
            e = int(np.flatnonzero(counts == 0)[0])
            result.add("race-once", where, f"{name}[{e}] is written by no block "
                                           f"({int((counts == 0).sum())} such elements)")


# -- the split walk of B1, B4, B7, B10 and B12 (csrc/mega_slim.cu) ------------------


def _slim_piece(plan: _mp.SlimPlan, blk: int):
    """Pass 1's piece of ``blk``: (k, lines, elements, workspace slots)."""
    b, r, c, nseg = plan.batch, plan.rows, plan.cols, plan.nseg
    k = blk % nseg
    if plan.form == _mp.FORM_SPLIT:
        line = blk // nseg
        el = line * c + _arange(k * plan.seg, min(c, (k + 1) * plan.seg))
        return k, np.array([line]), el, np.array([line * nseg + k])
    width = _ss.TILE_VEC if plan.vec else _ss.TILE_SCALAR
    bi, t = divmod(blk // nseg, _cdiv(c, width))
    cols = _arange(t * width, min(c, (t + 1) * width))
    rows = _arange(k * plan.seg, min(r, (k + 1) * plan.seg))
    lines = bi * c + cols
    return k, lines, (bi * r * c + rows[:, None] * c + cols[None, :]).ravel(), k * plan.lines + lines


def slim_owners(plan: _mp.SlimPlan, *, partial: bool, snr: bool, health: bool, reduce: bool) -> Owners:
    """The writes of one B1/B4/B7 (``partial=False``: u or p', m', v' and
    the flags' lines) or B10/B12 (``partial=True``: m' in pass 1, the line
    sum and the flags' lines in the combine) call on ``plan``; ``reduce``:
    B4's and B10's (2,) health, from the health lines by one more block."""
    b, r, c = plan.batch, plan.rows, plan.cols
    lines, n = plan.lines, b * r * c
    full = ("m_out",) if partial else ("u", "m_out")
    line_outs = (("part",) if partial else ("v_out",)) + (("s1c", "s2c") if snr else ()) \
        + (("first",) if partial and snr else ()) + (("nf", "ss") if health else ())
    sizes = {**{o: n for o in full}, **{o: lines for o in line_outs}}
    writes: List[Write] = []

    def put(launch, blk, outs, idx):
        writes.extend(Write(launch, blk, o, idx) for o in outs)

    if plan.form == _mp.FORM_ROWS and plan.axis == 1:
        for blk in range(plan.blocks):
            put("rows", blk, full, blk * c + _arange(0, c))
            put("rows", blk, line_outs, np.array([blk]))
    elif plan.form == _mp.FORM_ROWS:
        strips = _cdiv(c, _mp.STRIP)
        for blk in range(plan.blocks):
            bi, s = divmod(blk, strips)
            cols = _arange(s * _mp.STRIP, min(c, (s + 1) * _mp.STRIP))
            put("rows", blk, full, (bi * r * c + _arange(0, r)[:, None] * c + cols[None, :]).ravel())
            put("rows", blk, line_outs, bi * c + cols)
    else:
        planes = 1 + 2 * snr + 2 * health
        sizes["work"] = planes * lines * plan.nseg
        pieces = [_slim_piece(plan, blk) for blk in range(plan.blocks)]
        for blk, (k, ls, el, slots) in enumerate(pieces):
            writes.append(Write("sum", blk, "work",
                                np.concatenate([p * lines * plan.nseg + slots for p in range(planes)])))
            if partial:
                put("sum", blk, full, el)
        if partial:   # the combine: a thread a MAJOR column, a warp a SPLIT line
            span = _mp.SLIM_THREADS if plan.form == _mp.FORM_MAJOR else _ss.WARPS
            for blk in range(plan.combine_blocks):
                put("combine", blk, line_outs, _arange(blk * span, min(lines, (blk + 1) * span)))
        else:
            for i in range(plan.blocks):          # pass 2 walks the pieces in reverse
                k, ls, el, _ = pieces[plan.blocks - 1 - i]
                put("apply", i, full, el)
                if k == 0:
                    put("apply", i, line_outs, ls)
    if reduce:
        sizes["health"] = 2
        writes.append(Write(_REDUCE, 0, "health", _arange(0, 2)))
    return Owners(writes, sizes, ("work",))


# -- the split walk of B5, B8 and B9 (csrc/snr_stats.cu) ------------------------------


def split_owners(plan: _ss.SplitPlan, outs: Sequence[str], first: bool) -> Owners:
    """The writes of one B5/B8/B9 call on ``plan``: its line sums ``outs``
    by the walk (one piece a line) or by the combine, and B9's shift
    (``first``) by each line's first piece."""
    b, r, c = plan.batch, plan.rows, plan.cols
    lines, nseg = plan.lines, plan.nseg
    sizes = {o: lines for o in outs}
    if first:
        sizes["first"] = lines
    writes: List[Write] = []
    for blk in range(plan.blocks):
        k = blk % nseg
        if plan.form == _ss.FORM_WARP:
            per = _ss.WARPS * 32 // plan.group
            ls = _arange(blk * per, min(lines, (blk + 1) * per))
        elif plan.form == _ss.FORM_SPLIT:
            ls = np.array([blk // nseg])
        else:
            width = _ss.TILE_VEC if plan.vec else _ss.TILE_SCALAR
            bi, t = divmod(blk // nseg, _cdiv(c, width))
            ls = bi * c + _arange(t * width, min(c, (t + 1) * width))
        if nseg == 1:
            writes.extend(Write("walk", blk, o, ls) for o in outs)
        else:
            writes.append(Write("walk", blk, "work",
                                np.concatenate([j * lines * nseg + ls * nseg + k for j in range(len(outs))])))
        if first and k == 0:
            writes.append(Write("walk", blk, "first", ls))
    if nseg > 1:
        sizes["work"] = len(outs) * lines * nseg
        for blk in range(plan.combine_blocks):
            ls = _arange(blk * _ss.WARPS, min(lines, (blk + 1) * _ss.WARPS))
            writes.extend(Write("combine", blk, o, ls) for o in outs)
    return Owners(writes, sizes, ("work",))


# -- B11 and B13's flat walk (csrc/slim_finalize.cu) ----------------------------------


def finalize_owners(plan: _su.FinalizePlan, ek: bool) -> Owners:
    """The writes of one B11/B13 call on ``plan``: u, vector by vector (block
    i takes tiles i, i + blocks, ...), and with ``ek`` v' by the thread
    whose vector opens the line (axis 1) or lies in the batch slice's first
    row (axis 0)."""
    b, r, c, vec = plan.batch, plan.rows, plan.cols, plan.vec
    nv, tile = plan.vectors, plan.tile
    j = _arange(0, nv)
    owner = (j // tile) % plan.blocks
    lines = b * r if plan.axis == 1 else b * c
    sizes = {"u": b * r * c}
    writes: List[Write] = []
    row_v = c // vec
    q, cv = j // row_v, j % row_v
    if ek:
        sizes["v_out"] = lines
        if plan.axis == 1:
            first, line, lv = cv == 0, q, 1
        else:
            first, line, lv = q % r == 0, (q // r) * c + cv * vec, vec
    for blk in range(plan.blocks):
        mine = j[owner == blk]
        writes.append(Write("walk", blk, "u", (mine[:, None] * vec + _arange(0, vec)[None, :]).ravel()))
        if ek:
            sel = mine[first[mine]]
            writes.append(Write("walk", blk, "v_out", (line[sel][:, None] + _arange(0, lv)[None, :]).ravel()))
    return Owners(writes, sizes)


# -- the elementwise kernels: B2, B3, B6 ----------------------------------------------


def _grid_stride(items: int, blocks: int, threads: int) -> np.ndarray:
    """The block of each item of a grid-stride loop."""
    return (_arange(0, items) % (blocks * threads)) // threads


def elementwise_owners(n: int, vec: bool, blocks: int, threads: int, outs: Sequence[str]) -> Owners:
    """The writes of a grid-stride pass over ``n`` elements, four a thread
    per turn where ``vec`` (B3, B6, B2's base form)."""
    per = 4 if vec else 1
    items = n // per
    owner = _grid_stride(items, blocks, threads)
    by_block = np.split(np.argsort(owner, kind="stable"), np.cumsum(np.bincount(owner, minlength=blocks))[:-1])
    writes = []
    for blk, mine in enumerate(by_block):
        el = (mine[:, None] * per + _arange(0, per)[None, :]).ravel()
        writes.extend(Write("walk", blk, o, el) for o in outs)
    return Owners(writes, {o: n for o in outs})


def adam_health_owners(rows: int, cols: int) -> Owners:
    """B2 with health: block i takes rows i, i + blocks, ..., each whole,
    and writes their health lines."""
    blocks, _ = _mp.adam_grid(rows, cols, True)
    writes = []
    for blk in range(blocks):
        rs = _arange(blk, rows)[::blocks]
        el = (rs[:, None] * cols + _arange(0, cols)[None, :]).ravel()
        writes.extend(Write("walk", blk, o, el) for o in ("u", "m_out", "v_out"))
        writes.extend(Write("walk", blk, o, rs) for o in ("nf", "ss"))
    return Owners(writes, {"u": rows * cols, "m_out": rows * cols, "v_out": rows * cols, "nf": rows, "ss": rows})


def with_block_partials(owners: Owners, blocks: int) -> Owners:
    """B3's health form: each walk block writes its two f64 partials, and
    one reduce block the (2,) health."""
    writes = list(owners.writes)
    writes += [Write("walk", blk, "partial", np.array([blk, blocks + blk])) for blk in range(blocks)]
    writes.append(Write(_REDUCE, 0, "health", _arange(0, 2)))
    return Owners(writes, {**owners.sizes, "partial": 2 * blocks, "health": 2}, owners.workspaces + ("partial",))


# -- B14 (csrc/paged_attention.cu) ----------------------------------------------------


def paged_owners(plan: _pa.PagedPlan, b: int, c: int, h: int, kv: int, hd: int) -> Owners:
    """The writes of one B14 call: block ``((b * qtiles + t) * kv + g) *
    pieces + k`` takes query tokens [t * tokens, ...) of row b and the
    heads of group g; unsplit, it writes their output rows; split, their
    partials of piece k (which it may leave unwritten where the piece holds
    no live key: the combine reads only live pieces), and the combine, a
    thread per 4 columns of a query row, writes the output."""
    rep = h // kv
    rows_total = b * c * h
    sizes = {"out": rows_total * hd}
    writes: List[Write] = []
    for blk in range(plan.blocks):
        k = blk % plan.pieces
        g = blk // plan.pieces % kv
        t = blk // (plan.pieces * kv) % plan.qtiles
        bi = blk // (plan.pieces * kv * plan.qtiles)
        toks = _arange(t * plan.tokens, min(c, (t + 1) * plan.tokens))
        heads = _arange(g * rep, (g + 1) * rep)
        orow = ((bi * c + toks)[:, None] * h + heads[None, :]).ravel()
        if plan.pieces == 1:
            writes.append(Write("walk", blk, "out", (orow[:, None] * hd + _arange(0, hd)[None, :]).ravel()))
        else:
            prow = k * rows_total + orow
            writes.append(Write("walk", blk, "part_acc", (prow[:, None] * hd + _arange(0, hd)[None, :]).ravel()))
            writes.append(Write("walk", blk, "part_ml", (prow[:, None] * 2 + _arange(0, 2)[None, :]).ravel()))
    if plan.pieces > 1:
        sizes.update(part_acc=plan.pieces * rows_total * hd, part_ml=plan.pieces * rows_total * 2)
        per_row = hd // 4
        for blk in range(plan.combine_blocks):
            idx = _arange(blk * _pa.THREADS, (blk + 1) * _pa.THREADS)
            idx = idx[idx // per_row < rows_total]
            writes.append(Write("combine", blk, "out",
                                ((idx // per_row * hd + idx % per_row * 4)[:, None] + _arange(0, 4)[None, :]).ravel()))
    return Owners(writes, sizes, ("part_acc", "part_ml"))


# -- the registry's calls --------------------------------------------------------------

_SLIM_FLAVOURS = {   # entry -> (partial, reduce)
    "mega_slim_update_batched": (False, False), "slim_precond_batched": (False, True),
    "slim_update_batched": (False, False), "slim_partial_stats_batched": (True, True),
    "mega_slim_partial_stats_batched": (True, False),
}
_STATS_OUTS = {"snr_stats_batched": (("s1", "s2"), False), "snr_stats_centered_batched": (("s1", "s1c", "s2c"), False),
               "snr_stats_centered_partial_batched": (("s1", "s1c", "s2c"), True)}

# Views where the planners split further than at the registry's shapes:
# a 1024-key B14 table row, B11's flat walk over phase 6a's shapes.
EXTRA_PAGED = ((2, 1, 8, 2, 64, 16, 64), (1, 40, 8, 2, 64, 16, 8))     # (b, c, h, kv, hd, page, max_pages)
EXTRA_FINALIZE = ((1, 4608, 384, 1), (12, 48, 40, 0), (2, 5, 33, 1))


def call_owners(entry: registry.KernelEntry, case: registry.Case, variant: registry.Variant, sms: int) -> Owners:
    """The writes of one call of ``entry`` at ``case`` on a card of ``sms``
    SMs, with every operand 16-byte aligned (as fresh allocations are)."""
    kw = variant.kwargs
    snr, health = bool(kw.get("with_snr")), bool(kw.get("with_health"))
    name = entry.name.split("[")[0]
    if name in _SLIM_FLAVOURS:
        partial, reduce = _SLIM_FLAVOURS[name]
        b, r, c = case.shape
        plan = _mp.plan_slim(b, r, c, case.axis, sms=sms, aligned=True)
        return slim_owners(plan, partial=partial, snr=snr, health=health, reduce=reduce and health)
    if name in _STATS_OUTS:
        outs, first = _STATS_OUTS[name]
        b, r, c = case.shape
        return split_owners(_ss.plan_split(b, r, c, case.axis, sms=sms, aligned=True), outs, first)
    if name in ("slim_finalize_batched", "mega_slim_finalize_batched"):
        b, r, c = case.shape
        return finalize_owners(_su.plan_finalize(b, r, c, case.axis, sms), ek="[ek]" in entry.name)
    if name == "mega_adam_update":
        rows, cols = case.shape
        if health:
            return adam_health_owners(rows, cols)
        blocks, threads = _mp.adam_grid(rows, cols, False)
        return elementwise_owners(rows * cols, True, blocks, threads, ("u", "m_out", "v_out"))
    if name in ("fused_adam", "adam_precond"):
        n = case.shape[0] * case.shape[1]
        blocks = _fa.elementwise_blocks(n)
        vec = n % 4 == 0 and all(dt == registry.f32 for dt in case.dtypes[:2])
        outs = ("p_out", "m_out", "v_out") if name == "fused_adam" else ("u", "m_out", "v_out")
        own = elementwise_owners(n, vec, blocks, _fa._THREADS, outs)
        return with_block_partials(own, blocks) if health else own
    if name == "paged_attention":
        b, c, h, hd = case.shape
        g = case.kwargs
        plan = _pa.plan_paged(b, c, g["kv"], h // g["kv"], hd, g["page"], g["max_pages"], case.dtypes[0],
                              case.dtypes[1], sms=sms)
        return paged_owners(plan, b, c, h, g["kv"], hd)
    raise KeyError(f"races: no owner model for {entry.name}")


# -- megaplan segment tables ------------------------------------------------------------

# Synthetic mixed tree: every regime (minor/major/batched/dense), ragged,
# size-1 and full-reduce leaves, a bf16 leaf sharing a group with an f32 one.
_SYNTH_TREE = (
    ((128, 256), "float32", (1,)),
    ((64, 256), "bfloat16", (1,)),
    ((256, 96), "float32", (0,)),
    ((4, 32, 64, 16), "float32", (1,)),
    ((7,), "float32", ()),
    ((33, 5), "float32", ()),
    ((3, 3), "float32", (0, 1)),
    ((1, 2), "float32", (1,)),
)
# The launch bound of gpt_small's grouped step (JAX's CI gate).
_GPT_SMALL_GROUPS_BOUND = 8


def _gpt_small_leaf_geometry():
    """(shapes, dtypes, Table-3 dims) of full gpt_small's parameters, from
    the config's specs (nothing allocated)."""
    import torch

    from ..configs import get_config
    from ..core import rules_to_dims, table3_rules
    from ..core.labels import flatten_with_names

    specs = dict(flatten_with_names(get_config("gpt_small").specs()))
    meta = {k: s.meta() for k, s in specs.items()}
    dims = rules_to_dims(table3_rules(meta), meta)
    return (tuple(tuple(s.shape) for s in specs.values()), (torch.float32,) * len(specs),
            tuple(tuple(dims[k]) for k in specs))


def check_segment_tables(result: PassResult) -> None:
    """The megaplan's segment tables tile each super-tensor exactly once
    (offsets contiguous, every leaf in one slot, one line geometry a group),
    groups and plain leaves partition the tree, and gpt_small stays within
    its launch bound."""
    import torch

    shapes_g, dts_g, dims_g = _gpt_small_leaf_geometry()
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    suites = [
        ("gpt_small[slim]", shapes_g, dts_g, dims_g),
        ("gpt_small[adam]", shapes_g, dts_g, tuple(() for _ in shapes_g)),
        ("synthetic", tuple(s for s, _, _ in _SYNTH_TREE), tuple(dt[d] for _, d, _ in _SYNTH_TREE),
         tuple(k for _, _, k in _SYNTH_TREE)),
    ]
    for name, shapes, dts, dims_leaves in suites:
        plan = _mp.plan_megagroups(shapes, dts, dims_leaves)
        covered = list(plan.jnp_idx)
        for gi, group in enumerate(plan.groups):
            where = f"megaplan::{name}::group{gi}[{group.kind}]"
            result.checks += 1
            bad = [] if group.segments else ["group holds no segments"]
            off = 0
            for seg in group.segments:
                if seg.length <= 0:
                    bad.append(f"leaf {seg.index} has non-positive kept extent {seg.length}")
                if seg.offset != off:
                    bad.append(f"leaf {seg.index} offset {seg.offset} != running offset {off}: segments overlap "
                               f"or leave a gap")
                off += seg.length
                if group.kind != "dense" and _mp._slim_key(seg.cn) != (group.kind, group.batch, group.red):
                    bad.append(f"leaf {seg.index} line geometry {_mp._slim_key(seg.cn)} differs from the group's "
                               f"{(group.kind, group.batch, group.red)}")
            extent = group.rows if group.kind in ("dense", "minor") else group.cols
            if off != extent:
                bad.append(f"segment lengths sum to {off} != group extent {extent}")
            tbl = _mp.segment_table(group)
            if tuple(tbl.shape) != (extent, 4):
                bad.append(f"segment table shape {tuple(tbl.shape)} != ({extent}, 4)")
            elif group.segments:
                exp = np.repeat([s.index for s in group.segments], [s.length for s in group.segments])
                if not np.array_equal(tbl[:, 0].numpy(), exp):
                    bad.append("table leaf-index column does not tile the segments in offset order")
                if (tbl[:, 2] <= 0).any():
                    bad.append("table holds a non-positive line extent")
            covered.extend(seg.index for seg in group.segments)
            for msg in bad:
                result.add("segment-table", where, msg)
        result.checks += 1
        if sorted(covered) != list(range(len(shapes))):
            result.add("segment-table", f"megaplan::{name}", f"groups + plain leaves do not partition the "
                                                             f"{len(shapes)} leaves once (covered {sorted(covered)})")
        result.checks += 1
        if name.startswith("gpt_small") and len(plan.groups) > _GPT_SMALL_GROUPS_BOUND:
            result.add("segment-table", f"megaplan::{name}",
                       f"{len(plan.groups)} groups > gpt_small's launch bound {_GPT_SMALL_GROUPS_BOUND}")


def run() -> PassResult:
    """race-once over every registered (entry, case, variant) on both
    cards and the extra views, then the megaplan segment tables."""
    t0 = time.monotonic()
    result = PassResult("races")
    for entry in registry.ENTRIES:
        for case in entry.cases:
            for variant in entry.variants:
                for sms in SMS:
                    where = f"{registry.signature_key(entry, case, variant)}@{sms}sm"
                    check_owners(call_owners(entry, case, variant, sms), result, where)
    for b, c, h, kv, hd, page, max_pages in EXTRA_PAGED:
        for sms in SMS:
            plan = _pa.plan_paged(b, c, kv, h // kv, hd, page, max_pages, registry.f32, registry.f32, sms=sms)
            check_owners(paged_owners(plan, b, c, h, kv, hd), result,
                         f"paged_attention::{(b, c, h, kv, hd, page, max_pages)}@{sms}sm")
    for b, r, c, axis in EXTRA_FINALIZE:
        for sms in SMS:
            for ek in (False, True):
                check_owners(finalize_owners(_su.plan_finalize(b, r, c, axis, sms), ek), result,
                             f"slim_finalize_batched::{(b, r, c, axis)}{'[ek]' if ek else ''}@{sms}sm")
    check_segment_tables(result)
    result.seconds = time.monotonic() - t0
    return result
