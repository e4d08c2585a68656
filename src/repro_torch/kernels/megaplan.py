"""Whole-tree megaplan: O(groups) kernel launches per optimizer step (port of
``repro/kernels/megaplan.py``).

:func:`plan_megagroups` groups every kernel-eligible leaf by regime key —
``dense`` (K = (), lane-folded flat, one group for the tree), ``minor`` /
``major`` (2-D canonical plans keyed by the reduction extent) and
``batched`` (3-D scan-stacked plans keyed by (batch, extent)). Concatenation
always runs along the kept axis, so no reduction line crosses a segment
boundary and each group is one larger instance of the per-leaf problem.
:func:`gather_group` / :func:`scatter_group` move leaves into and out of a
group's f32 super-tensor by segment offset; per-leaf bias corrections enter
as O(kept) lines built by :func:`segment_lines`.

:func:`groups_from_plans` groups pre-planned leaves (the sharded psum
dispatcher's local plans) by the same keys.

The optimizer kernels live here beside their plain twins:

* :func:`mega_adam_update` — ``csrc/mega_adam.cu``, replacing
  ``repro/kernels/megaplan.py:351`` (body ``_mega_adam_kernel`` :337,
  ``pallas_call`` :375), ``with_health`` included. Bound by bytes: 24 B per
  element (plus 8 B per row for the health lines).
* :func:`mega_slim_update_batched` — ``csrc/mega_slim.cu``, replacing
  ``repro/kernels/megaplan.py:417`` (body ``_mega_slim_kernel`` :386,
  ``pallas_call`` :448), ``with_snr`` and ``with_health`` included. Bound by
  bytes: 16 B per element plus 16 B per line (8 B more per line per flag);
  20 B per element where g outgrows the L2 and pass 2 reads it again. Its
  grid (and B4's) comes from :func:`plan_slim`, which splits long lines and
  thin column strips across the SMs (pure integer arithmetic, tested on the
  CPU).
* :func:`mega_slim_partial_stats_batched` (B12) — the PARTIAL instantiation
  in ``csrc/mega_slim.cu``, replacing ``repro/kernels/megaplan.py:486``
  (body ``_mega_slim_partial_kernel`` :467, ``pallas_call`` :510): pass 1 of
  the grouped psum pair, on :func:`plan_slim`'s grid (a split view: one
  walk that writes m' and f64 shares, then a fixed-order combine). Bound
  by bytes: 12 B per element plus 4 B per line (12 B more with
  ``with_snr``, 8 B with ``with_health``).
* :func:`mega_slim_finalize_batched` (B13) — ``csrc/slim_finalize.cu``,
  B11's flat walk with bias corrections given a line, replacing
  ``repro/kernels/megaplan.py:536`` (``pallas_call`` :559 owner form, :568
  ek form), on ``slim_update.plan_finalize``'s grid. Bound by bytes: 8 B
  per element plus 16-20 B per line.

The ``.cu`` files' notes say how each design follows from its bound.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import build
from .ops import CanonND, canon_apply, canon_restore, leaf_plan
from .snr_stats import SEG_QUANTUM, TILE_SCALAR, TILE_VEC, WARPS, WAVES, _cdiv, _cut, centered_line_stats

# Lane width of the dense group's (rows, LANES) fold: the JAX kernels'
# tile width, kept so that group shapes match the reference plan.
LANES = 512

Dims = Tuple[int, ...]


class MegaSegment(NamedTuple):
    """One leaf's slot in a group's super-tensor."""

    index: int                  # leaf index in the caller's tree order
    shape: Tuple[int, ...]      # original leaf shape
    red_shape: Tuple[int, ...]  # reduced-moment shape (size-1 reduced dims)
    dims: Dims                  # reduction dims
    cn: Optional[CanonND]       # canonical plan (None for dense segments)
    offset: int                 # start along the group's concat axis
    length: int                 # extent along the concat axis


class MegaGroup(NamedTuple):
    """One concatenation-compatible leaf group = one kernel launch.
    ``(batch, rows, cols)`` is the canonical view; ``axis`` the per-batch
    reduction axis (1 minor / 0 major, -1 for the elementwise dense group)."""

    kind: str                   # 'dense' | 'minor' | 'major' | 'batched'
    batch: int
    rows: int
    cols: int
    axis: int
    segments: Tuple[MegaSegment, ...]

    @property
    def concat_axis(self) -> int:
        return {"dense": 0, "minor": 0, "major": 1, "batched": 2}[self.kind]

    @property
    def red(self) -> int:
        """Reduction extent of every line (the lane width for dense)."""
        return self.cols if self.axis in (1, -1) else self.rows


class MegaPlan(NamedTuple):
    groups: Tuple[MegaGroup, ...]
    jnp_idx: Tuple[int, ...]    # leaves left to the plain per-leaf path


def _slim_key(cn: CanonND) -> Tuple[str, int, int]:
    if cn.batch > 1:
        return ("batched", cn.batch, cn.rows)
    if cn.axis == 1:
        return ("minor", 1, cn.cols)
    return ("major", 1, cn.rows)


def _dense_group(items) -> MegaGroup:
    segs, off = [], 0
    for i, shape, red_shape, dims, cn in items:
        length = -(-math.prod(shape) // LANES)   # lane-folded row count
        segs.append(MegaSegment(i, shape, red_shape, dims, cn, off, length))
        off += length
    return MegaGroup("dense", 1, off, LANES, -1, tuple(segs))


def _slim_group(key, items) -> MegaGroup:
    kind, batch, red = key
    segs, off = [], 0
    for i, shape, red_shape, dims, cn in items:
        length = cn.rows if kind == "minor" else cn.cols
        segs.append(MegaSegment(i, shape, red_shape, dims, cn, off, length))
        off += length
    if kind == "minor":
        return MegaGroup("minor", 1, off, red, 1, tuple(segs))
    if kind == "major":
        return MegaGroup("major", 1, red, off, 0, tuple(segs))
    return MegaGroup("batched", batch, red, off, 0, tuple(segs))


def groups_from_plans(items: Sequence[tuple]) -> Tuple[MegaGroup, ...]:
    """Group pre-planned canonical leaves ``(index, shape, red_shape, dims,
    cn)`` by regime key — the sharded psum dispatcher's entry point, whose
    local plans come from ``ShardLeafPlan.cn`` rather than :func:`leaf_plan`."""
    by_key: Dict[Tuple[str, int, int], list] = {}
    for it in items:
        by_key.setdefault(_slim_key(it[4]), []).append(it)
    return tuple(_slim_group(k, by_key[k]) for k in sorted(by_key))


@functools.lru_cache(maxsize=64)
def _plan_cached(shapes: Tuple[Tuple[int, ...], ...], dtypes: Tuple[torch.dtype, ...],
                 dims_leaves: Tuple[Dims, ...]) -> MegaPlan:
    dense_items: List[tuple] = []
    slim_items: Dict[Tuple[str, int, int], list] = {}
    jnp_idx: List[int] = []
    for i, (shape, dtype, dims) in enumerate(zip(shapes, dtypes, dims_leaves)):
        plan = leaf_plan(shape, dtype, dims)
        if plan.route == "jnp":
            jnp_idx.append(i)
        elif plan.route == "dense":
            dense_items.append((i, shape, shape, (), None))
        else:
            dset = {d % len(shape) for d in dims}
            red_shape = tuple(1 if j in dset else s for j, s in enumerate(shape))
            slim_items.setdefault(_slim_key(plan.cn), []).append((i, shape, red_shape, dims, plan.cn))
    groups: List[MegaGroup] = [_dense_group(dense_items)] if dense_items else []
    groups += [_slim_group(key, slim_items[key]) for key in sorted(slim_items)]
    return MegaPlan(tuple(groups), tuple(jnp_idx))


def plan_megagroups(shapes: Sequence[Tuple[int, ...]], dtypes: Sequence[torch.dtype],
                    dims_leaves: Sequence[Dims]) -> MegaPlan:
    """Plan the whole-tree grouping (cached: a pure function of the leaf
    geometry, which is fixed for a run). Leaf order is the caller's tree
    order, so segment offsets follow it."""
    return _plan_cached(tuple(tuple(int(d) for d in s) for s in shapes), tuple(dtypes),
                        tuple(tuple(int(d) for d in ds) for ds in dims_leaves))


def segment_table(group: MegaGroup) -> torch.Tensor:
    """The per-row segment table of one group (``repro/kernels/megaplan.py
    :243``): ``(extent, 4)`` int64 rows ``[leaf_index, position_within_leaf,
    line_extent, bc_slot]``, one a kept line of the super-tensor (a
    lane-folded row of the dense group), in the order the segments tile
    the concat axis. Metadata: the kernels consume only its reductions
    (the offsets of ``scatter_group``, the bias corrections a line of
    :func:`segment_lines`)."""
    line = group.cols if group.kind == "dense" else group.red
    rows = [(seg.index, p, line, slot) for slot, seg in enumerate(group.segments) for p in range(seg.length)]
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 4)


# ---------------------------------------------------------------------------
# Gather / scatter
# ---------------------------------------------------------------------------


def gather_group(group: MegaGroup, xs: Sequence[torch.Tensor], *, reduced: bool = False) -> torch.Tensor:
    """Concatenate the group's leaves into its f32 super-tensor (lane-folded
    flat for dense, canonical views along the kept axis otherwise;
    ``reduced=True`` gathers the size-1-reduced moment lines). This copies
    every operand once per step."""
    if group.kind == "dense":
        parts = []
        for seg in group.segments:
            flat = xs[seg.index].float().reshape(-1)
            parts.append(torch.nn.functional.pad(flat, (0, seg.length * LANES - flat.numel())))
        return torch.cat(parts).reshape(group.rows, LANES)
    return torch.cat([canon_apply(xs[seg.index].float(), seg.cn, reduced_cols=reduced)
                      for seg in group.segments], dim=group.concat_axis)


def scatter_group(group: MegaGroup, y: torch.Tensor, *, reduced: bool = False) -> List[torch.Tensor]:
    """Slice a super-tensor output back into per-leaf tensors in their
    original layouts, aligned with ``group.segments``. Dense and minor
    segments are views; major and batched ones are copies (their slices
    along a non-leading axis are not contiguous)."""
    out: List[torch.Tensor] = []
    for seg in group.segments:
        sl = y.narrow(group.concat_axis, seg.offset, seg.length)
        if group.kind == "dense":
            out.append(sl.reshape(-1)[:math.prod(seg.shape)].reshape(seg.shape))
        else:
            out.append(canon_restore(sl, seg.cn, seg.red_shape if reduced else seg.shape))
    return out


def scatter_lines(group: MegaGroup, y: torch.Tensor) -> List[torch.Tensor]:
    """Slice an O(kept) line output into raw per-segment line views (no
    layout restore) — for per-segment stat sums (health) and per-leaf SNR
    finalisation, which do not depend on the layout."""
    return [y.narrow(group.concat_axis, seg.offset, seg.length) for seg in group.segments]


def segment_lines(group: MegaGroup, values: Sequence[torch.Tensor]) -> torch.Tensor:
    """Expand one per-leaf scalar (e.g. a bias correction, a 0-d device
    tensor) into the group's contiguous line operand, shaped like the
    reduced-moment line: (N, 1) dense/minor, (1, N) major, (B, 1, N) batched."""
    flat = torch.cat([v.float().reshape(1).expand(seg.length)
                      for v, seg in zip(values, group.segments)])
    if group.kind in ("dense", "minor"):
        return flat[:, None]
    if group.kind == "major":
        return flat[None, :]
    return flat[None, None, :].expand(group.batch, 1, flat.numel()).contiguous()


# ---------------------------------------------------------------------------
# Kernels and their plain twins
# ---------------------------------------------------------------------------

_ADAM_ARGTYPES = [build.PTR] * 10 + [build.SIZE] * 3 + [build.INT] + [build.F32] * 5 + [build.PTR]
# The plan's arguments (form, vec, seg, nseg, blocks, the workspace) follow
# the view's (batch, rows, cols, axis).
PLAN_ARGTYPES = [build.INT] * 2 + [build.SIZE] * 3 + [build.PTR]
_SLIM_ARGTYPES = [build.PTR] * 12 + [build.SIZE] * 3 + [build.INT] + PLAN_ARGTYPES + [build.F32] * 6 + [build.PTR]
_MAX_GRID_Y = 65535
_MAX_GRID_X = 2**31 - 1

# The split walk of B1, B4, B7, B10 and B12 (csrc/mega_slim.cu, which matches):
# 256-thread blocks; pieces of 4096 to 16384 elements (64 KB to 256 KB of
# B1's 16 B an element; B7 moves 20 B, B12 12 B); the axis-0 ROWS form's
# 32-column strips (kStrip).
SLIM_SEG_MIN = 4096
SLIM_SEG_MAX = 16384
STRIP = 32
SLIM_THREADS = 256   # a block of the SPLIT and MAJOR walks (kThreads in csrc/mega_slim.cu)
FORM_ROWS, FORM_SPLIT, FORM_MAJOR = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class SlimPlan:
    """The grid of one B1, B4, B7, B10 or B12 call on a (B, R, C) view
    (``SplitPlan``'s shape, with the axis, since the ROWS form serves both).
    FORM_ROWS: one block per axis-1 line, or per STRIP columns of an axis-0
    batch slice (``nseg == 1``, one launch). FORM_SPLIT: block b takes segment b % nseg
    (``seg`` elements, the last one shorter) of axis-1 line b // nseg.
    FORM_MAJOR: block b takes row chunk b % nseg (``seg`` rows) of column
    tile b // nseg (TILE_VEC or TILE_SCALAR columns). SPLIT and MAJOR run
    two launches over the same ``blocks`` pieces (pass 2 in reverse block
    order; B10's and B12's second launch combines the shares instead) and need a
    (planes, lines * nseg) f64 workspace."""
    form: int
    vec: bool        # four elements a load (aligned view, inner size a multiple of 4)
    axis: int
    batch: int
    rows: int
    cols: int
    seg: int
    nseg: int
    blocks: int

    @property
    def lines(self) -> int:
        return self.batch * (self.rows if self.axis == 1 else self.cols)

    @property
    def combine_blocks(self) -> int:
        """The grid of B10's and B12's combine: a warp a SPLIT line, a
        thread a MAJOR column, SLIM_THREADS threads a block (none for ROWS)."""
        if self.form == FORM_ROWS:
            return 0
        return _cdiv(self.lines, WARPS if self.form == FORM_SPLIT else SLIM_THREADS)

    def describe(self) -> str:
        """The form, its pieces a line and its blocks, as the logs print them."""
        return f"{('ROWS', 'SPLIT', 'MAJOR')[self.form]}, nseg {self.nseg}, {self.blocks} blocks"


@functools.lru_cache(maxsize=None)
def plan_slim(batch: int, rows: int, cols: int, axis: int, *, sms: int, aligned: bool) -> SlimPlan:
    """The grid of B1, B4, B7, B10 and B12 on a (batch, rows, cols) view reduced
    along ``axis`` on a card with ``sms`` SMs; ``aligned``: g, m (and B7's
    p) and the outputs start where four-element loads may. Pieces are
    SLIM_SEG_MIN to SLIM_SEG_MAX elements, sized for about WAVES blocks per
    SM. An axis-1
    line that fits in one piece keeps the ROWS form; a longer one is cut
    into 1024-aligned segments (SPLIT). On axis 0 the ROWS form's strips
    stay where they number WAVES a SM or where cutting the rows into chunks
    of a piece's bytes would give no more blocks; otherwise 128-column
    (32 without four-element loads) tiles take row chunks (MAJOR). Pure
    integer arithmetic: no CUDA call (and cached, as the wrappers ask for
    every launch)."""
    if min(batch, rows, cols) < 1 or axis not in (0, 1) or sms < 1:
        raise ValueError(f"plan_slim: want a non-empty (B, R, C), axis 0|1 and sms >= 1, got "
                         f"{(batch, rows, cols)}, axis {axis}, sms {sms}")
    vec = aligned and cols % 4 == 0
    piece = min(max(_cdiv(batch * rows * cols, WAVES * sms), SLIM_SEG_MIN), SLIM_SEG_MAX)
    if axis == 1:
        seg, nseg = _cut(cols, piece, SEG_QUANTUM)
        if nseg == 1:
            return SlimPlan(FORM_ROWS, vec, 1, batch, rows, cols, cols, 1, batch * rows)
        return SlimPlan(FORM_SPLIT, vec, 1, batch, rows, cols, seg, nseg, batch * rows * nseg)
    strips = batch * _cdiv(cols, STRIP)
    tile = TILE_VEC if vec else TILE_SCALAR
    seg, nseg = _cut(rows, max(piece // tile, 1), WARPS)
    blocks = batch * _cdiv(cols, tile) * nseg
    if strips >= WAVES * sms or blocks <= strips:
        return SlimPlan(FORM_ROWS, vec, 0, batch, rows, cols, rows, 1, strips)
    return SlimPlan(FORM_MAJOR, vec, 0, batch, rows, cols, seg, nseg, blocks)


# The plan of each wrapper's latest launch on the card, by the name it
# passes to slim_walk: what a log or a check reads to see the form it took.
last_plans: Dict[str, SlimPlan] = {}


def slim_walk(kernel: str, g: torch.Tensor, m: torch.Tensor, axis: int, *, with_snr: bool, with_health: bool,
              p: Optional[torch.Tensor] = None):
    """The plan's arguments for a B1/B4/B7/B10/B12 launch on the card, after
    the view's: (form, vec, seg, nseg, blocks, workspace pointer), and the
    f64 workspace of split views' shares (g^2, then s1c and s2c, then nf
    and ss a piece; None for ROWS), which the caller holds until it has
    launched. The outputs are fresh, so only g, m and B7's p decide the
    alignment (four elements: 16 B, 8 B for bf16). The plan is kept in
    ``last_plans[kernel]``."""
    check_slim_grid(kernel, g, axis)
    b, r, c = g.shape
    aligned = all(t.data_ptr() % (4 * t.element_size()) == 0 for t in (g, m, p) if t is not None)
    plan = plan_slim(b, r, c, axis, sms=build.sm_count(g.device), aligned=aligned)
    if plan.blocks > _MAX_GRID_X:
        raise ValueError(f"{kernel}: shape {tuple(g.shape)} exceeds the launch grid")
    last_plans[kernel] = plan
    planes = 1 + 2 * with_snr + 2 * with_health
    work = (torch.empty((planes, plan.lines * plan.nseg), dtype=torch.float64, device=g.device)
            if plan.nseg > 1 else None)
    return (plan.form, int(plan.vec), plan.seg, plan.nseg, plan.blocks, build.ptr(work)), work


def line_health(g: torch.Tensor, red: int):
    """Per-line (nf, ss), keepdims along ``red``: the count of non-finite g
    and the sum of g*g (rounded in f32) over the finite entries, summed in
    f64 as the kernels sum them. Plain version of the ``with_health`` line
    outputs (``repro/kernels/megaplan.py:327`` ``_line_health``)."""
    fin = torch.isfinite(g)
    nf = (~fin).sum(dim=red, keepdim=True).float()
    ss = torch.where(fin, g * g, 0.0).double().sum(dim=red, keepdim=True).float()
    return nf, ss


ADAM_MAX_BLOCKS = 132 * 16


def adam_grid(rows: int, cols: int, with_health: bool) -> Tuple[int, int]:
    """(blocks, threads) of B2 on a (rows, cols) super-tensor, which
    :func:`mega_adam_update` launches (``csrc/mega_adam.cu``) and the race
    pass walks: the base form strides 256-thread blocks over its float4
    vectors; the health form gives each block whole rows (a thread a float4
    of the row, 32 to 256 threads), striding over the rows."""
    if with_health:
        threads = min(max(-(-(cols // 4) // 32) * 32, 32), 256)
        return max(1, min(rows, ADAM_MAX_BLOCKS)), threads
    return max(1, min(-(-(rows * cols // 4) // 256), ADAM_MAX_BLOCKS)), 256


def mega_adam_update_plain(g, m, v, bc1, bc2, *, b1, b2, eps, with_health: bool = False):
    """Plain PyTorch version of :func:`mega_adam_update`, in the kernel's
    operation order."""
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    out = ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps), m_new, v_new)
    return out + line_health(g, 1) if with_health else out


def mega_adam_update(g, m, v, bc1, bc2, *, b1=0.9, b2=0.999, eps=1e-8, with_health: bool = False):
    """Dense Adam over a (rows, cols) super-tensor with per-row bias lines
    ``bc1``/``bc2`` (rows, 1); ``cols`` a multiple of 4 (the kernel loads
    float4s; the dense group has ``LANES`` columns). Returns (u, m', v'),
    f32, and with ``with_health`` the per-row lines (nf, ss), (rows, 1):
    non-finite count and finite sum of squares of g. CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    if g.ndim != 2 or g.shape[1] % 4 or m.shape != g.shape or v.shape != g.shape \
            or bc1.shape != (g.shape[0], 1) or bc2.shape != bc1.shape:
        raise ValueError(f"mega_adam_update: want g, m, v (rows, cols), cols % 4 == 0, and bc lines "
                         f"(rows, 1); got {[tuple(t.shape) for t in (g, m, v, bc1, bc2)]}")
    device = build.check_operands("mega_adam_update", g=g, m=m, v=v, bc1=bc1, bc2=bc2)
    if device.type == "cpu":
        return mega_adam_update_plain(g, m, v, bc1, bc2, b1=b1, b2=b2, eps=eps, with_health=with_health)
    if device.type == "meta":
        outs = tuple(build.meta_empty(g.shape) for _ in range(3)) + \
            (tuple(build.meta_empty(bc1.shape) for _ in range(2)) if with_health else ())
        return build.on_meta(mega_adam_update, outs) if g.numel() else outs
    outs = tuple(torch.empty_like(g) for _ in range(3))
    health = tuple(torch.empty_like(bc1) for _ in range(2)) if with_health else (None, None)
    if g.numel() == 0:
        return outs + (tuple(h.zero_() for h in health) if with_health else ())
    if any(t.data_ptr() % 16 for t in (g, m, v, *outs)):
        raise ValueError("mega_adam_update: g, m and v must start on a 16-byte boundary (float4 loads)")
    fn = build.entry("repro_mega_adam_update", _ADAM_ARGTYPES)
    build.launch("mega_adam_update", fn, device, *(t.data_ptr() for t in (g, m, v, bc1, bc2, *outs)),
                 *map(build.ptr, health), g.shape[0], g.shape[1], *adam_grid(g.shape[0], g.shape[1], with_health),
                 b1, 1.0 - b1, b2, 1.0 - b2, eps)
    mega_adam_update.launches += 1
    return outs + (health if with_health else ())


mega_adam_update.launches = 0


def mega_slim_update_batched_plain(g, m, v_line, bc1, bc2, *, axis, b1, b2, eps, with_snr: bool = False,
                                   with_health: bool = False):
    """Plain PyTorch version of :func:`mega_slim_update_batched`, in the
    kernel's operation order (ek = line sum times 1/n, as the TPU kernel)."""
    red = 2 if axis == 1 else 1
    ek = torch.sum(g * g, dim=red, keepdim=True) * (1.0 / g.shape[red])
    v_new = b2 * v_line + (1 - b2) * ek
    m_new = b1 * m + (1 - b1) * g
    out = ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps), m_new, v_new)
    if with_snr:
        out = out + centered_line_stats(g * g, red)[:2]
    return out + line_health(g, red) if with_health else out


def slim_line_shape(g: torch.Tensor, axis: int) -> Tuple[int, int, int]:
    b, r, c = g.shape
    return (b, r, 1) if axis == 1 else (b, 1, c)


def check_slim_grid(kernel: str, g: torch.Tensor, axis: int) -> None:
    """The launch limits of the slim kernels' grids (``csrc/mega_slim.cu``)."""
    b, r, _ = g.shape
    if g.numel() == 0:
        raise ValueError(f"{kernel}: empty lines have no mean")
    if (axis == 1 and b * r > _MAX_GRID_X) or (axis == 0 and b > _MAX_GRID_Y):
        raise ValueError(f"{kernel}: shape {tuple(g.shape)} exceeds the launch grid")


def mega_slim_update_batched(g, m, v_line, bc1, bc2, *, axis: int, b1=0.9, b2=0.95, eps=1e-8,
                             with_snr: bool = False, with_health: bool = False):
    """Fused SlimAdam precondition over a (B, R, C) super-tensor whose kept
    axis concatenates same-geometry leaves. ``v_line``, ``bc1``, ``bc2`` are
    (B, R, 1) for ``axis=1`` and (B, 1, C) for ``axis=0``. Returns
    (u, m', v_line'), f32, then with ``with_snr`` the line sums (s1c, s2c)
    of g^2 shifted by each line's first entry, then with ``with_health`` the
    lines (nf, ss), all shaped like ``v_line`` (the output order of
    ``repro/kernels/megaplan.py:386-410``). CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    if g.ndim != 3 or axis not in (0, 1):
        raise ValueError(f"mega_slim_update_batched: want (B, R, C) and axis 0|1, got "
                         f"{tuple(g.shape)}, axis {axis}")
    line = slim_line_shape(g, axis)
    if m.shape != g.shape or any(t.shape != line for t in (v_line, bc1, bc2)):
        raise ValueError(f"mega_slim_update_batched: want m {tuple(g.shape)} and lines {line}; got "
                         f"{[tuple(t.shape) for t in (m, v_line, bc1, bc2)]}")
    device = build.check_operands("mega_slim_update_batched", g=g, m=m, v_line=v_line, bc1=bc1, bc2=bc2)
    if device.type == "cpu":
        return mega_slim_update_batched_plain(g, m, v_line, bc1, bc2, axis=axis, b1=b1, b2=b2, eps=eps,
                                              with_snr=with_snr, with_health=with_health)
    if device.type == "meta":
        n_lines = 3 + 2 * with_snr + 2 * with_health
        return build.on_meta(mega_slim_update_batched, (build.meta_empty(g.shape), build.meta_empty(g.shape))
                             + tuple(build.meta_empty(line) for _ in range(n_lines - 2)))
    walk, work = slim_walk("mega_slim_update_batched", g, m, axis, with_snr=with_snr, with_health=with_health)
    b, r, c = g.shape
    u, m_out = torch.empty_like(g), torch.empty_like(g)
    v_out = torch.empty_like(v_line)
    snr = tuple(torch.empty_like(v_line) for _ in range(2)) if with_snr else (None, None)
    health = tuple(torch.empty_like(v_line) for _ in range(2)) if with_health else (None, None)
    n_red = c if axis == 1 else r
    fn = build.entry("repro_mega_slim_update", _SLIM_ARGTYPES)
    build.launch("mega_slim_update_batched", fn, device,
                 *(t.data_ptr() for t in (g, m, v_line, bc1, bc2, u, m_out, v_out)),
                 *map(build.ptr, snr + health), b, r, c, axis, *walk, 1.0 / n_red, b1, 1.0 - b1, b2, 1.0 - b2, eps)
    mega_slim_update_batched.launches += 1
    return (u, m_out, v_out) + (snr if with_snr else ()) + (health if with_health else ())


mega_slim_update_batched.launches = 0


def mega_slim_update(g, m, v_line, bc1, bc2, *, axis: int, **kw):
    """2-D (batch-free) form of :func:`mega_slim_update_batched`: g, m (R,
    C), the lines (R, 1) for ``axis=1`` or (1, C) for ``axis=0``; one call
    of the batched kernel (``repro/kernels/megaplan.py:460``)."""
    outs = mega_slim_update_batched(g[None], m[None], v_line[None], bc1[None], bc2[None], axis=axis, **kw)
    return tuple(o[0] for o in outs)


# ---------------------------------------------------------------------------
# The grouped psum pair (B12, B13)
# ---------------------------------------------------------------------------

# B10 and B12 take their combine's grid after the plan's arguments.
_PARTIAL_ARGTYPES = ([build.PTR] * 9 + [build.SIZE] * 3 + [build.INT] + PLAN_ARGTYPES + [build.SIZE] + [build.F32] * 2
                     + [build.PTR])


def mega_slim_partial_stats_batched_plain(g, m, *, axis, b1, with_snr: bool = False, with_health: bool = False):
    """Plain PyTorch version of :func:`mega_slim_partial_stats_batched`, in
    the kernel's operation order."""
    red = 2 if axis == 1 else 1
    g2 = g * g
    out = (b1 * m + (1 - b1) * g, torch.sum(g2, dim=red, keepdim=True))
    if with_snr:
        out = out + centered_line_stats(g2, red)
    return out + line_health(g, red) if with_health else out


def mega_slim_partial_stats_batched(g, m, *, axis: int, b1=0.9, with_snr: bool = False,
                                    with_health: bool = False):
    """Pass 1 of the grouped psum pair over a (B, R, C) super-tensor of
    rank-local shards: (g, m) -> (m', part), then with ``with_snr`` the
    centered line sums and shift (s1c, s2c, first), then with
    ``with_health`` the lines (nf, ss); every line output shaped like the
    reduced moment, (B, R, 1) for ``axis=1`` and (B, 1, C) for ``axis=0``.
    ``part`` is the un-normalised line sum of g^2 the caller completes
    across ranks per leaf. CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if g.ndim != 3 or axis not in (0, 1) or m.shape != g.shape:
        raise ValueError(f"mega_slim_partial_stats_batched: want g, m (B, R, C) and axis 0|1, got "
                         f"{tuple(g.shape)}, {tuple(m.shape)}, axis {axis}")
    device = build.check_operands("mega_slim_partial_stats_batched", g=g, m=m)
    if device.type == "cpu":
        return mega_slim_partial_stats_batched_plain(g, m, axis=axis, b1=b1, with_snr=with_snr,
                                                     with_health=with_health)
    if device.type == "meta":
        line = slim_line_shape(g, axis)
        return build.on_meta(mega_slim_partial_stats_batched, (build.meta_empty(g.shape),) + tuple(
            build.meta_empty(line) for _ in range(1 + 3 * with_snr + 2 * with_health)))
    walk, work = slim_walk("mega_slim_partial_stats_batched", g, m, axis, with_snr=with_snr,
                           with_health=with_health)
    line = slim_line_shape(g, axis)
    m_out = torch.empty_like(g)
    part = torch.empty(line, dtype=torch.float32, device=device)
    snr = tuple(torch.empty_like(part) for _ in range(3)) if with_snr else (None,) * 3
    health = tuple(torch.empty_like(part) for _ in range(2)) if with_health else (None, None)
    b, r, c = g.shape
    fn = build.entry("repro_mega_slim_partial_stats", _PARTIAL_ARGTYPES)
    build.launch("mega_slim_partial_stats_batched", fn, device, g.data_ptr(), m.data_ptr(), m_out.data_ptr(),
                 part.data_ptr(), *map(build.ptr, snr + health), b, r, c, axis, *walk,
                 last_plans["mega_slim_partial_stats_batched"].combine_blocks, b1, 1.0 - b1)
    mega_slim_partial_stats_batched.launches += 1
    return (m_out, part) + (snr if with_snr else ()) + (health if with_health else ())


mega_slim_partial_stats_batched.launches = 0


def mega_slim_finalize_batched(m_new, v_line, bc1, bc2, *, axis: int, ek=None, b2=0.95, eps=1e-8):
    """Pass 2 of the grouped psum pair: m' (B, R, C) with per-line bias
    corrections ``bc1``/``bc2`` shaped like ``v_line``. With ``ek`` (the
    completed line means) returns ``(u, v')``; with ``ek=None`` (owner form,
    ``v_line`` already the completed moment) returns u. CUDA tensors launch
    the kernel (B11's flat walk on ``plan_finalize``'s grid, one launch);
    CPU tensors take the plain version."""
    from .slim_update import check_finalize, finalize_plan, launch_finalize_flat, slim_finalize_batched_plain

    device = check_finalize("mega_slim_finalize_batched", m_new, v_line, ek, axis)
    if bc1.shape != v_line.shape or bc2.shape != v_line.shape:
        raise ValueError(f"mega_slim_finalize_batched: want bias-correction lines {tuple(v_line.shape)}, got "
                         f"{tuple(bc1.shape)}, {tuple(bc2.shape)}")
    build.check_operands("mega_slim_finalize_batched", m_new=m_new, bc1=bc1, bc2=bc2)
    if device.type == "cpu":
        return slim_finalize_batched_plain(m_new, v_line, bc1, bc2, b2=b2, eps=eps, ek=ek)
    if device.type == "meta":
        u = build.meta_empty(m_new.shape)
        return build.on_meta(mega_slim_finalize_batched, u if ek is None else (u, build.meta_empty(v_line.shape)))
    plan = finalize_plan(m_new, axis, (v_line, ek, bc1, bc2))
    out = launch_finalize_flat(plan, m_new, v_line, ek, None, b1=0.0, b2=b2, eps=eps, bc_lines=(bc1, bc2),
                               kernel="mega_slim_finalize_batched")
    mega_slim_finalize_batched.launches += 1
    return out


mega_slim_finalize_batched.launches = 0
