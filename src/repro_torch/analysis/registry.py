"""Registry of the port's kernel entry points for the static checks (the
counterpart of ``repro/analysis/registry.py``).

One table of every kernel wrapper the JAX package's registry names, with
JAX's output-signature variants (``with_snr`` / ``with_health``) and its
shape x dtype x orientation case matrix, so that the signatures of both
packages are keyed alike (``golden_signatures.json`` holds the same 119
keys). Each entry also names the CUDA kernels its wrapper launches and the
planner that sizes their grid. The passes iterate this table
(:mod:`.kernelcheck`, :mod:`.races`); what a kernel outputs is read from
here by whoever needs it (:func:`snr_stat_lines`, :func:`health_stat_outputs`).

Arguments are ``meta`` tensors: building them and reading a signature
allocates nothing and runs no kernel.

Where JAX's buffer constants (``*_BUFS``) sized its VMEM gate, the port has
none (``repro_torch.kernels.tiling``): a variant is a name and its flags.
The JAX matrix's ``block`` keyword (a Pallas strip height) has no port
counterpart, since the port's planners size their own grids. JAX's
``fit-edge`` case keeps its shape, the reduction extent at the edge of JAX's
VMEM gate for a 5-buffer kernel; the port serves it like any line.

The selective scan's kernels (B15 and its backward) have no JAX registry
entry: they enter kernelcheck's resource checks (:data:`SCAN_SYMBOLS`), not
the signature matrix.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..kernels import fused_adam as _fa
from ..kernels import megaplan as _mp
from ..kernels import paged_attention as _pa
from ..kernels import slim_update as _su
from ..kernels import snr_stats as _ss
from .call_tools import entry_signature

f32 = torch.float32
bf16 = torch.bfloat16
i32 = torch.int32

# The reduction extent on the edge of the JAX package's VMEM gate for a
# 5-buffer strip kernel: VMEM_BUDGET // (4 * PRECOND_BUFS)
# (repro/kernels/tiling.py:33, repro/kernels/slim_update.py:48).
JAX_FIT_EDGE_RED = (8 << 20) // (4 * 5)


class Case(NamedTuple):
    """One abstract invocation shape for an entry."""

    label: str
    shape: Tuple[int, ...]          # (B, R, C) for strip entries, (R, C) for 2-D
    axis: Optional[int]             # strip reduction axis (None for 2-D tiles)
    dtypes: Tuple                   # dtype per positional arg
    kwargs: dict                    # geometry of paged cases (see _PAGED_GEOM)
    kept: int                       # kept extent (for O(kept) classification)
    red: int                        # reduction extent


class Variant(NamedTuple):
    """One output-signature variant of an entry (appends extra outputs)."""

    name: str                       # "base" | "snr" | "health" | "snr+health"
    kwargs: dict


class KernelEntry(NamedTuple):
    name: str
    fn: Callable
    kind: str                       # "strip" | "tile2d" | "paged"
    arg_roles: Tuple[str, ...]      # "full" | "line" (strip), "full2d" | "line2d" (tile),
                                    # "q" | "pool" | "table" | "lengths" (paged)
    variants: Tuple[Variant, ...]   # variants[0] is the base signature
    cases: Tuple[Case, ...]
    symbols: Tuple[str, ...]        # the CUDA kernels the wrapper launches
    plan: str                       # the planner that sizes their grid
    # Argument slots the port's wrapper takes in f32 only where JAX's also
    # takes bf16 (the SNR statistics: the port's callers hold the moments in
    # f32); their bf16 cases run with f32 there, and the outputs are the same.
    f32_slots: Tuple[int, ...] = ()


def _dts(n: int, **over):
    """n float32 dtypes with per-slot overrides: _dts(3, s0=bf16)."""
    out = [f32] * n
    for key, dt in over.items():
        out[int(key[1:])] = dt
    return tuple(out)


def _strip_cases(n_args: int, *, bf16_slots: Tuple[int, ...], fit_edge: bool = False) -> Tuple[Case, ...]:
    """JAX's strip case matrix: minor/major orientation, a bf16 storage
    case, a ragged kept extent, and optionally JAX's VMEM fit edge."""
    over = {f"s{i}": bf16 for i in bf16_slots}
    cases = [
        Case("minor", (2, 8, 128), 1, _dts(n_args), {}, kept=8, red=128),
        Case("major", (2, 128, 8), 0, _dts(n_args), {}, kept=8, red=128),
        Case("minor-bf16", (2, 8, 128), 1, _dts(n_args, **over), {}, kept=8, red=128),
        Case("ragged", (1, 13, 128), 1, _dts(n_args), {}, kept=13, red=128),
    ]
    if fit_edge:
        cases.append(Case("fit-edge", (1, 2, JAX_FIT_EDGE_RED), 1, _dts(n_args), {}, kept=2, red=JAX_FIT_EDGE_RED))
    return tuple(cases)


def _finalize_with_ek(m_new, v_line, ek, **kw):
    return _su.slim_finalize_batched(m_new, v_line, ek=ek, **kw)


def _mega_finalize_with_ek(m_new, v_line, bc1, bc2, ek, **kw):
    return _mp.mega_slim_finalize_batched(m_new, v_line, bc1, bc2, ek=ek, **kw)


_TILE2D_CASES = (
    Case("aligned", (256, 512), None, _dts(4), {}, kept=256, red=512),
    Case("ragged-bf16", (300, 700), None, _dts(4, s0=bf16, s1=bf16), {}, kept=300, red=700),
)

# Paged-attention case geometry rides in Case.kwargs (pool pages, page size,
# kv heads, table width): shapes, not keywords of the entry.
_PAGED_GEOM = ("pages", "page", "kv", "max_pages")


def _paged_case(label: str, b: int, c: int, h: int, kv: int, hd: int, page: int, max_pages: int, *,
                qdt=f32, pooldt=f32) -> Case:
    pages = b * max_pages + 1
    return Case(label, (b, c, h, hd), None, (qdt, pooldt, i32, i32),
                {"pages": pages, "page": page, "kv": kv, "max_pages": max_pages},
                kept=c * h, red=page * 2 * kv * hd)


_PAGED_CASES = (
    _paged_case("decode", 3, 1, 4, 2, 8, 4, 4),
    _paged_case("decode-ragged", 2, 1, 4, 2, 8, 4, 5),
    _paged_case("decode-bf16", 3, 1, 4, 2, 8, 4, 4, qdt=bf16, pooldt=bf16),
    _paged_case("chunk", 1, 4, 4, 2, 8, 8, 4),
    _paged_case("chunk-bf16", 1, 4, 4, 2, 8, 8, 4, qdt=bf16, pooldt=bf16),
)

_FLAGS = (Variant("base", {}), Variant("snr", {"with_snr": True}), Variant("health", {"with_health": True}),
          Variant("snr+health", {"with_snr": True, "with_health": True}))
_SLIM_WALK = ("slim_minor_kernel", "slim_major_kernel", "slim_split_sum", "slim_split_apply", "slim_major_sum",
              "slim_major_apply")
_PARTIAL_WALK = ("slim_minor_kernel", "slim_major_kernel", "slim_split_sum", "slim_major_sum",
                 "slim_partial_combine")
_SPLIT_STATS = ("snr_warp_lines", "snr_split_lines", "snr_major_columns", "snr_combine")
_REDUCE = "health_reduce_kernel"

ENTRIES: Tuple[KernelEntry, ...] = (
    KernelEntry("fused_adam", _fa.fused_adam, "tile2d", ("full2d",) * 4, (Variant("base", {"lr": 1e-3}),),
                _TILE2D_CASES, ("fused_adam_kernel",), "fused_adam.elementwise_blocks"),
    KernelEntry("adam_precond", _fa.adam_precond, "tile2d", ("full2d",) * 3,
                (Variant("base", {}), Variant("health", {"with_health": True})),
                (Case("aligned", (256, 512), None, _dts(3), {}, kept=256, red=512),
                 Case("ragged-bf16", (300, 700), None, _dts(3, s0=bf16), {}, kept=300, red=700)),
                ("adam_precond_kernel", _REDUCE), "fused_adam.elementwise_blocks"),
    KernelEntry("slim_update_batched", _su.slim_update_batched, "strip", ("full", "full", "full", "line"),
                (Variant("base", {"lr": 1e-3}),), _strip_cases(4, bf16_slots=(0, 1)), _SLIM_WALK,
                "megaplan.plan_slim"),
    KernelEntry("slim_precond_batched", _su.slim_precond_batched, "strip", ("full", "full", "line"), _FLAGS,
                _strip_cases(3, bf16_slots=(0,), fit_edge=True), _SLIM_WALK + (_REDUCE,), "megaplan.plan_slim"),
    KernelEntry("slim_partial_stats_batched", _su.slim_partial_stats_batched, "strip", ("full", "full"), _FLAGS,
                _strip_cases(2, bf16_slots=(0,)), _PARTIAL_WALK + (_REDUCE,), "megaplan.plan_slim"),
    KernelEntry("slim_finalize_batched[ek]", _finalize_with_ek, "strip", ("full", "line", "line"),
                (Variant("base", {}),), _strip_cases(3, bf16_slots=()), ("finalize_flat_kernel",),
                "slim_update.plan_finalize"),
    KernelEntry("slim_finalize_batched[owner]", _su.slim_finalize_batched, "strip", ("full", "line"),
                (Variant("base", {"ek": None}),), _strip_cases(2, bf16_slots=()), ("finalize_flat_kernel",),
                "slim_update.plan_finalize"),
    # Megaplan entries: the group super-tensors are f32 (gather_group casts
    # every segment), so there are no bf16 cases.
    KernelEntry("mega_adam_update", _mp.mega_adam_update, "tile2d", ("full2d", "full2d", "full2d", "line2d", "line2d"),
                (Variant("base", {}), Variant("health", {"with_health": True})),
                (Case("aligned", (256, 512), None, _dts(5), {}, kept=256, red=512),
                 Case("ragged", (300, 512), None, _dts(5), {}, kept=300, red=512)),
                ("mega_adam_kernel", "mega_adam_health_kernel"), "megaplan.adam_grid"),
    KernelEntry("mega_slim_update_batched", _mp.mega_slim_update_batched, "strip",
                ("full", "full", "line", "line", "line"), _FLAGS, _strip_cases(5, bf16_slots=(), fit_edge=True),
                _SLIM_WALK, "megaplan.plan_slim"),
    KernelEntry("mega_slim_partial_stats_batched", _mp.mega_slim_partial_stats_batched, "strip", ("full", "full"),
                _FLAGS, _strip_cases(2, bf16_slots=()), _PARTIAL_WALK, "megaplan.plan_slim"),
    KernelEntry("mega_slim_finalize_batched[ek]", _mega_finalize_with_ek, "strip",
                ("full", "line", "line", "line", "line"), (Variant("base", {}),), _strip_cases(5, bf16_slots=()),
                ("finalize_flat_kernel",), "slim_update.plan_finalize"),
    KernelEntry("mega_slim_finalize_batched[owner]", _mp.mega_slim_finalize_batched, "strip",
                ("full", "line", "line", "line"), (Variant("base", {"ek": None}),), _strip_cases(4, bf16_slots=()),
                ("finalize_flat_kernel",), "slim_update.plan_finalize"),
    KernelEntry("snr_stats_batched", _ss.snr_stats_batched, "strip", ("full",), (Variant("base", {}),),
                _strip_cases(1, bf16_slots=(0,)), _SPLIT_STATS, "snr_stats.plan_split", f32_slots=(0,)),
    KernelEntry("snr_stats_centered_batched", _ss.snr_stats_centered_batched, "strip", ("full",),
                (Variant("base", {}),), _strip_cases(1, bf16_slots=(0,)), _SPLIT_STATS, "snr_stats.plan_split",
                f32_slots=(0,)),
    KernelEntry("snr_stats_centered_partial_batched", _ss.snr_stats_centered_partial_batched, "strip", ("full",),
                (Variant("base", {}),), _strip_cases(1, bf16_slots=(0,)), _SPLIT_STATS, "snr_stats.plan_split",
                f32_slots=(0,)),
    KernelEntry("paged_attention", _pa.paged_attention, "paged", ("q", "pool", "table", "lengths"),
                (Variant("base", {}),), _PAGED_CASES,
                ("paged_cores_kernel", "paged_mma_kernel", "paged_combine_kernel"), "paged_attention.plan_paged"),
)

ENTRY_MAP: Dict[str, KernelEntry] = {e.name: e for e in ENTRIES}

# The selective scan's kernels, outside the signature matrix: B15
# (ssm_scan.plan_scan) and its backward (ssm_scan.plan_scan_bwd).
SCAN_SYMBOLS: Dict[str, Tuple[str, ...]] = {
    "ssm_scan": ("ssm_token", "ssm_chunk_walk", "ssm_carry"),
    "ssm_scan_bwd": ("ssm_bwd_walk", "ssm_bwd_combine"),
}


def arg_shapes(entry: KernelEntry, case: Case) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]:
    """(shape, dtype) of every positional argument of (entry, case)."""
    out = []
    for slot, (role, dt) in enumerate(zip(entry.arg_roles, case.dtypes)):
        if slot in entry.f32_slots:
            dt = f32
        if role == "line":
            b, r, c = case.shape
            shape = (b, r, 1) if case.axis == 1 else (b, 1, c)
        elif role == "line2d":
            shape = (case.shape[0], 1)
        elif role == "pool":
            kw = case.kwargs
            shape = (kw["pages"], kw["page"], 2 * kw["kv"], case.shape[3])
        elif role == "table":
            shape = (case.shape[0], case.kwargs["max_pages"])
        elif role == "lengths":
            shape = (case.shape[0],)
        else:  # "full" (B, R, C), "full2d" (R, C), "q" (B, C, H, hd)
            shape = case.shape
        out.append((tuple(shape), dt))
    return tuple(out)


def case_args(entry: KernelEntry, case: Case) -> Tuple[torch.Tensor, ...]:
    """The positional arguments of (entry, case) as ``meta`` tensors."""
    return tuple(torch.empty(shape, dtype=dt, device="meta") for shape, dt in arg_shapes(entry, case))


def case_kwargs(entry: KernelEntry, case: Case, variant: Variant) -> dict:
    kw = {k: v for k, v in case.kwargs.items() if k not in _PAGED_GEOM}
    kw.update(variant.kwargs)
    if entry.kind == "strip":
        kw["axis"] = case.axis
    return kw


def signature(entry: KernelEntry, case: Case, variant: Variant):
    """Flat output (shape, dtype) list of (entry, case, variant), on ``meta``."""
    return entry_signature(entry.fn, *case_args(entry, case), **case_kwargs(entry, case, variant))


def signature_key(entry: KernelEntry, case: Case, variant: Variant) -> str:
    return f"{entry.name}::{case.label}::{variant.name}"


def encode_signature(sig) -> List[List[str]]:
    return [["x".join(str(d) for d in shape), str(dtype).replace("torch.", "")] for shape, dtype in sig]


def all_signatures() -> Dict[str, List[List[str]]]:
    """Every registered (entry, case, variant) signature, golden-file form."""
    return {signature_key(e, c, v): encode_signature(signature(e, c, v))
            for e in ENTRIES for c in e.cases for v in e.variants}


def variant_extra_outputs(entry_name: str, case_label: str, variant_name: str):
    """The outputs (shape, dtype) a variant appends beyond the entry's base
    signature."""
    entry = ENTRY_MAP[entry_name]
    case = next(c for c in entry.cases if c.label == case_label)
    variant = next(v for v in entry.variants if v.name == variant_name)
    base = signature(entry, case, entry.variants[0])
    return signature(entry, case, variant)[len(base):]


# ---------------------------------------------------------------------------
# Signature consumers (the benchmarks' roofline gates read these)
# ---------------------------------------------------------------------------


def snr_stat_lines():
    """Per-regime extra-output counts of the ``with_snr`` variants, read from
    the signatures, plus the shapes of any extra output that is not
    line-shaped: a measure step adds O(kept) stat lines and no full-size
    pass. Returns ``({'psum': n, 'local': n, 'jnp': n}, full_size_outputs)``
    (JAX's ``snr_stat_lines``)."""
    case = "minor"
    full = math.prod(ENTRY_MAP["slim_partial_stats_batched"].cases[0].shape)
    partial = variant_extra_outputs("slim_partial_stats_batched", case, "snr")
    precond = variant_extra_outputs("slim_precond_batched", case, "snr")
    oversize = [shape for shape, _ in list(partial) + list(precond) if math.prod(shape) >= full]
    return {"psum": len(partial), "local": len(precond), "jnp": len(precond)}, oversize


def health_stat_outputs():
    """Extra-output shapes of every ``with_health`` variant JAX's gate reads:
    one (2,) accumulator a leaf. Returns ``[(kernel_name, shapes)]``."""
    out = []
    for name in ("adam_precond", "slim_precond_batched", "slim_partial_stats_batched"):
        entry = ENTRY_MAP[name]
        extras = variant_extra_outputs(name, entry.cases[0].label, "health")
        out.append((name, [shape for shape, _ in extras]))
    return out
