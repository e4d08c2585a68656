"""kernelcheck — the port's kernel contracts (the counterpart of
``repro/analysis/kernelcheck.py``, re-derived for CUDA on an H100).

Device-free (:func:`run`), over every (entry, case, variant) of
:mod:`.registry` and the CUDA sources:

  * **golden** — the output signatures, read on ``meta``, match
    ``golden_signatures.json`` (the port's own copy of the JAX package's
    119 keys; regenerate with ``python -m repro_torch.analysis
    --update-golden``).
  * **okept** — a variant's extra outputs (SNR stat lines, health
    accumulators) stay O(kept) or O(1); a variant growing a full-size
    output fails.
  * **dtype** — every read of a ``__nv_bfloat16`` buffer in ``csrc/`` goes
    into float through a declared converter (``__bfloat162float``,
    ``__bfloat1622float2``, or the bits placed in an f32), every bf16 store
    comes from a float through ``__float2bfloat16(_rn)``, and no bf16
    arithmetic intrinsic appears: the f32-compute contract, checked on the
    sources as JAX checks it on the jaxpr. Where a design computes on bf16
    operands with f32 accumulators, it is a declared exception
    (:data:`BF16_EXCEPTIONS`) with its reason and the bar it is held to.

On the card (:func:`run_resources`), from the ptxas report the build keeps
(``kernels.build.resource_report``), against :data:`RESOURCES`, the table
each kernel is held to. JAX's ``bufs`` and ``vmem`` become:

  * **smem** — static shared memory plus the plan's dynamic bytes within
    ``tiling.SMEM_BUDGET`` (static within 48 KiB), and where the port counts
    a static layout (B15's), the count equal to ptxas's;
  * **regs** — registers a thread times the block's threads within the
    register file, and at most 255 a thread;
  * **spill** — spill stores and loads within the symbol's declared row (0
    unless measured otherwise);
  * **blocks** — the blocks an SM holds at least what the planner counts on.

A kernel that gains a spill, or outgrows its declared shared memory or
register budget, fails; so does a ``__global__`` function the table does
not declare.
"""
from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..kernels import build, tiling
from . import registry
from .report import PassResult

GOLDEN_PATH = Path(__file__).parent / "golden_signatures.json"


# -- golden and okept ------------------------------------------------------------------


def check_extra_outputs(entry: registry.KernelEntry, case: registry.Case, variant: registry.Variant,
                        result: PassResult, where: str, extras=None) -> None:
    """Variant extras must be O(kept) lines or the O(1) accumulator
    (``extras``: the variant's extra (shape, dtype) outputs, read from the
    registry when not given)."""
    if variant is entry.variants[0]:
        return
    if extras is None:
        extras = registry.variant_extra_outputs(entry.name, case.label, variant.name)
    b = case.shape[0] if entry.kind == "strip" else 1
    bound = max(b * case.kept, 2)
    for shape, _ in extras:
        result.checks += 1
        elems = 1
        for d in shape:
            elems *= d
        if elems > bound:
            result.add("okept", where, f"variant '{variant.name}' extra output {tuple(shape)} has {elems} elements "
                                       f"> O(kept) bound {bound}: a signature grew a full-size output")


def load_golden(path: Path = GOLDEN_PATH) -> Optional[Dict[str, List[List[str]]]]:
    if not path.exists():
        return None
    return json.loads(path.read_text())


def check_golden(computed: Dict[str, List[List[str]]], golden: Dict[str, List[List[str]]],
                 result: PassResult) -> None:
    for key in sorted(set(computed) | set(golden)):
        result.checks += 1
        if key not in golden:
            result.add("golden", key, "signature missing from the golden file (regenerate with --update-golden)")
        elif key not in computed:
            result.add("golden", key, "stale golden entry: case no longer in the registry "
                                      "(regenerate with --update-golden)")
        elif computed[key] != golden[key]:
            result.add("golden", key, f"signature drifted: golden {golden[key]} != computed {computed[key]}")


# -- dtype: the f32-compute contract on the CUDA sources ---------------------------------

# Functions that take bf16 data into f32: the read converters.
BF16_READERS = {
    ("common.cuh", "load_g"), ("mega_slim.cu", "load_g4"), ("paged_attention.cu", "to_f32"),
    ("paged_attention.cu", "unpack"), ("paged_attention.cu", "load4"), ("ssm_scan.cu", "load_f"),
    ("ssm_scan_bwd.cu", "load_f"), ("ssm_scan_bwd.cu", "to_f"),
}
# Functions that store f32 values as bf16.
BF16_WRITERS = {
    ("adam_precond.cu", "store_param"), ("mega_slim.cu", "store_p"), ("mega_slim.cu", "stream_p4"),
    ("paged_attention.cu", "from_f32"), ("ssm_scan_bwd.cu", "put"),
}
# Designs that compute on bf16 operands, with their reason and bar.
BF16_EXCEPTIONS = {
    ("paged_attention.cu", "paged_mma_kernel"):
        "B14's tensor-core prefill: bf16 q, K and V (and P rounded to bf16) on mma.sync m16n8k16 with "
        "f32 accumulators and an f32 softmax; held to the plain twin (f32 softmax on the same bf16 inputs) at "
        "TOL_BF16_OUT = 2^-7 in chip_smoke.py's phase 4",
    ("paged_attention.cu", "mma_bf16"): "the mma.sync of paged_mma_kernel (see there)",
    ("paged_attention.cu", "pack_bf16"): "rounds paged_mma_kernel's f32 probabilities to its bf16 P operand",
}
_READ_OK = re.compile(r"__bfloat162float\s*\(|__bfloat1622float2\s*\(|__uint_as_float\s*\(")
_STORE_OK = re.compile(r"^\s*(?:__float2bfloat16(?:_rn)?|__floats2bfloat162_rn)\s*\(")
_ARITH = re.compile(r"\b(?:__h(?:add|sub|mul|div|fma|neg|max|min|abs)2?(?:_rn|_sat)?|"
                    r"h2?(?:exp|exp2|log|log2|sqrt|rsqrt|rcp|sin|cos))\s*\(")
_DATA = re.compile(r"__nv_bfloat162?\s*[*&]|__nv_bfloat162?\s+[A-Za-z_]\w*|=\s*__nv_bfloat162?\s*;")
_HEADER = re.compile(r"(?:__device__|__global__|__host__|template\s*<)[^;{}]*?\)\s*(?:const\s*)?\{")


def strip_comments(text: str) -> str:
    """The source without comments, lengths and line breaks kept."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group())
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


class Function(NamedTuple):
    name: str
    header: str
    body: str
    start: int     # offset of the header
    end: int       # offset past the closing brace


def _name_of(header: str) -> str:
    """The function's name: the identifier before the parameter list that
    ends the header (past any template arguments)."""
    close = header.rstrip()[:-1].rstrip()
    close = re.sub(r"\bconst\s*$", "", close).rstrip()
    depth, i = 0, len(close) - 1
    while i >= 0:
        depth += close[i] == ")"
        depth -= close[i] == "("
        if depth == 0:
            break
        i -= 1
    head = close[:i].rstrip()
    head = re.sub(r"<[^<>]*>\s*$", "", head).rstrip()
    m = re.search(r"(\w+)\s*$", head)
    return m.group(1) if m else "?"


def functions(text: str) -> List[Function]:
    """The function definitions of a comment-free CUDA source."""
    out = []
    for m in _HEADER.finditer(text):
        open_at = m.end() - 1
        depth, i = 0, open_at
        while i < len(text):
            depth += text[i] == "{"
            depth -= text[i] == "}"
            if depth == 0:
                break
            i += 1
        out.append(Function(_name_of(m.group()), m.group(), text[open_at:i + 1], m.start(), i + 1))
    return out


def _enclosing(funcs: Sequence[Function], at: int) -> Optional[Function]:
    inside = [f for f in funcs if f.start <= at < f.end]
    return min(inside, key=lambda f: f.end - f.start) if inside else None


def check_bf16_source(name: str, text: str, result: PassResult) -> None:
    """The dtype rules on one source file (``name``: its file name in
    ``csrc/``)."""
    code = strip_comments(text)
    funcs = functions(code)
    line_of = lambda at: code.count("\n", 0, at) + 1   # noqa: E731
    for m in _ARITH.finditer(code):
        f = _enclosing(funcs, m.start())
        if f is None or (name, f.name) not in BF16_EXCEPTIONS:
            result.checks += 1
            result.add("dtype", f"{name}:{line_of(m.start())}",
                       f"bf16 arithmetic ({m.group().rstrip('( ')}) in {f.name if f else 'file scope'}: the kernels "
                       f"compute in f32 and convert at the load and the store")
    seen = set()
    for m in _DATA.finditer(code):
        f = _enclosing(funcs, m.start())
        key = (name, f.name if f else None)
        if key in seen:
            continue
        seen.add(key)
        result.checks += 1
        if f is None or key not in BF16_READERS | BF16_WRITERS | set(BF16_EXCEPTIONS):
            result.add("dtype", f"{name}:{line_of(m.start())}",
                       f"bf16 data in {f.name if f else 'file scope'}, which is no declared converter "
                       f"(kernelcheck.BF16_READERS / BF16_WRITERS) or exception: bf16 values must reach "
                       f"arithmetic as f32")
            continue
        if key in BF16_READERS and not _READ_OK.search(f.body):
            result.add("dtype", f"{name}:{line_of(f.start)}", f"{f.name} reads bf16 but converts nothing to f32 "
                                                              f"(__bfloat162float, __bfloat1622float2 or the bits "
                                                              f"in an f32)")
        if key in BF16_READERS and re.match(r"[^()]*__nv_bfloat16\s+\w+\s*[(<]", f.header.replace("template", "")):
            result.add("dtype", f"{name}:{line_of(f.start)}", f"{f.name} is a read converter returning bf16")
        if key in BF16_WRITERS:
            check_bf16_stores(name, f, line_of(f.start), result)


def check_bf16_stores(name: str, f: Function, line: int, result: PassResult) -> None:
    """Every bf16 value a writer produces comes from an f32 converter: its
    assignments into bf16 places, its returned bf16 values and its
    streaming stores of bf16 bits (``bf16_bits``)."""
    refs = set(re.findall(r"__nv_bfloat16\s*&\s*(\w+)", f.header))
    body = f.body[1:-1]
    for stmt in body.split(";"):
        if "__stcs" in stmt and "__nv_bfloat16" in stmt:
            if "bf16_bits(" not in stmt:
                result.add("dtype", f"{name}:{line}", f"{f.name} streams bf16 bits not made by bf16_bits "
                                                      f"(__float2bfloat16_rn)")
            continue
        ret = re.match(r"\s*return\b(.*)", stmt, re.S)
        if ret and re.search(r"__nv_bfloat16\s+" + re.escape(f.name), f.header):
            if not _STORE_OK.match(ret.group(1)):
                result.add("dtype", f"{name}:{line}", f"{f.name} returns a bf16 value not converted from f32")
            continue
        parts = re.split(r"(?<![=!<>])=(?!=)", stmt, maxsplit=1)
        if len(parts) != 2:
            continue
        lhs, rhs = parts
        if "__nv_bfloat16" in lhs or any(re.search(rf"\b{r}\b", lhs) for r in refs):
            if not _STORE_OK.match(rhs):
                result.add("dtype", f"{name}:{line}", f"{f.name} stores a bf16 value not converted from f32: "
                                                      f"{' '.join((lhs + '=' + rhs).split())}")


def check_sources(result: PassResult) -> None:
    """The dtype rules over every source in ``csrc/``."""
    for p in sorted(build.CSRC.glob("*.cu*")):
        check_bf16_source(p.name, p.read_text(), result)


def run(update_golden: bool = False, golden_path: Path = GOLDEN_PATH
        ) -> Tuple[PassResult, Dict[str, List[List[str]]]]:
    """The device-free checks. Returns (result, computed signatures); the
    runner writes the computed dict out as the golden diff on mismatch."""
    t0 = time.monotonic()
    result = PassResult("kernelcheck")
    computed: Dict[str, List[List[str]]] = {}
    for entry in registry.ENTRIES:
        for case in entry.cases:
            base = None
            for variant in entry.variants:
                where = registry.signature_key(entry, case, variant)
                sig = registry.signature(entry, case, variant)
                base = sig if base is None else base
                computed[where] = registry.encode_signature(sig)
                check_extra_outputs(entry, case, variant, result, where, extras=sig[len(base):])
    golden = load_golden(golden_path)
    if update_golden or golden is None:
        golden_path.write_text(json.dumps(computed, indent=1, sort_keys=True) + "\n")
        result.detail = f"golden signatures written to {golden_path}"
    else:
        check_golden(computed, golden, result)
    check_sources(result)
    result.seconds = time.monotonic() - t0
    return result, computed


# -- the resource table (ptxas report) ------------------------------------------------


class Declared(NamedTuple):
    """What one ``__global__`` kernel is held to. ``threads`` and
    ``dynamic`` take the instantiation's template arguments; ``min_blocks``
    is the blocks an SM its planner counts on (1: none)."""

    source: str
    threads: Callable[[Tuple], int]
    dynamic: Callable[[Tuple], int] = lambda args: 0
    min_blocks: Callable[[Tuple], int] = lambda args: 1
    spill_stores: int = 0
    spill_loads: int = 0
    static_layout: Optional[Callable[[Tuple], int]] = None   # the port's count of its static shared memory


def _itemsize(type_name: str) -> int:
    return 2 if type_name == "__nv_bfloat16" else 4


def _fixed(n: int) -> Callable[[Tuple], int]:
    return lambda args: n


# Threads come from each launch in the sources (a planner's or a
# __launch_bounds__'s); spill rows other than 0 are what ptxas reported on
# the H100 build (PERF.md §6), as the designs accept them.
RESOURCES: Dict[str, Declared] = {
    "adam_precond_kernel": Declared("adam_precond.cu", _fixed(256)),
    "fused_adam_kernel": Declared("adam_precond.cu", _fixed(256)),
    "health_reduce_kernel": Declared("common.cuh", _fixed(1024)),
    "mega_adam_kernel": Declared("mega_adam.cu", _fixed(256)),
    "mega_adam_health_kernel": Declared("mega_adam.cu", _fixed(256)),
    "slim_minor_kernel": Declared("mega_slim.cu", _fixed(1024)),
    "slim_major_kernel": Declared("mega_slim.cu", _fixed(32 * 16)),
    "slim_split_sum": Declared("mega_slim.cu", _fixed(256)),
    "slim_split_apply": Declared("mega_slim.cu", _fixed(256)),
    "slim_major_sum": Declared("mega_slim.cu", _fixed(256)),
    "slim_major_apply": Declared("mega_slim.cu", _fixed(256)),
    "slim_partial_combine": Declared("mega_slim.cu", _fixed(256)),
    # <QT, PT, HD, ROWS>: 64 query rows take 256 threads and 3 blocks' worth
    # of registers (85 a thread), which spills 16-92 bytes, as the design chose.
    "paged_cores_kernel": Declared("paged_attention.cu", lambda a: tiling.paged_threads(0, a[3]),
                                   dynamic=lambda a: tiling.paged_smem_bytes(0, a[3], a[2], _itemsize(a[1])),
                                   spill_stores=64, spill_loads=92),
    "paged_mma_kernel": Declared("paged_attention.cu", _fixed(tiling.PAGED_THREADS),
                                 dynamic=lambda a: tiling.paged_smem_bytes(1, 64, a[0], 2)),
    "paged_combine_kernel": Declared("paged_attention.cu", _fixed(tiling.PAGED_THREADS)),
    # <VEC, EK, AXIS, index type, LINE_BC>: 4 blocks an SM (plan_finalize);
    # the float4 ek form with line bias corrections spills 24-52 bytes.
    "finalize_flat_kernel": Declared("slim_finalize.cu", _fixed(256), min_blocks=_fixed(4),
                                     spill_stores=40, spill_loads=52),
    "snr_warp_lines": Declared("snr_stats.cu", _fixed(256)),
    "snr_split_lines": Declared("snr_stats.cu", _fixed(256)),
    "snr_major_columns": Declared("snr_stats.cu", _fixed(256)),
    "snr_combine": Declared("snr_stats.cu", _fixed(256)),
    # <T, NP, OUT, KEEP>: 4 blocks an SM (plan_scan), <= 128 registers.
    "ssm_chunk_walk": Declared("ssm_scan.cu", _fixed(tiling.SCAN_THREADS), min_blocks=_fixed(4),
                               spill_stores=20, spill_loads=20,
                               static_layout=lambda a: tiling.scan_smem_bytes(_itemsize(a[0]), a[1], a[2])),
    "ssm_carry": Declared("ssm_scan.cu", _fixed(256)),
    "ssm_token": Declared("ssm_scan.cu", _fixed(256)),
    # <T, NP>: 8 * NP threads; 4 blocks an SM, 16 warps at N = 16, the
    # most the design's shared memory keeps (its launch bound allows 16
    # warps at every N, which shared memory does not hold where N <= 8);
    # the walks spill 4-164 bytes (PERF.md §7).
    "ssm_bwd_walk": Declared("ssm_scan_bwd.cu", lambda a: 8 * a[1],
                             dynamic=lambda a: tiling.scan_bwd_smem_bytes(_itemsize(a[0]), a[1]),
                             min_blocks=_fixed(4), spill_stores=164, spill_loads=268),
    "ssm_bwd_combine": Declared("ssm_scan_bwd.cu", _fixed(256)),
}


class Resource(NamedTuple):
    """One compiled kernel's row: ptxas's numbers, with the threads, dynamic
    shared memory and blocks an SM that follow from the table."""

    kernel: str
    args: Tuple
    registers: int
    spill_stores: int
    spill_loads: int
    static_smem: int
    dynamic_smem: int
    threads: int
    blocks_per_sm: int


def resources(rows: Sequence[build.ResourceRow]) -> List[Resource]:
    """The report's rows with what the table adds (undeclared kernels
    skipped: :func:`check_resources` reports them)."""
    out = []
    for r in rows:
        d = RESOURCES.get(r.kernel)
        if d is None:
            continue
        threads, dyn = d.threads(r.args), d.dynamic(r.args)
        out.append(Resource(r.kernel, r.args, r.registers, r.spill_stores, r.spill_loads, r.static_smem, dyn,
                            threads, tiling.blocks_per_sm(threads, r.registers, r.static_smem + dyn)))
    return out


def check_resources(rows: Sequence[build.ResourceRow], result: PassResult,
                    kernels: Optional[Dict[str, str]] = None) -> None:
    """Hold every row of the ptxas report to :data:`RESOURCES`; ``kernels``
    ({name: source}, by default the sources' ``__global__`` functions) must
    each be declared and compiled."""
    kernels = build.kernel_names() if kernels is None else kernels
    for name, source in sorted(kernels.items()):
        result.checks += 1
        if name not in RESOURCES:
            result.add("declared", name, f"__global__ {name} in {source} has no row in kernelcheck.RESOURCES")
        elif not any(r.kernel == name for r in rows):
            result.add("declared", name, f"{name} is not in the ptxas report: it was not compiled")
    for r in rows:
        where = f"{r.kernel}<{', '.join(map(str, r.args))}>"
        d = RESOURCES.get(r.kernel)
        result.checks += 1
        if d is None:
            result.add("declared", where, f"compiled kernel {r.symbol} has no row in kernelcheck.RESOURCES")
            continue
        threads, dyn = d.threads(r.args), d.dynamic(r.args)
        result.checks += 4
        total = r.static_smem + dyn
        if r.static_smem > tiling.SMEM_STATIC_MAX:
            result.add("smem", where, f"{r.static_smem} B of static shared memory > the static limit "
                                      f"{tiling.SMEM_STATIC_MAX} B")
        if not tiling.smem_fits(total):
            result.add("smem", where, f"{r.static_smem} B static + {dyn} B dynamic shared memory > the block's "
                                      f"{tiling.SMEM_BUDGET} B")
        if d.static_layout is not None and d.static_layout(r.args) != r.static_smem:
            result.add("smem", where, f"ptxas reports {r.static_smem} B of static shared memory, the port's count "
                                      f"of the layout {d.static_layout(r.args)} B")
        if r.registers > tiling.MAX_REGISTERS_PER_THREAD or r.registers * threads > tiling.REGISTERS_PER_SM:
            result.add("regs", where, f"{r.registers} registers x {threads} threads = {r.registers * threads} > "
                                      f"the register file's {tiling.REGISTERS_PER_SM}")
        if r.spill_stores > d.spill_stores or r.spill_loads > d.spill_loads:
            result.add("spill", where, f"{r.spill_stores} B spill stores / {r.spill_loads} B spill loads > the "
                                       f"declared {d.spill_stores} / {d.spill_loads} B")
        blocks = tiling.blocks_per_sm(threads, r.registers, total)
        if blocks < d.min_blocks(r.args):
            result.add("blocks", where, f"{blocks} blocks an SM < the {d.min_blocks(r.args)} its planner counts on")


def run_resources() -> PassResult:
    """The resource checks on the ptxas report of the library as built."""
    t0 = time.monotonic()
    result = PassResult("resources")
    rows = build.resource_report()
    check_resources(rows, result)
    result.detail = f"{len(rows)} compiled kernels of {len(build.kernel_names())} __global__ functions"
    result.seconds = time.monotonic() - t0
    return result
