"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` expose plain C entry points (device pointers, sizes,
scalars and a stream; the return value is the launch's ``cudaError_t``), so
they compile without PyTorch's headers: one ``nvcc -c`` per source, all
started together, then one link into a shared library that ``ctypes`` loads.
The library lands in ``build/repro_torch/<hash>/`` at the repository root
(git-ignored), keyed by a hash of the sources and flags, and is built at first
use — never at import, so machines without ``nvcc`` can import every module.
ptxas's report of each kernel's registers, spills and shared memory
(``-Xptxas=-v``) is kept beside it, and :func:`resource_report` reads it
into one row per compiled kernel, cached library or not.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
REPORT_NAME = "ptxas_report.txt"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math: the kernels keep IEEE division and square root.
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# What this process's build printed (nvcc/ptxas register and spill report)
# and how long it took; empty when the library came from the cache (the
# report is then read from the file beside it: :func:`ptxas_report`).
build_log: dict = {"seconds": 0.0, "output": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (nvcc on PATH or CUDA_HOME set)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _key(cu, cuh) -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, cu, nvcc: str) -> str:
    """Compile every source in parallel, link, and move the report and then
    the library into place atomically (a concurrent builder of the same key
    is harmless; a library in place always has its report beside it)."""
    tmp = out.parent / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / f"{src.stem}.o" for src in cu]
    procs = [subprocess.Popen([nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    logs, failed = [], []
    for src, proc in zip(cu, procs):
        text = proc.communicate()[0]
        logs.append(f"--- {src.name}\n{text}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(logs))
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    report = "\n".join(logs)
    (tmp / REPORT_NAME).write_text(report)
    os.replace(tmp / REPORT_NAME, out.parent / REPORT_NAME)
    os.replace(tmp / LIB_NAME, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return report


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    out = library_path()
    if not (out.exists() and (out.parent / REPORT_NAME).exists()):
        t0 = time.perf_counter()
        out.parent.mkdir(parents=True, exist_ok=True)
        build_log["output"] = _compile(out, _sources()[0], _nvcc())
        build_log["seconds"] = time.perf_counter() - t0
    return ctypes.CDLL(str(out))


def library_path() -> Path:
    """Where the library of the sources as they stand is (or will be) built."""
    return BUILD_ROOT / _key(*_sources()) / LIB_NAME


def ptxas_report() -> str:
    """ptxas's report of the library's build (built first if need be)."""
    library()
    return (library_path().parent / REPORT_NAME).read_text()


# -- the ptxas report, one row per compiled kernel ----------------------------------

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers[^\n]*")
_SMEM = re.compile(r"(\d+) bytes smem")
# Itanium codes of the template arguments the kernels take.
_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned", "x": "long long", "y": "unsigned long long",
            "b": "bool"}


class ResourceRow(NamedTuple):
    """What ptxas reports of one compiled kernel (one instantiation of a
    ``__global__`` template): its registers a thread, spill stores and
    loads and stack frame (bytes a thread), and static shared memory (bytes
    a block)."""
    kernel: str             # the __global__ function's name
    source: str             # its file in csrc/
    args: Tuple             # template arguments: type names, ints and bools
    symbol: str             # the mangled name
    registers: int
    spill_stores: int
    spill_loads: int
    stack: int
    static_smem: int


def kernel_names() -> Dict[str, str]:
    """{kernel name: source file} of every ``__global__`` function in
    ``csrc/``."""
    cu, cuh = _sources()
    return {m.group(1): p.name for p in sorted(cu + cuh) for m in _GLOBAL.finditer(p.read_text())}


def _template_args(code: str) -> Tuple:
    """Decode the template arguments of a mangled kernel name: the text
    between the name's ``I`` and its ``E``. A substitution (``S_``,
    ``S1_``, ...) repeats a class type already named; the kernels' only
    repeated class argument is the one named last."""
    out: List = []
    last_class = None
    i = 0
    while i < len(code) and code[i] != "E":
        c = code[i]
        if c == "L":
            kind = code[i + 1]
            end = code.index("E", i)
            value = code[i + 2:end]
            out.append(bool(int(value)) if kind == "b" else int(value.replace("n", "-")))
            i = end + 1
        elif c.isdigit():
            m = re.match(r"\d+", code[i:])
            n = int(m.group())
            start = i + len(m.group())
            last_class = code[start:start + n]
            out.append(last_class)
            i = start + n
        elif c == "S":
            end = code.index("_", i)
            out.append(last_class)
            i = end + 1
        elif c in _BUILTIN:
            out.append(_BUILTIN[c])
            i += 1
        else:
            raise ValueError(f"unsupported template argument code {code[i:]!r}")
    return tuple(out)


def _kernel_of(symbol: str, names: Mapping[str, str]) -> Tuple[Optional[str], Tuple]:
    for name in sorted(names, key=len, reverse=True):
        tag = f"{len(name)}{name}"
        at = symbol.find(tag)
        if at >= 0:
            rest = symbol[at + len(tag):]
            return name, _template_args(rest[1:]) if rest.startswith("I") else ()
    return None, ()


def resource_report(text: Optional[str] = None, names: Optional[Mapping[str, str]] = None) -> List[ResourceRow]:
    """The ptxas report (``text``, by default the library's own,
    :func:`ptxas_report`) as one :class:`ResourceRow` per compiled kernel.
    ``names`` ({kernel name: source file}, by default :func:`kernel_names`)
    tells the kernels' names in the mangled symbols; a symbol of no known
    kernel keeps its mangled name as ``kernel`` and the source "?"."""
    text = ptxas_report() if text is None else text
    names = kernel_names() if names is None else names
    rows = []
    parts = _ENTRY.split(text)
    for symbol, body in zip(parts[1::2], parts[2::2]):
        frame, used = _FRAME.search(body), _USED.search(body)
        if frame is None or used is None:
            raise ValueError(f"ptxas report: no register or spill line for {symbol}")
        kernel, args = _kernel_of(symbol, names)
        smem = _SMEM.search(used.group())
        rows.append(ResourceRow(kernel or symbol, names.get(kernel, "?"), args, symbol, int(used.group(1)),
                                int(frame.group(2)), int(frame.group(3)), int(frame.group(1)),
                                int(smem.group(1)) if smem else 0))
    return rows


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """Look up a C entry point and declare its signature (int return)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


PTR = ctypes.c_void_p
SIZE = ctypes.c_longlong
F32 = ctypes.c_float
INT = ctypes.c_int


def check_operands(kernel: str, *, dtypes: Optional[Mapping[str, Tuple[torch.dtype, ...]]] = None,
                   **tensors) -> torch.device:
    """What every wrapper requires of its operands: contiguous, one device
    (CPU, CUDA, or ``meta`` for a dry run, see :func:`on_meta`), and a
    dtype among ``dtypes[name]`` (torch.float32 for an operand ``dtypes``
    does not name). Returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{kernel}: unsupported device {device}")
    for name, t in tensors.items():
        allowed = (dtypes or {}).get(name, (torch.float32,))
        if t.dtype not in allowed:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, want one of {allowed}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    return device


def on_meta(wrapper, outs):
    """A wrapper's call on ``meta`` tensors (a dry run: shapes and dtypes,
    no data): count the call in ``wrapper.meta_calls`` (one a call, as the
    CUDA branch counts its launch; ``launches`` counts only real launches)
    and return ``outs``, ``meta`` tensors of the kernel's outputs. Neither
    the kernel nor its plain version runs."""
    wrapper.meta_calls += 1
    return outs


def meta_empty(shape, dtype=torch.float32) -> torch.Tensor:
    """An output of a dry-run call: a ``meta`` tensor, nothing allocated."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (what the planners size their grids to)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer, or None (a null pointer through ctypes)
    for an optional output that is switched off."""
    return t.data_ptr() if t is not None else None


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """Call a C entry point on ``device``'s current stream; raise on a
    non-zero ``cudaError_t`` (a refused launch never runs, and a later
    synchronise would not report it)."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
