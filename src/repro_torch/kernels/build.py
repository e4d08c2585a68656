"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` expose plain C entry points (device pointers, sizes,
scalars and a stream; the return value is the launch's ``cudaError_t``), so
they compile without PyTorch's headers: one ``nvcc -c`` per source, all
started together, then one link into a shared library that ``ctypes`` loads.
The library lands in ``build/repro_torch/<hash>/`` at the repository root
(git-ignored), keyed by a hash of the sources and flags, and is built at first
use — never at import, so machines without ``nvcc`` can import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Mapping, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math: the kernels keep IEEE division and square root.
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# What the last build printed (nvcc/ptxas register and spill report) and how
# long it took; empty when the library came from the cache.
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
    """Compile every source in parallel, link, and move the library into
    place atomically (a concurrent builder of the same key is harmless)."""
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
    os.replace(tmp / LIB_NAME, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    cu, cuh = _sources()
    out = BUILD_ROOT / _key(cu, cuh) / LIB_NAME
    if not out.exists():
        t0 = time.perf_counter()
        out.parent.mkdir(parents=True, exist_ok=True)
        build_log["output"] = _compile(out, cu, _nvcc())
        build_log["seconds"] = time.perf_counter() - t0
    return ctypes.CDLL(str(out))


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
