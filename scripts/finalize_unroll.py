"""Time B11's flat walk (``repro_slim_finalize_flat`` in
``src/repro_torch/kernels/csrc/slim_finalize.cu``) with two and with four
vectors a thread in flight, in turns on one card.

    python3 scripts/finalize_unroll.py

copies this tree's ``slim_finalize.cu`` twice into
``build/finalize_unroll/u<N>/`` with ``kFlatUnroll`` set to 2 and 4, builds
each with nvcc (ptxas's register and spill report kept), and times both as
u2 / u4 / u4 / u2 at chip_smoke.py's phase 6a shapes (rank 0's local shards
of full-width gpt_small's 7 psum leaves on a (data=2, model=2) mesh, the
``LEAVES`` of ``finalize_ab.py``), owner and ek form, each on
``plan_finalize``'s grid with its blocks counted for that unroll. Both are
held to the plain twin bit for bit first. Each time is
``chip_smoke.Timer``'s (median of ``--reps``, L2 flushed, a device-side wait
first). It prints the card's ``nvidia-smi`` line and one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

from finalize_ab import KW, LEAVES

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
UNROLLS = (2, 4)


def build_variant(unroll: int, nvcc: str, arch: list) -> tuple:
    """This tree's slim_finalize.cu with kFlatUnroll = ``unroll``, built
    into a library of its own; returns it and each flat kernel's spill
    stores in bytes."""
    out = ROOT / "build" / "finalize_unroll" / f"u{unroll}"
    out.mkdir(parents=True, exist_ok=True)
    text, n = re.subn(r"constexpr int kFlatUnroll = \d+;", f"constexpr int kFlatUnroll = {unroll};",
                      (CSRC / "slim_finalize.cu").read_text())
    if n != 1:
        raise SystemExit("finalize_unroll: kFlatUnroll not found in slim_finalize.cu")
    (out / "slim_finalize.cu").write_text(text)
    lib = out / "libflat.so"
    run = subprocess.run([nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-I",
                          str(CSRC), "-o", str(lib), str(out / "slim_finalize.cu")],
                         capture_output=True, text=True, check=True)
    spills = dict(re.findall(r"Function properties for (\S*finalize_flat_kernel\S*)\n\s*\d+ bytes stack frame, "
                             r"(\d+) bytes spill stores", run.stdout + run.stderr))
    return ctypes.CDLL(str(lib)), {name: int(b) for name, b in spills.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import build, slim_update
    from repro_torch.kernels.fused_adam import bias_corrections

    if not torch.cuda.is_available():
        print("finalize_unroll: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    sms = build.sm_count(dev)
    libs, spills = {}, {}
    for unroll in UNROLLS:
        lib, spills[unroll] = build_variant(unroll, build._nvcc(), build.ARCH)
        fn = lib.repro_slim_finalize_flat
        fn.argtypes, fn.restype = slim_update._FLAT_ARGTYPES, ctypes.c_int
        libs[unroll] = fn

    count = torch.tensor(3, dtype=torch.int32, device=dev)
    bc1, bc2 = bias_corrections(KW["b1"], KW["b2"], count)
    gen = torch.Generator(device=dev).manual_seed(19)

    def case(b, r, c, axis):
        line = (b, r, 1) if axis == 1 else (b, 1, c)
        m_new = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
        v = 1e-6 * torch.rand(line, generator=gen, device=dev) + 1e-8
        ek = 1e-6 * torch.rand(line, generator=gen, device=dev)
        return m_new, v, ek, axis

    leaves = {name: case(*shape) for name, shape in LEAVES.items()}

    def finalize(unroll, m_new, v, ek, axis):
        """This tree's launch with the variant's library and its grid."""
        plan = slim_update.plan_finalize(*m_new.shape, axis, sms)
        plan = dataclasses.replace(plan, blocks=min(-(-plan.vectors // (slim_update.FLAT_THREADS * unroll)),
                                                    slim_update.FLAT_BLOCKS_PER_SM * sms))
        u = torch.empty_like(m_new)
        v_out = torch.empty_like(v) if ek is not None else None
        build.launch(f"finalize_flat u{unroll}", libs[unroll], dev, m_new.data_ptr(), v.data_ptr(), build.ptr(ek),
                     None, None, u.data_ptr(), build.ptr(v_out), count.data_ptr(), 0, 1.0, 1.0, KW["b1"], KW["b2"],
                     1.0 - KW["b2"], KW["eps"], plan.batch, plan.rows, plan.cols, plan.axis, plan.vec,
                     int(plan.wide), plan.blocks)
        return u if ek is None else (u, v_out)

    for unroll in UNROLLS:
        for m_new, v, ek, axis in leaves.values():
            for e in (ek, None):
                got = finalize(unroll, m_new, v, e, axis)
                want = slim_update.slim_finalize_batched_plain(m_new, v, bc1, bc2, b2=KW["b2"], eps=KW["eps"], ek=e)
                for a, w in zip(*((got, want) if e is not None else ((got,), (want,)))):
                    if not torch.equal(a, w):
                        raise AssertionError(f"finalize_unroll: u{unroll} is not the twin")

    timer = chip_smoke.Timer(torch)
    runs = []
    for unroll in (2, 4, 4, 2):
        row = {}
        for form in ("owner", "ek"):
            for leaf, (m_new, v, ek, axis) in leaves.items():
                e = ek if form == "ek" else None
                row[f"{form} {leaf}"] = timer(lambda m=m_new, v=v, e=e, a=axis: finalize(unroll, m, v, e, a),
                                              reps=args.reps)
            row[f"{form}_7_leaves"] = sum(row[f"{form} {leaf}"] for leaf in leaves)
        runs.append(dict(unroll=unroll, **row))
        print(f"u{unroll}: " + "  ".join(f"{k} {t:.4f}" for k, t in row.items()), flush=True)
    keys = [k for k in runs[0] if k != "unroll"]
    median = {f"u{u}": {k: statistics.median(r[k] for r in runs if r["unroll"] == u) for k in keys} for u in UNROLLS}
    print(json.dumps(dict(device=smi, reps=args.reps, spill_stores=spills, runs=runs, median=median)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
