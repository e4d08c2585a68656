"""Time B11 (``slim_finalize_batched``) and B13
(``mega_slim_finalize_batched``) of this tree beside an earlier commit's,
in turns on one card.

The earlier commit's ``slim_finalize.cu`` and ``common.cuh`` are taken from
git, in a checkout with its history (a copy without ``.git`` cannot):

    python3 scripts/finalize_ab.py --fetch --rev HEAD~

which writes them under ``build/finalize_ab/<rev>/``. On the card,

    python3 scripts/finalize_ab.py --rev HEAD~

builds them with nvcc into a library of their own, and times the earlier
kernels ("parent") and this tree's wrappers ("change") as parent / change /
change / parent at chip_smoke.py's phase 6a shapes: rank 0's local shards
of full-width gpt_small's 7 psum leaves on a (data=2, model=2) mesh for
B11, owner form (as chip_smoke times it) and ek form, and the 3 psum
groups of the grouped route for B13. The parent's B11 is its wrapper's
work: torch forms the bias corrections from the 0-d int32 count on the
card, then the kernel runs; "parent_kernel" is that kernel alone, given
the corrections. A device copy of B11's bytes (``Tensor.copy_`` of m'
into u, leaf by leaf) is timed in each turn as the yardstick of what
streaming them takes under this timer. Each time is ``chip_smoke.Timer``'s (median of
``--reps``, L2 flushed, a device-side wait first); both versions are held
to the plain twin first. It prints the card's ``nvidia-smi`` line and one
JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
FILES = ("slim_finalize.cu", "common.cuh")
# chip_smoke.py phase 6a's local shards on rank 0: (B, R, C, axis).
LEAVES = {"attn.wk": (12, 384, 384, 0), "attn.wo": (1, 4608, 384, 1), "attn.wq": (12, 384, 384, 0),
          "attn.wv": (1, 4608, 384, 1), "mlp.w_down": (1, 18432, 384, 1), "mlp.w_up": (1, 4608, 1536, 1),
          "embed": (1, 25152, 384, 1)}
GROUPS = {"batched[2]": (12, 384, 768, 0), "minor[4]": (1, 52800, 384, 1), "minor[1]": (1, 4608, 1536, 1)}
KW = dict(b1=0.9, b2=0.95, eps=1e-8)


def fetch(rev: str, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name in FILES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {', '.join(FILES)} of {rev} to {out}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rev", default="HEAD~", help="the earlier commit (a git revision)")
    ap.add_argument("--fetch", action="store_true", help="only write the earlier commit's sources (needs git)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    old_dir = ROOT / "build" / "finalize_ab" / re.sub(r"[^\w.-]", "_", args.rev)
    if args.fetch:
        fetch(args.rev, old_dir)
        return 0
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import build, megaplan, slim_update
    from repro_torch.kernels.fused_adam import bias_corrections

    if not torch.cuda.is_available():
        print("finalize_ab: no CUDA device", file=sys.stderr)
        return 2
    if not all((old_dir / name).exists() for name in FILES):
        print(f"finalize_ab: run with --fetch --rev {args.rev} in a git checkout first", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # The earlier kernels, built on their own.
    lib_path = old_dir / "libold.so"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
                    str(lib_path), str(old_dir / "slim_finalize.cu")], check=True)
    old = ctypes.CDLL(str(lib_path))
    sig = re.search(r'extern "C" int repro_slim_finalize\((.*?)\)\s*{', (old_dir / "slim_finalize.cu").read_text(),
                    re.S).group(1)
    if sig.count(",") + 1 != 16:
        raise SystemExit("finalize_ab: the earlier repro_slim_finalize has another signature; compare with git instead")
    fn = old.repro_slim_finalize
    fn.argtypes, fn.restype = [build.PTR] * 7 + [build.SIZE] * 3 + [build.INT] + [build.F32] * 3 + \
        [build.INT, build.PTR], ctypes.c_int
    dev = torch.device("cuda")

    def old_finalize(m_new, v, ek, bc1, bc2, axis, scalar_bc):
        """The earlier kernel through its 16-parameter entry point."""
        u = torch.empty_like(m_new)
        v_out = torch.empty_like(v) if ek is not None else None
        b, r, c = m_new.shape
        build.launch("slim_finalize (earlier)", fn, dev, m_new.data_ptr(), v.data_ptr(), build.ptr(ek),
                     bc1.data_ptr(), bc2.data_ptr(), u.data_ptr(), build.ptr(v_out), b, r, c, axis, KW["b2"],
                     1.0 - KW["b2"], KW["eps"], int(scalar_bc))
        return u if ek is None else (u, v_out)

    def parent_b11(m_new, v, ek, axis, count):
        """The earlier B11 wrapper's device work: torch's bias corrections,
        then the kernel."""
        return old_finalize(m_new, v, ek, *bias_corrections(KW["b1"], KW["b2"], count), axis, True)

    gen = torch.Generator(device=dev).manual_seed(19)
    count = torch.tensor(3, dtype=torch.int32, device=dev)
    bc1, bc2 = bias_corrections(KW["b1"], KW["b2"], count)

    def case(b, r, c, axis):
        line = (b, r, 1) if axis == 1 else (b, 1, c)
        m_new = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
        v = 1e-6 * torch.rand(line, generator=gen, device=dev) + 1e-8
        ek = 1e-6 * torch.rand(line, generator=gen, device=dev)
        return m_new, v, ek, axis

    leaves = {name: case(*shape) for name, shape in LEAVES.items()}
    groups = {}
    for name, shape in GROUPS.items():
        m_new, v, ek, axis = case(*shape)
        groups[name] = (m_new, v, ek, axis, bc1.expand(v.shape).contiguous(), bc2.expand(v.shape).contiguous())

    versions = {
        "parent": dict(b11=lambda m, v, e, a: parent_b11(m, v, e, a, count),
                       b13=lambda m, v, e, a, l1, l2: old_finalize(m, v, e, l1, l2, a, False)),
        "change": dict(b11=lambda m, v, e, a: slim_update.slim_finalize_batched(m, v, axis=a, ek=e, count=count,
                                                                              **KW),
                       b13=lambda m, v, e, a, l1, l2: megaplan.mega_slim_finalize_batched(
                           m, v, l1, l2, axis=a, ek=e, b2=KW["b2"], eps=KW["eps"]))}
    errs = {}
    for name, fns in versions.items():
        worst = 0.0
        for m_new, v, ek, axis in leaves.values():
            for e in (ek, None):
                got = fns["b11"](m_new, v, e, axis)
                want = slim_update.slim_finalize_batched_plain(m_new, v, bc1, bc2, b2=KW["b2"], eps=KW["eps"], ek=e)
                for a, w in zip(*((got, want) if e is not None else ((got,), (want,)))):
                    worst = max(worst, chip_smoke.max_err(a, w)[1])
        for m_new, v, ek, axis, l1, l2 in groups.values():
            for e in (ek, None):
                got = fns["b13"](m_new, v, e, axis, l1, l2)
                want = slim_update.slim_finalize_batched_plain(m_new, v, l1, l2, b2=KW["b2"], eps=KW["eps"], ek=e)
                for a, w in zip(*((got, want) if e is not None else ((got,), (want,)))):
                    worst = max(worst, chip_smoke.max_err(a, w)[1])
        torch.cuda.synchronize()
        if worst > chip_smoke.TOL_ELEMENTWISE:
            raise AssertionError(f"finalize_ab: {name} is {worst:.3e} from the twin")
        errs[name] = worst

    timer = chip_smoke.Timer(torch)
    reps = args.reps
    runs = []
    for name in ("parent", "change", "change", "parent"):
        fns = versions[name]
        row = {f"b11 {leaf}": timer(lambda x=x: fns["b11"](*x[:2], None, x[3]), reps=reps)
               for leaf, x in leaves.items()}
        row["b11_7_leaves"] = sum(row[f"b11 {leaf}"] for leaf in leaves)
        row["b11_ek_7_leaves"] = sum(timer(lambda x=x: fns["b11"](*x), reps=reps) for x in leaves.values())
        row["b13_3_groups"] = sum(timer(lambda x=x: fns["b13"](x[0], x[1], None, *x[3:]), reps=reps)
                                  for x in groups.values())
        # The yardstick: one device copy of the same bytes (m read, u written) a leaf.
        row["copy_7_leaves"] = sum(timer(lambda x=x, u=torch.empty_like(x[0]): u.copy_(x[0]), reps=reps)
                                   for x in leaves.values())
        if name == "parent":
            row["b11_kernel_7_leaves"] = sum(timer(lambda x=x: old_finalize(x[0], x[1], None, bc1, bc2, x[3], True),
                                                   reps=reps) for x in leaves.values())
        runs.append(dict(version=name, **row))
        print(f"{name}: B11 over 7 leaves {row['b11_7_leaves']:.4f} ms (ek form {row['b11_ek_7_leaves']:.4f})"
              + (f" (kernel alone {row['b11_kernel_7_leaves']:.4f})" if name == "parent" else "")
              + f"  B13 over 3 groups {row['b13_3_groups']:.4f} ms; a copy of B11's bytes "
              f"{row['copy_7_leaves']:.4f} ms; per leaf "
              + "  ".join(f"{leaf} {row[f'b11 {leaf}']:.4f}" for leaf in leaves), flush=True)
    keys = [k for k in runs[1] if k != "version"]
    median = {name: {key: statistics.median(r[key] for r in runs if r["version"] == name) for key in keys}
              for name in versions}
    median["parent"]["b11_kernel_7_leaves"] = statistics.median(r["b11_kernel_7_leaves"] for r in runs
                                                                if r["version"] == "parent")
    ratio = {key: median["change"][key] / median["parent"][key] for key in keys}
    ratio["b11_vs_parent_kernel"] = median["change"]["b11_7_leaves"] / median["parent"]["b11_kernel_7_leaves"]
    print("change / parent: " + "  ".join(f"{key} {ratio[key]:.3f}" for key in
                                          ("b11_7_leaves", "b11_ek_7_leaves", "b13_3_groups", "b11_vs_parent_kernel")),
          flush=True)
    print(json.dumps(dict(device=smi, rev=args.rev, reps=reps, max_rel_err=errs, runs=runs, median=median,
                          ratio=ratio)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
