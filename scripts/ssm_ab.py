"""Time the selective scan, B15 (``ssm_scan``), and its backward
(``ssm_scan_bwd``) of this tree beside an earlier commit's kernels, in
turns on one card.

The earlier commit's ``ssm_scan.cu``, ``ssm_scan_bwd.cu`` and
``common.cuh`` are taken from git, in a checkout with its history (a copy
without ``.git`` cannot); the earlier commit needs the backward kernel and
B15's 21-parameter entry point (the chunked B15 with the one-warp
backward):

    python3 scripts/ssm_ab.py --fetch --rev HEAD~

which writes them under ``build/ssm_ab/<rev>/``. On the card,

    python3 scripts/ssm_ab.py --rev HEAD~

builds them with nvcc into a library of their own, and times the
earlier kernels ("parent") and this tree's wrappers ("change") as parent /
change / change / parent at chip_smoke.py's shapes: B15 at the eval shape
(1 x 2048 x 8192, N 16, bf16 x/B/C) and the decode shape (4 rows, S = 1),
B15's training form (2 x 2048, keeping what the backward needs: the
parent's chunk-end carries, this tree's tile states) and the backward at
phase 7f's training shape (2 x 2048) and one-chunk shape (4 x 256), each
version from its own forward's states. At the decode shape it also times
this tree's sequence walk with one chunk (``decode_seq_walk``) beside its
one-token form. Each time is ``chip_smoke.Timer``'s (median of ``--reps``,
L2 flushed, a device-side wait first); both versions are held to the plain
twins first. It prints the card's ``nvidia-smi`` line and one JSON object.
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
FILES = ("ssm_scan.cu", "ssm_scan_bwd.cu", "common.cuh")


def fetch(rev: str, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name in FILES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {', '.join(FILES)} of {rev} to {out}")


def n_params(source: str, entry: str) -> int:
    """How many parameters the C entry point ``entry`` takes in ``source``."""
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)\s*{{', source, re.S).group(1)
    return sig.count(",") + 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rev", default="HEAD~", help="the earlier commit (a git revision)")
    ap.add_argument("--fetch", action="store_true", help="only write the earlier commit's sources (needs git)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    old_dir = ROOT / "build" / "ssm_ab" / re.sub(r"[^\w.-]", "_", args.rev)
    if args.fetch:
        fetch(args.rev, old_dir)
        return 0
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import build, ssm_scan as sc

    if not torch.cuda.is_available():
        print("ssm_ab: no CUDA device", file=sys.stderr)
        return 2
    if not all((old_dir / name).exists() for name in FILES):
        print(f"ssm_ab: run with --fetch --rev {args.rev} in a git checkout first", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # The earlier kernels, built on their own.
    lib_path = old_dir / "libold.so"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
                    str(lib_path), *(str(old_dir / name) for name in FILES if name.endswith(".cu"))], check=True)
    old = ctypes.CDLL(str(lib_path))
    old_scan_src = (old_dir / "ssm_scan.cu").read_text()
    old_bwd_src = (old_dir / "ssm_scan_bwd.cu").read_text()
    if n_params(old_scan_src, "repro_ssm_scan") != 21 or n_params(old_bwd_src, "repro_ssm_scan_bwd") != 32:
        raise SystemExit("ssm_ab: the earlier entry points have other signatures; compare with git instead")
    P, S, I = build.PTR, build.SIZE, build.INT
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def old_scan(x, dt, a, b_t, c_t, d_skip, h0, keep_bounds=False):
        """The earlier B15 through its 21-parameter entry point (the chunked
        sequence form) on this tree's ``plan_scan`` (the same planner); with
        ``keep_bounds`` it also returns its chunk-end carries and chunk
        length, what that commit's backward replays from."""
        bsz, s, d = x.shape
        n = a.shape[1]
        y = torch.empty((bsz, s, d), device=dev)
        h_out = torch.empty((bsz, d, n), device=dev)
        plan = sc.plan_scan(bsz, s, d, n, sms=sms)
        carry = dt_sum = None
        if plan.chunks > 1:
            carry = torch.empty((bsz, plan.chunks - 1, d, n), device=dev)
            dt_sum = torch.empty((bsz, plan.chunks - 1, d), device=dev)
        fn = old.repro_ssm_scan
        fn.argtypes, fn.restype = [P, I] + [P] * 10 + [S] * 3 + [I] * 2 + [S] + [I] * 2 + [P], ctypes.c_int
        vec = all(t.data_ptr() % 16 == 0 for t in (x, dt, a, h0, h_out))
        build.launch("ssm_scan (earlier)", fn, dev, x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(),
                     a.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), d_skip.data_ptr(), h0.data_ptr(), y.data_ptr(),
                     h_out.data_ptr(), build.ptr(carry), build.ptr(dt_sum), bsz, s, d, n, plan.form, plan.chunk,
                     plan.chunks, int(vec))
        if keep_bounds:
            return (y, h_out, carry, plan.chunk) if carry is not None else (y, h_out, None, s)
        return y, h_out

    def old_bwd(x, dt, a, b_t, c_t, d_skip, h0, dy, dhf, bounds, chunk):
        """The earlier backward through its 32-parameter entry point (a warp
        per 32 / (N / 4) channels over the forward's chunks, each replayed
        from its boundary) on its own plan."""
        bsz, s, d = x.shape
        n = a.shape[1]
        np_ = 4 if n <= 4 else 8 if n <= 8 else 16
        chunk = min(chunk, s)
        chunks, tiles, warps = -(-s // chunk), -(-chunk // 16), -(-d // (32 // (np_ // 4)))
        f32 = dict(dtype=torch.float32, device=dev)
        dx, ddt = torch.empty((bsz, s, d), dtype=x.dtype, device=dev), torch.empty((bsz, s, d), **f32)
        db, dc = torch.empty((bsz, s, n), **f32), torch.empty((bsz, s, n), **f32)
        da, dd, dh0 = torch.empty((d, n), **f32), torch.empty((d,), **f32), torch.empty((bsz, d, n), **f32)
        ws = [torch.empty(shape, **f32) for shape in ((bsz, tiles, d, np_), (bsz, s, warps, 2 * np_), (bsz, d, n),
                                                      (bsz, d))]
        fn = old.repro_ssm_scan_bwd
        fn.argtypes, fn.restype = [P, I] + [P] * 21 + [S] * 3 + [I, S] + [I] * 3 + [P], ctypes.c_int
        build.launch("ssm_scan_bwd (earlier)", fn, dev, x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(),
                     a.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), d_skip.data_ptr(), h0.data_ptr(),
                     build.ptr(bounds), dy.data_ptr(), build.ptr(dhf), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
                     db.data_ptr(), dc.data_ptr(), dd.data_ptr(), dh0.data_ptr(), None, *(t.data_ptr() for t in ws),
                     bsz, s, d, n, chunk, chunks, tiles, warps)
        return dx, ddt, da, db, dc, dd, dh0

    def seq_walk(x, dt, a, b_t, c_t, d_skip, h0):
        """This tree's sequence walk as one chunk, at any S (the one-token
        form's alternative at S = 1)."""
        bsz, s, d = x.shape
        n = a.shape[1]
        y = torch.empty((bsz, s, d), device=dev)
        h_out = torch.empty((bsz, d, n), device=dev)
        chunk = -(-s // sc.TILE) * sc.TILE
        vec = all(t.data_ptr() % 16 == 0 for t in (x, dt, a, h0, h_out))
        build.launch("ssm_scan (one chunk)", sc._entry(), dev, x.data_ptr(), int(x.dtype == torch.bfloat16),
                     dt.data_ptr(), a.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), d_skip.data_ptr(), h0.data_ptr(),
                     y.data_ptr(), h_out.data_ptr(), None, None, None, bsz, s, d, n, sc.FORM_SEQ, chunk, 1, int(vec))
        return y, h_out

    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(8)
    scans = {case: chip_smoke.scan_case(torch, gen, b, s, 8192, 16, torch.bfloat16)
             for case, (b, s) in (("eval", (1, 2048)), ("decode", (4, 1)))}
    # the backward's cases: its operands, dy and dh_final
    bwd_cases = {}
    for case, (b, s) in (("train", (2, 2048)), ("one_chunk", (4, 256))):
        call = chip_smoke.scan_case(torch, gen, b, s, 8192, 16, torch.bfloat16)
        dy = torch.randn((b, s, 8192), generator=gen, device=dev).to(torch.bfloat16)
        dhf = torch.randn((b, 8192, 16), generator=gen, device=dev)
        bwd_cases[case] = (call, dy, dhf)
    train_fwd = bwd_cases["train"][0]

    def change_bwd(case):
        """This tree's backward of ``case``, from this tree's kept tile states."""
        call, dy, dhf = bwd_cases[case]
        states = sc.ssm_scan(*call, keep_bounds=True)[2]
        return lambda: sc.ssm_scan_bwd(*call, dy, dhf, states=states)

    def parent_bwd(case):
        """The earlier backward of ``case``, from the earlier forward's carries."""
        call, dy, dhf = bwd_cases[case]
        _, _, bounds, chunk = old_scan(*call, keep_bounds=True)
        return lambda: old_bwd(*call, dy, dhf, bounds, chunk)

    versions = {"parent": dict(scan=old_scan, train=lambda: old_scan(*train_fwd, keep_bounds=True), bwd=parent_bwd),
                "change": dict(scan=sc.ssm_scan, train=lambda: sc.ssm_scan(*train_fwd, keep_bounds=True),
                               bwd=change_bwd)}
    bwd_runs = {name: {case: fns["bwd"](case) for case in bwd_cases} for name, fns in versions.items()}

    errs = {}
    for name, fns in versions.items():
        worst = 0.0
        scan_fns = [fns["scan"]] + ([seq_walk] if name == "change" else [])
        for scan in scan_fns:
            for case, call in scans.items():
                (y, h), (y_w, h_w) = scan(*call), sc.ssm_scan_plain(*call)
                worst = max(worst, chip_smoke.max_err(y, y_w)[1], chip_smoke.max_err(h, h_w)[1])
        if worst > chip_smoke.TOL_LINE:
            raise AssertionError(f"ssm_ab: {name}'s B15 is {worst:.3e} from the twin")
        for case, (call, dy, dhf) in bwd_cases.items():
            for got, want in zip(bwd_runs[name][case](), sc.ssm_scan_bwd_plain(*call, dy, dhf)):
                tol = chip_smoke.TOL_SSM_BWD_DX_BF16 if got.dtype == torch.bfloat16 else chip_smoke.TOL_SSM_BWD
                err = chip_smoke.max_err(got, want)[1]
                if err > tol:
                    raise AssertionError(f"ssm_ab: {name}'s backward ({case}) is {err:.3e} from the twin, tol {tol}")
                worst = max(worst, err)
        torch.cuda.synchronize()
        errs[name] = worst

    keys = ("eval", "decode", "train_fwd", "bwd_train", "bwd_one_chunk")
    runs = []
    for name in ("parent", "change", "change", "parent"):
        fns = versions[name]
        row = {case: timer(lambda: fns["scan"](*call), reps=args.reps) for case, call in scans.items()}
        row["train_fwd"] = timer(fns["train"], reps=args.reps)
        for case, run in bwd_runs[name].items():
            row[f"bwd_{case}"] = timer(run, reps=args.reps)
        if name == "change":
            row["decode_seq_walk"] = timer(lambda: seq_walk(*scans["decode"]), reps=args.reps)
        runs.append(dict(version=name, **row))
        print(f"{name}: B15 eval {row['eval']:.4f} ms  decode {row['decode']:.4f} ms"
              + (f" (one-chunk walk {row['decode_seq_walk']:.4f} ms)" if name == "change" else "")
              + f"  training form {row['train_fwd']:.4f} ms  backward {row['bwd_train']:.4f} ms (one chunk "
              f"{row['bwd_one_chunk']:.4f} ms)", flush=True)
    median = {name: {key: statistics.median(r[key] for r in runs if r["version"] == name) for key in keys}
              for name in versions}
    median["change"]["decode_seq_walk"] = statistics.median(r["decode_seq_walk"] for r in runs
                                                            if r["version"] == "change")
    ratio = {key: median["change"][key] / median["parent"][key] for key in keys}
    print("change / parent: " + "  ".join(f"{key} {ratio[key]:.3f}" for key in keys)
          + f"; one-token form / one-chunk walk at decode "
          f"{median['change']['decode'] / median['change']['decode_seq_walk']:.3f}", flush=True)
    print(json.dumps(dict(device=smi, rev=args.rev, reps=args.reps, max_rel_err=errs, runs=runs, median=median,
                          ratio=ratio)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
