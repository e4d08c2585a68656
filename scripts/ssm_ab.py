"""Time B15 (``ssm_scan``), B8 (``snr_stats_batched``) and the split walk's
other two forms, B5 and B9, of this tree beside an earlier commit's
kernels, in turns on one card.

The earlier commit's ``ssm_scan.cu``, ``snr_stats.cu`` and ``common.cuh``
are taken from git, in a checkout with its history (a copy without
``.git`` cannot):

    python3 scripts/ssm_ab.py --fetch --rev HEAD~

which writes them under ``build/ssm_ab/<rev>/``. On the card,

    python3 scripts/ssm_ab.py --rev HEAD~

builds them with nvcc into a library of their own, and times the
earlier kernels ("parent") and this tree's wrappers ("change") as parent /
change / change / parent at chip_smoke.py's shapes: B15 at the eval shape
(1 x 2048 x 8192, N 16, bf16 x/B/C) and the decode shape (4 rows, S = 1),
B8 summed over full-width gpt_small's 11 second-moment leaves as lines of
their last axis (phase 8's views), and B5 and B9 summed over gpt_small's
21 SNR candidate views (phase 2's; chip_smoke times B9 on a mesh's local
shards instead). At the decode shape it also times this tree's sequence
walk with one chunk (``decode_seq_walk``) beside its one-token form. Each
time is ``chip_smoke.Timer``'s (median of ``--reps``, L2 flushed, a
device-side wait first); both versions are held to the plain twins first.
It prints the card's ``nvidia-smi`` line and one JSON object.
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
FILES = ("ssm_scan.cu", "snr_stats.cu", "common.cuh")


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
    from repro_torch.configs import get_config
    from repro_torch.core.labels import flatten_with_names
    from repro_torch.kernels import build, snr_stats as ss, ssm_scan as sc
    from repro_torch.kernels.ops import canon_apply, canon_nd

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
                    str(lib_path), str(old_dir / "ssm_scan.cu"), str(old_dir / "snr_stats.cu")], check=True)
    old = ctypes.CDLL(str(lib_path))
    old_scan_src = (old_dir / "ssm_scan.cu").read_text()
    old_snr_src = (old_dir / "snr_stats.cu").read_text()
    P, S, I = build.PTR, build.SIZE, build.INT
    dev = torch.device("cuda")

    def old_scan(x, dt, a, b_t, c_t, d_skip, h0):
        """The earlier B15 through its 15-parameter entry point (one
        launch walking the whole sequence)."""
        if n_params(old_scan_src, "repro_ssm_scan") != 15:
            raise SystemExit("ssm_ab: the earlier repro_ssm_scan has another signature; compare with git instead")
        bsz, s, d = x.shape
        n = a.shape[1]
        y = torch.empty((bsz, s, d), device=dev)
        h_out = torch.empty((bsz, d, n), device=dev)
        fn = old.repro_ssm_scan
        fn.argtypes, fn.restype = [P, I] + [P] * 8 + [S] * 3 + [I, P], ctypes.c_int
        build.launch("ssm_scan (earlier)", fn, dev, x.data_ptr(), int(x.dtype == torch.bfloat16), dt.data_ptr(),
                     a.data_ptr(), b_t.data_ptr(), c_t.data_ptr(), d_skip.data_ptr(), h0.data_ptr(), y.data_ptr(),
                     h_out.data_ptr(), bsz, s, d, n)
        return y, h_out

    def old_snr(v):
        """The earlier B8 on an axis-1 (B, R, C) view through its
        8-parameter entry point (one block a line)."""
        if n_params(old_snr_src, "repro_snr_stats") != 8:
            raise SystemExit("ssm_ab: the earlier repro_snr_stats has another signature; compare with git instead")
        b, r, c = v.shape
        s1, s2 = (torch.empty((b, r), device=dev) for _ in range(2))
        fn = old.repro_snr_stats
        fn.argtypes, fn.restype = [P] * 3 + [S] * 3 + [I, P], ctypes.c_int
        build.launch("snr_stats (earlier)", fn, dev, v.data_ptr(), s1.data_ptr(), s2.data_ptr(), b, r, c, 1)
        return s1, s2

    def old_centered(v, axis, partial):
        """The earlier B5 (B9 with ``partial``) through its 15-parameter
        entry point, on today's plan with a warp a line in the WARP form
        (the earlier planner's)."""
        if n_params(old_snr_src, "repro_snr_stats_centered") != 15:
            raise SystemExit("ssm_ab: the earlier repro_snr_stats_centered has another signature; compare with git "
                             "instead")
        b, r, c = v.shape
        plan = ss.plan_split(b, r, c, axis, sms=sms, aligned=v.data_ptr() % 16 == 0)
        blocks = -(-b * r // ss.WARPS) if plan.form == ss.FORM_WARP else plan.blocks
        outs = torch.empty((4 if partial else 3, b, r if axis == 1 else c), device=dev).unbind(0)
        part = torch.empty((3, plan.lines * plan.nseg), dtype=torch.float64, device=dev) if plan.nseg > 1 else None
        fn = old.repro_snr_stats_centered
        fn.argtypes, fn.restype = [P] * 6 + [S] * 3 + [I] * 2 + [S] * 3 + [P], ctypes.c_int
        build.launch("snr_stats_centered (earlier)", fn, dev, v.data_ptr(), *(o.data_ptr() for o in outs[:3]),
                     build.ptr(outs[3] if partial else None), build.ptr(part), b, r, c, plan.form, int(plan.vec),
                     plan.seg, plan.nseg, blocks)
        return outs

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
                     y.data_ptr(), h_out.data_ptr(), None, None, bsz, s, d, n, sc.FORM_SEQ, chunk, 1, int(vec))
        return y, h_out

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(8)
    scans = {case: chip_smoke.scan_case(torch, gen, b, s, 8192, 16, torch.bfloat16)
             for case, (b, s) in (("eval", (1, 2048)), ("decode", (4, 1)))}
    specs = dict(flatten_with_names(get_config("gpt_small").specs()))
    lines = [torch.rand(spec.shape, generator=gen, device=dev).reshape(1, -1, spec.shape[-1])
             for spec in specs.values()]
    cands = []
    for name, spec in specs.items():
        meta = spec.meta()
        for axes in meta.candidate_ks().values():
            cn = canon_nd(spec.shape, meta.dims_of(axes))
            v3 = canon_apply(torch.randn(spec.shape, generator=gen, device=dev) ** 2, cn).contiguous()
            cands.append((v3 if v3.ndim == 3 else v3[None], cn.axis))
    if len(cands) != 21:
        raise AssertionError(f"ssm_ab: expected 21 SNR candidates, got {len(cands)}")
    versions = {
        "parent": dict(scan=old_scan, b8=old_snr, b5=lambda v, ax: old_centered(v, ax, False),
                       b9=lambda v, ax: old_centered(v, ax, True)),
        "change": dict(scan=sc.ssm_scan, b8=lambda v: ss.snr_stats_batched(v, axis=1),
                       b5=lambda v, ax: ss.snr_stats_centered_batched(v, axis=ax),
                       b9=lambda v, ax: ss.snr_stats_centered_partial_batched(v, axis=ax))}
    twins = dict(b5=ss.snr_stats_centered_batched_plain, b9=ss.snr_stats_centered_partial_batched_plain)

    errs = {}
    for name, fns in versions.items():
        worst = 0.0
        scan_fns = [fns["scan"]] + ([seq_walk] if name == "change" else [])
        for scan in scan_fns:
            for case, call in scans.items():
                (y, h), (y_w, h_w) = scan(*call), sc.ssm_scan_plain(*call)
                worst = max(worst, chip_smoke.max_err(y, y_w)[1], chip_smoke.max_err(h, h_w)[1])
        for v in lines:
            for got, want in zip(fns["b8"](v), ss.snr_stats_batched_plain(v, axis=1)):
                worst = max(worst, chip_smoke.max_err(got, want)[1])
        for key, twin in twins.items():
            for v, ax in cands:
                for got, want in list(zip(fns[key](v, ax), twin(v, axis=ax)))[:3]:  # B9's v0 is a copy
                    worst = max(worst, chip_smoke.max_err(got, want)[1])
        torch.cuda.synchronize()
        if worst > chip_smoke.TOL_LINE:
            raise AssertionError(f"ssm_ab: {name} is {worst:.3e} from the twins")
        errs[name] = worst

    keys = ("eval", "decode", "b8_11_leaves", "b5_21_candidates", "b9_21_candidates")
    runs = []
    for name in ("parent", "change", "change", "parent"):
        fns = versions[name]
        row = {case: timer(lambda: fns["scan"](*call), reps=args.reps) for case, call in scans.items()}
        row["b8_11_leaves"] = sum(timer(lambda: fns["b8"](v), reps=args.reps) for v in lines)
        for key in ("b5", "b9"):
            row[f"{key}_21_candidates"] = sum(timer(lambda: fns[key](v, ax), reps=args.reps) for v, ax in cands)
        if name == "change":
            row["decode_seq_walk"] = timer(lambda: seq_walk(*scans["decode"]), reps=args.reps)
        runs.append(dict(version=name, **row))
        print(f"{name}: B15 eval {row['eval']:.4f} ms  decode {row['decode']:.4f} ms"
              + (f" (one-chunk walk {row['decode_seq_walk']:.4f} ms)" if name == "change" else "")
              + f"  B8 over {len(lines)} leaves {row['b8_11_leaves']:.4f} ms  B5 / B9 over {len(cands)} "
              f"candidates {row['b5_21_candidates']:.4f} / {row['b9_21_candidates']:.4f} ms", flush=True)
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
