"""Time B1 (``mega_slim_update_batched``) of this tree beside an earlier
commit's, in turns on one card.

The earlier commit's ``mega_slim.cu`` and ``common.cuh`` are taken from git,
in a checkout with its history (a copy without ``.git`` cannot):

    python3 scripts/slim_ab.py --fetch --rev HEAD~

which writes them under ``build/slim_ab/<rev>/``. On the card,

    python3 scripts/slim_ab.py --rev HEAD~

builds them with nvcc into a library of their own and times the earlier
kernel ("parent") and this tree's wrapper ("change") as parent / change /
change / parent on every slim group of chip_smoke.py's plans: full-width
gpt_small under Table 3 and the four baseline rule sets (AdaLayer,
AdaLayer-LN-TL, Adam-mini v1 and v2; phases 2 and 9a) and ResNet-18 under
Table 3 (phase 9c), on inputs drawn as chip_smoke's ``hold_group`` draws
them, without the flags and with both (``with_snr`` and ``with_health``).
Each time is ``chip_smoke.Timer``'s (median of ``--reps``, L2 flushed, a
device-side wait first); both versions are held to the plain twin first.
The earlier entry point is called with the signature it had before the
plan's arguments (``_parent_argtypes``). It prints the card's
``nvidia-smi`` line, a line per group and flag set (with this tree's form
from ``plan_slim``) and one JSON object.
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
FILES = ("mega_slim.cu", "common.cuh")
KW = dict(b1=0.9, b2=0.95, eps=1e-8)
FLAG_SETS = {"base": dict(), "flags": dict(with_snr=True, with_health=True)}


def _parent_argtypes():
    """``repro_mega_slim_update``'s signature before the plan's arguments."""
    from repro_torch.kernels import build

    return [build.PTR] * 12 + [build.SIZE] * 3 + [build.INT] + [build.F32] * 6 + [build.PTR]


def fetch(rev: str, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name in FILES:
        text = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], cwd=ROOT, capture_output=True, text=True,
                              check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {', '.join(FILES)} of {rev} to {out}")


def slim_groups(torch):
    """{(batch, rows, cols, axis): [plan labels]} over chip_smoke's plans."""
    from repro_torch.configs import get_config
    from repro_torch.core import baselines, rules_to_dims, table3_rules
    from repro_torch.core.labels import flatten_with_names
    from repro_torch.kernels import megaplan
    from repro_torch.models import ResNetConfig

    out = {}
    for model, spec in (("gpt_small", get_config("gpt_small").specs()), ("resnet18", ResNetConfig().specs())):
        specs = dict(flatten_with_names(spec))
        meta = {k: s.meta() for k, s in specs.items()}
        sets = {"table3": table3_rules(meta)}
        if model == "gpt_small":
            sets.update({n: getattr(baselines, f"{n}_rules")(meta)
                         for n in ("adalayer", "adalayer_ln_tl", "adam_mini_v1", "adam_mini_v2")})
        for label, rules in sets.items():
            dims = rules_to_dims(rules, meta)
            plan = megaplan.plan_megagroups([s.shape for s in specs.values()], [torch.float32] * len(specs),
                                            [dims[k] for k in specs])
            for g in plan.groups:
                if g.kind != "dense":
                    out.setdefault((g.batch, g.rows, g.cols, g.axis), []).append(f"{model}:{label}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rev", default="HEAD~", help="the earlier commit (a git revision)")
    ap.add_argument("--fetch", action="store_true", help="only write the earlier commit's sources (needs git)")
    ap.add_argument("--reps", type=int, default=10)
    cli = ap.parse_args()
    old_dir = ROOT / "build" / "slim_ab" / re.sub(r"[^\w.-]", "_", cli.rev)
    if cli.fetch:
        fetch(cli.rev, old_dir)
        return 0
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import build, megaplan
    from repro_torch.optim.fused import bias_corrections

    if not torch.cuda.is_available():
        print("slim_ab: no CUDA device", file=sys.stderr)
        return 2
    if not all((old_dir / name).exists() for name in FILES):
        print(f"slim_ab: run with --fetch --rev {cli.rev} in a git checkout first", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    lib_path = old_dir / "libold.so"
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
                    str(lib_path), str(old_dir / "mega_slim.cu")], check=True)
    old = ctypes.CDLL(str(lib_path))
    parent_argtypes = _parent_argtypes()
    sig = re.search(r'extern "C" int repro_mega_slim_update\((.*?)\)\s*{', (old_dir / "mega_slim.cu").read_text(),
                    re.S).group(1)
    if sig.count(",") + 1 != len(parent_argtypes):
        raise SystemExit("slim_ab: the earlier repro_mega_slim_update has another signature; compare with git instead")
    old_fn = old.repro_mega_slim_update
    old_fn.argtypes, old_fn.restype = parent_argtypes, ctypes.c_int
    dev = torch.device("cuda")

    def parent(g, m, v, bc1, bc2, axis, with_snr=False, with_health=False):
        """The earlier kernel through its entry point, outputs as the wrapper's."""
        b, r, c = g.shape
        u, m_out, v_out = torch.empty_like(g), torch.empty_like(g), torch.empty_like(v)
        snr = tuple(torch.empty_like(v) for _ in range(2)) if with_snr else (None, None)
        health = tuple(torch.empty_like(v) for _ in range(2)) if with_health else (None, None)
        build.launch("mega_slim_update_batched (earlier)", old_fn, dev,
                     *(t.data_ptr() for t in (g, m, v, bc1, bc2, u, m_out, v_out)), *map(build.ptr, snr + health),
                     b, r, c, axis, 1.0 / (c if axis == 1 else r), KW["b1"], 1.0 - KW["b1"], KW["b2"],
                     1.0 - KW["b2"], KW["eps"])
        return (u, m_out, v_out) + (snr if with_snr else ()) + (health if with_health else ())

    def change(g, m, v, bc1, bc2, axis, **flags):
        return megaplan.mega_slim_update_batched(g, m, v, bc1, bc2, axis=axis, **flags, **KW)

    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(0)
    bc1, bc2 = bias_corrections(0.9, 0.95, torch.tensor(3, dtype=torch.int32, device=dev))
    versions = {"parent": parent, "change": change}
    rows = []
    sms = build.sm_count(dev)
    for (b, r, c, axis), plans in sorted(slim_groups(torch).items()):
        line = (b, r, 1) if axis == 1 else (b, 1, c)
        g = 1e-3 * torch.randn((b, r, c), generator=gen, device=dev)
        m = 1e-4 * torch.randn((b, r, c), generator=gen, device=dev)
        v = 1e-6 * torch.rand(line, generator=gen, device=dev)
        ops = (g, m, v, bc1.expand(line).contiguous(), bc2.expand(line).contiguous(), axis)
        plan = megaplan.plan_slim(b, r, c, axis, sms=sms, aligned=True)
        form = f"{('ROWS', 'SPLIT', 'MAJOR')[plan.form]} nseg {plan.nseg} blocks {plan.blocks}"
        for label, flags in FLAG_SETS.items():
            want = megaplan.mega_slim_update_batched_plain(*ops[:5], axis=axis, **flags, **KW)
            errs = {}
            for name, fn in versions.items():
                got = fn(*ops, **flags)
                errs[name] = max(chip_smoke.max_err(a.nan_to_num(), w.nan_to_num())[1] for a, w in zip(got, want))
                if errs[name] > chip_smoke.TOL_LINE:
                    raise AssertionError(f"slim_ab: {name} on {(b, r, c)} axis {axis} {label} is {errs[name]:.3e} "
                                         "from the twin")
            times = {name: [] for name in versions}
            for name in ("parent", "change", "change", "parent"):
                times[name].append(timer(lambda: versions[name](*ops, **flags), reps=cli.reps))
            med = {name: statistics.median(t) for name, t in times.items()}
            row = dict(shape=[b, r, c], axis=axis, flags=label, form=form, plans=plans, parent_ms=med["parent"],
                       change_ms=med["change"], ratio=med["change"] / med["parent"], max_rel_err=errs, blocks=times)
            rows.append(row)
            print(f"  ({b}, {r}, {c}) axis {axis} {label}: parent {med['parent']:.4f} ms  change "
                  f"{med['change']:.4f} ms  ({row['ratio']:.3f}x)  [{form}]  {', '.join(plans)}", flush=True)
            del want
        del g, m, v, ops
    print(json.dumps(dict(device=smi, rev=cli.rev, reps=cli.reps, groups=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
