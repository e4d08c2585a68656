"""Time B5 (``snr_stats_centered_batched``) and B9
(``snr_stats_centered_partial_batched``) of one ``repro_torch`` tree under
both of ``chip_smoke.Timer``'s yardsticks, beside ``torch.var_mean``.

The views are the ones ``chip_smoke.py`` holds: B5's on the 21 gpt_small SNR
candidates (phase 2), B9's on rank 0's local shards of those candidates on
the (data=2, model=2) mesh (phase 6a). Each view is timed with the timer's
device-side wait after the L2 flush ("new") and without it ("old", the
earlier timer, whose span also holds the host's time to enqueue the call),
each as a median of ``--reps``.

Compare two trees on one card in one call, in turns, e.g. the parent commit
unpacked under ``build/parent``:

    for t in build/parent . . build/parent; do
        python3 scripts/snr_timer_ab.py --src $t/src --label $t; done

Each run prints the card's ``nvidia-smi`` line and one JSON object with
every view's times and the totals.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (tag, canonical (B, R, C) view, reduction axis)
B5_VIEWS = [(f"{leaf} {k}", shape, axis)
            for leaf in ("attn.wk", "attn.wo", "attn.wq", "attn.wv")
            for k, shape, axis in (("fan_in", (12, 768, 768), 0), ("fan_out", (1, 9216, 768), 1),
                                   ("both", (1, 12, 589824), 1))] + [
    ("mlp.w_down fan_in", (12, 3072, 768), 0), ("mlp.w_down fan_out", (1, 36864, 768), 1),
    ("mlp.w_down both", (1, 12, 2359296), 1), ("mlp.w_up fan_in", (12, 768, 3072), 0),
    ("mlp.w_up fan_out", (1, 9216, 3072), 1), ("mlp.w_up both", (1, 12, 2359296), 1),
    ("embed fan_in", (1, 50304, 768), 0), ("embed fan_out", (1, 50304, 768), 1),
    ("embed both", (1, 1, 38633472), 1)]
B9_VIEWS = [(f"{leaf} {k}", shape, axis)
            for leaf in ("attn.wk", "attn.wo", "attn.wq", "attn.wv")
            for k, shape, axis in (("fan_in", (12, 384, 384), 0), ("fan_out", (1, 4608, 384), 1),
                                   ("both", (1, 12, 147456), 1))] + [
    ("mlp.w_down fan_in", (12, 1536, 384), 0), ("mlp.w_down fan_out", (1, 18432, 384), 1),
    ("mlp.w_down both", (1, 12, 589824), 1), ("mlp.w_up fan_in", (12, 384, 1536), 0),
    ("mlp.w_up fan_out", (1, 4608, 1536), 1), ("mlp.w_up both", (1, 12, 589824), 1),
    ("embed fan_in", (1, 25152, 384), 0), ("embed fan_out", (1, 25152, 384), 1),
    ("embed both", (1, 1, 9658368), 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src/ directory (repro_torch inside)")
    ap.add_argument("--label", default="", help="a name printed with the results")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import snr_stats

    if not torch.cuda.is_available():
        print("snr_timer_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    timers = {"new": chip_smoke.Timer(torch), "old": chip_smoke.Timer(torch, slack_cycles=0)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = dict(label=args.label, src=args.src, device=smi, reps=args.reps)
    for kernel, fn, views in (("B5", snr_stats.snr_stats_centered_batched, B5_VIEWS),
                              ("B9", snr_stats.snr_stats_centered_partial_batched, B9_VIEWS)):
        rows, total = [], {f"{t}_{w}": 0.0 for t in timers for w in ("ms", "var_mean_ms")}
        for tag, shape, axis in views:
            x = torch.randn(shape, generator=gen, device="cuda")
            v3 = x * x
            red = 2 if axis == 1 else 1
            row = dict(tag=tag, shape=list(shape), axis=axis)
            for t, timer in timers.items():
                row[f"{t}_ms"] = timer(lambda: fn(v3, axis=axis), reps=args.reps)
                row[f"{t}_var_mean_ms"] = timer(lambda: torch.var_mean(v3, dim=red, correction=0), reps=args.reps)
            for k in total:
                total[k] += row[k]
            rows.append(row)
            del x, v3
        out[kernel] = dict(total, views=rows)
        print(f"{args.label} {kernel}: " + "  ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
