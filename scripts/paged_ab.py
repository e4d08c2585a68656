"""Time B14 (``repro_torch.kernels.paged_attention``) of one ``repro_torch``
tree at the cases ``chip_smoke.py``'s phase 4 holds, beside
``scaled_dot_product_attention`` and the bound.

The cases are full-width smollm_135m attention (9 query heads over 3 KV
groups, hd 64, pages of 16, 128-page table rows): 16 ragged decode rows and
the 128-token prefill chunks at pos0 = 0 and 1024, with f32 queries over a
bf16 and an f32 pool and bf16 queries over a bf16 pool. Each is timed by
``chip_smoke.Timer`` (median of ``--reps``, L2 flushed, a device-side wait
first), and its device time is split by kernel name with torch.profiler
over 5 calls, each after an L2 flush.

Compare two trees on one card in one call, in turns, e.g. the parent commit
unpacked under ``build/parent``:

    for t in build/parent . . build/parent; do
        python3 scripts/paged_ab.py --src $t/src --label $t; done

Each run prints the card's ``nvidia-smi`` line and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src/ directory (repro_torch inside)")
    ap.add_argument("--label", default="", help="a name printed with the results")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        print("paged_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    timer = chip_smoke.Timer(torch)
    rate = chip_smoke.mem_rate(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    dec = np.random.default_rng(0).integers(1, 2049, 16)
    dec[0], dec[1] = 0, 16 * 37 + 5
    cases = {"decode": dict(lengths=dec, alloc=dec, c=1),
             "prefill_pos0_0": dict(lengths=[128], alloc=[128], c=128),
             "prefill_pos0_1024": dict(lengths=[1024 + 128], alloc=[1024 + 100], c=128)}
    types = ((torch.float32, torch.bfloat16), (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16))
    out = dict(label=args.label, src=args.src, device=smi, reps=args.reps, cases={})
    for case, kw in cases.items():
        for q_dtype, pool_dtype in types:
            q, pool, table, lengths = chip_smoke.paged_case(torch, gen, pool_dtype=pool_dtype, q_dtype=q_dtype, **kw)
            call = (q, pool, table, lengths)
            pa.paged_attention(*call)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    timer.flush.zero_()
                    pa.paged_attention(*call)
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.key_averages():
                name = re.search(r"paged_\w+?(?=<|\()", e.key)
                if getattr(e, "device_type", None) == DeviceType.CUDA and name:
                    kernels[name.group(0)] = kernels.get(name.group(0), 0.0) + e.self_device_time_total / 5 / 1e3
            tag = f"{case} {str(q_dtype)[6:]} q {str(pool_dtype)[6:]} pool"
            bound, by = chip_smoke.paged_bound(*call, rate)
            row = dict(ms=timer(lambda: pa.paged_attention(*call), reps=args.reps),
                       sdpa_ms=timer(chip_smoke.sdpa_call(torch, *call), reps=args.reps),
                       bound_ms=bound, bound_by=by, device_ms_by_kernel=kernels)
            out["cases"][tag] = row
            print(f"{args.label} {tag}: kernel {row['ms']:.4f} ms  SDPA {row['sdpa_ms']:.4f} ms  "
                  f"bound {bound:.4f} ms ({by})  by kernel {kernels}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
