"""Time full-width gpt_small's bf16 training step of this tree beside other
trees', in turns on one card.

Each tree is a directory holding ``src/repro_torch`` (an unpacked
``git archive`` of another commit, say, under the git-ignored ``build/``):

    python3 scripts/step_ab.py --tree parent=build/step_ab/parent --tree change=.

Every tree runs in a process of its own (the packages share a name), in the
order given and then in reverse (parent / change / change / parent), and
builds its own kernels on its first turn. A turn draws gpt_small's
parameters in bf16 from seed 0 and 4 x 1024 tokens from seed 1, takes
Table-3 SlimAdam on the fused backend with its health outputs, and times:

- ``step_ms``: the plain step (``make_train_step``), forward, backward,
  update and ``apply_updates``;
- ``guarded_step_ms``: the guarded step with controls ``lr_scale`` 0.05 and
  ``grad_scale`` 0.3, which also scales gradients and updates;
- ``apply_ms``: ``apply_updates`` alone on the bf16 parameters with f32
  updates, every leaf.

The steps are timed on the host clock around each call with the device
drained before and after (the guarded step reads its verdict on the host);
``apply_ms`` by CUDA events. Each is the median of ``--reps`` calls after
``--warmup`` untimed ones. It prints the card's ``nvidia-smi`` line, a line
per turn and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(reps: int, warmup: int) -> dict:
    """One turn in this process, on the tree ``sys.path`` names."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import rules_as_tree, table3_rules
    from repro_torch.core.slim_adam import slim_adam
    from repro_torch.models import Transformer
    from repro_torch.optim.base import apply_updates
    from repro_torch.train.step import make_train_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("gpt_small"), param_dtype=torch.bfloat16)
    model = Transformer(cfg, device=dev, gen=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=torch.Generator().manual_seed(1)).to(dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    tx = slim_adam(3e-4, rules_as_tree(table3_rules(model.meta), model.params, model.meta), backend="fused",
                   emit_health=True)
    plain, guarded = make_train_step(model, tx), make_train_step(model, tx, guard=True)
    controls = {"lr_scale": 0.05, "grad_scale": 0.3}

    def host_time(fn) -> float:
        state = tx.init(model.params)
        for _ in range(warmup):
            state = fn(state)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = fn(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    step_ms = host_time(lambda s: plain(s, batch)[0])
    guarded_ms = host_time(lambda s: guarded(s, batch, controls)[0])
    gen = torch.Generator(device=dev).manual_seed(2)
    updates = {k: 1e-4 * torch.randn(p.shape, generator=gen, device=dev) for k, p in model.params.items()}
    for _ in range(warmup):
        apply_updates(model.params, updates)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        apply_updates(model.params, updates)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return {"step_ms": step_ms, "guarded_step_ms": guarded_ms, "apply_ms": statistics.median(times),
            "leaves": len(model.params), "dtypes": sorted({str(p.dtype) for p in model.params.values()})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a tree to time (repeatable; default change=.)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        sys.path.insert(0, str(Path(args.worker) / "src"))
        print(json.dumps(worker(args.reps, args.warmup)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("step_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in (args.tree or ["change=."]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    order = list(trees) + list(reversed(trees))
    runs = {name: [] for name in trees}
    for name in order:
        path = (ROOT / trees[name]).resolve()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(path), "--reps",
                              str(args.reps), "--warmup", str(args.warmup)], capture_output=True, text=True, env=env,
                             cwd=path)
        if out.returncode:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        runs[name].append(row)
        print(f"{name}: {row}", flush=True)
    print(json.dumps({"card": smi, "batch": [4, 1024], "reps": args.reps, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
