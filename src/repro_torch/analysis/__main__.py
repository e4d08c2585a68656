"""``python -m repro_torch.analysis`` — run the static contract passes as a
gate.

Prints one table row per pass and exits non-zero if any pass reports a
finding or crashes (a crashed pass is a failed pass, not a skipped one). A
card pass (``resources``, ``launch-stable``) selected where no CUDA device
is present fails with the finding "no CUDA device"; nothing falls back to
the CPU. On a golden-signature mismatch the computed matrix is written to
``--diff-out``; to accept an intentional signature change, run with
``--update-golden`` and commit the new ``golden_signatures.json``.
On a machine without a GPU, ``--only kernelcheck,races,shardcheck,tracecheck,lint``
runs the device-free passes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import CARD_PASSES, PASS_NAMES
from .report import PassResult

DIFF_OUT = Path(__file__).resolve().parents[3] / "build" / "golden_signatures.diff.json"


def _run_pass(name: str, update_golden: bool, diff_out: Path) -> PassResult:
    t0 = time.monotonic()
    try:
        if name in CARD_PASSES:
            import torch

            if not torch.cuda.is_available():
                result = PassResult(name, checks=1)
                result.add("device", name, "no CUDA device: this pass runs on the GPU machine")
                return result
        if name == "kernelcheck":
            from . import kernelcheck

            result, computed = kernelcheck.run(update_golden=update_golden)
            if any(f.check == "golden" for f in result.findings):
                diff_out.parent.mkdir(parents=True, exist_ok=True)
                diff_out.write_text(json.dumps(computed, indent=1, sort_keys=True) + "\n")
                result.detail = ((result.detail + "; ") if result.detail else "") + f"computed matrix -> {diff_out}"
            return result
        if name == "races":
            from . import races
            return races.run()
        if name == "shardcheck":
            from . import shardcheck
            return shardcheck.run()
        if name == "tracecheck":
            from . import tracecheck
            return tracecheck.run()
        if name == "lint":
            from . import lint
            return lint.run()
        if name == "resources":
            from . import kernelcheck
            return kernelcheck.run_resources()
        if name == "launch-stable":
            from . import tracecheck
            return tracecheck.run_launch_stable()
        raise ValueError(f"unknown pass {name!r}")
    except Exception as e:  # noqa: BLE001 - a crashed pass is a failed pass
        result = PassResult(name, seconds=time.monotonic() - t0)
        result.checks += 1
        result.add("crash", name, f"{type(e).__name__}: {e}")
        return result


def table(results) -> str:
    """The report: a row per pass, its detail, and every finding."""
    widths = (14, 8, 9, 8, 6)
    header = ("pass", "checks", "findings", "time", "status")
    lines = [" ".join(h.ljust(w) for h, w in zip(header, widths)), " ".join("-" * w for w in widths)]
    for r in results:
        row = (r.name, str(r.checks), str(len(r.findings)), f"{r.seconds:.1f}s", "PASS" if r.ok else "FAIL")
        lines.append(" ".join(c.ljust(w) for c, w in zip(row, widths)))
        if r.detail:
            lines.append(f"{'':14} {r.detail}")
    total = sum(len(r.findings) for r in results)
    if total:
        lines.append(f"\n{total} finding(s):")
        lines += [f"  {f}" for r in results for f in r.findings]
    else:
        lines.append(f"\nall {sum(r.checks for r in results)} checks green in {sum(r.seconds for r in results):.1f}s")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis", description=__doc__)
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of passes (default: all of {', '.join(PASS_NAMES)})")
    ap.add_argument("--update-golden", action="store_true", help="rewrite golden_signatures.json from this run")
    ap.add_argument("--diff-out", type=Path, default=DIFF_OUT,
                    help="where to write the computed signature matrix on a golden mismatch")
    args = ap.parse_args(argv)
    names = list(PASS_NAMES)
    if args.only:
        chosen = [p.strip() for p in args.only.split(",") if p.strip()]
        bad = [p for p in chosen if p not in PASS_NAMES]
        if bad:
            ap.error(f"unknown pass(es) {bad}; valid: {', '.join(PASS_NAMES)}")
        names = chosen
    results = [_run_pass(n, args.update_golden, args.diff_out) for n in names]
    print(table(results))
    return 1 if any(r.findings for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
