"""Run the whole dry-run matrix (port of ``repro/launch/sweep.py``): every
(arch x shape x mesh) cell in a fresh subprocess, since a process holds one
default process group and each cell's is a 256- or 512-rank fake world.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--mesh single multi] [--archs ...]

Needs no GPU. Writes one JSON a cell and ``summary.csv`` beside them, under
``build/dryrun/`` by default (``--out``): fits / does not fit / skipped, the
peak a rank, grad_accum and the roofline's dominant term, reckoned on
``meta`` for the card ``repro_torch.launch.mesh.CARD`` names.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from ..configs import ARCH_IDS, SHAPES, cell_supported
from .dryrun import RESULTS_DIR

ASSIGNED = tuple(a for a in ARCH_IDS if a not in ("gpt_small", "gpt_medium", "vit_small"))


def run_one(arch: str, shape: str, mesh: str, optimizer: str, timeout: int = 900,
            out_dir: Path = RESULTS_DIR) -> dict:
    """One cell's record: written as a skip here, else from a subprocess
    running ``repro_torch.launch.dryrun``."""
    ok, reason = cell_supported(arch, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "skipped", "reason": reason}
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(rec, indent=2))
        return rec
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", mesh,
           "--optimizer", optimizer, "--out", str(out_dir)]
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "timeout"}
    if proc.returncode != 0:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "error", "stderr": proc.stderr[-2000:]}
    out = proc.stdout
    try:
        rec = json.loads(out[out.index("{"):])
    except ValueError:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "parse_error", "stdout": out[-2000:]}
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def summary_row(rec: dict) -> dict:
    """One line of ``summary.csv``."""
    roof = rec.get("roofline", {})
    return {
        "mesh": rec["mesh"], "arch": rec["arch"], "shape": rec["shape"], "status": rec.get("status"),
        "reason": rec.get("reason", ""), "fits": rec.get("fits"), "grad_accum": rec.get("grad_accum"),
        "peak_gib": round(rec.get("peak_bytes", 0) / 2**30, 2),
        "persistent_gib": round(sum(rec.get("persistent_bytes", {}).values()) / 2**30, 2),
        "dominant": roof.get("dominant"), "compute_s": roof.get("compute_s"), "memory_s": roof.get("memory_s"),
        "collective_s": roof.get("collective_s"), "useful_ratio": rec.get("useful_flops_ratio"),
        "roofline_fraction": rec.get("roofline_fraction"), "wall_s": rec.get("wall_s"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sweep")
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"])
    ap.add_argument("--archs", nargs="+", default=list(ASSIGNED))
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--optimizer", default="slim")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    rows = []
    t0 = time.time()
    for mesh in args.mesh:
        for arch in args.archs:
            for shape in args.shapes:
                rec = run_one(arch, shape, mesh, args.optimizer, out_dir=out_dir)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    extra = (f"peak={rec['peak_bytes'] / 2**30:.1f}GiB fits={rec.get('fits')} "
                             f"dom={rec['roofline']['dominant']} accum={rec.get('grad_accum')} {rec.get('wall_s')}s")
                elif status == "error":
                    extra = rec.get("stderr", "")[-200:].replace("\n", " ")
                print(f"[{mesh}] {arch:20s} {shape:12s} {status:8s} {extra}", flush=True)
                rows.append(summary_row(rec))
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "summary.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    n_err = sum(1 for r in rows if r["status"] not in ("ok", "skipped"))
    n_fit = sum(1 for r in rows if r["status"] == "ok" and r["fits"])
    n_ok = sum(1 for r in rows if r["status"] == "ok")
    print(f"\n{len(rows)} cells, {n_ok} run ({n_fit} fit the card), {n_err} failures, {time.time() - t0:.0f} s "
          f"-> {out_dir}/summary.csv")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
