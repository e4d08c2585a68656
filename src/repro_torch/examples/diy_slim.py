"""Paper §5 "DIY: Build Your Own Low-Memory Adam": run a short Adam probe
on *your* model, inspect the per-layer SNR table, derive rules, and train
with them; the full workflow on a hybrid MoE model (reduced jamba_v01_52b:
Mamba and attention mixers, dense and MoE FFNs). The port's twin of
``examples/diy_slim.py``; it prints the same table and lines.

    PYTHONPATH=src python -m repro_torch.examples.diy_slim [--backend jnp|fused|auto] [--device cpu]

Runs on the GPU unless ``--device`` names another device; ``--backend
fused`` runs the optimizer and the SNR pass through the hand-written
kernels there. The weights are the port's own draw from seed 0 unless
:func:`run` is given ``params`` (the JAX trainer's, carried across by
``repro_torch.convert``); both trainers start from the same weights.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..configs import get_reduced
from ..core import second_moment_savings
from ..data import DataConfig, ZipfLM
from ..train import Trainer, TrainerConfig


def run(backend: str = "jnp", device=None, *, probe_steps: int = 60, slim_steps: int = 60, snr_every: int = 10,
        log_every: int = 20, params: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """The workflow, printing as the JAX script does; returns the averaged
    SNR table, the derived rules, their savings and both trainers."""
    device = resolve_device(device)
    cfg = get_reduced("jamba_v01_52b")   # mamba + attention + MoE in one model
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))

    # 1) probe: short Adam run with SNR measurement
    tc = TrainerConfig(total_steps=probe_steps, log_every=log_every, measure_snr=True,
                       snr_early_every=snr_every, backend=backend)
    probe = Trainer(cfg, "adam", 3e-3, data, tc, device=device)
    if params is not None:
        probe.model.load_params(params)
    probe.run()

    print("time-averaged SNR per candidate dimension (>1 = compressible):")
    snr = probe.snr.averaged()
    for name, ks in sorted(snr.items()):
        if ks:
            best = max(ks, key=ks.get)
            print(f"  {name:55s} " + " ".join(f"{k}={v:6.2f}" for k, v in ks.items())
                  + f"   -> K*={best}")

    # 2) derive rules at the probe LR, report savings
    rules = probe.derive_slim_rules(cutoff=1.0)
    s = second_moment_savings(probe.params, probe.meta, rules)
    print(f"\nderived rules compress {sum(1 for r in rules.values() if r)}"
          f"/{len(rules)} tensors -> {s['saved_fraction']:.1%} second moments saved")

    # 3) train with the derived rules (SlimAdam)
    slim = Trainer(cfg, "slim_snr", 3e-3, data,
                   TrainerConfig(total_steps=slim_steps, log_every=log_every, backend=backend), rules=rules,
                   device=device)
    if params is not None:
        slim.model.load_params(params)
    final = slim.run()
    print(f"SlimAdam(SNR rules) final loss: {final['loss']:.3f}")
    return dict(snr=snr, rules=rules, savings=s, final=final, probe=probe, slim=slim)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.diy_slim")
    ap.add_argument("--backend", default="jnp", choices=("jnp", "fused", "auto"),
                    help="optimizer execution backend (fused = the hand-written kernels on the GPU)")
    ap.add_argument("--device", default=None, help="default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    run(args.backend, args.device)


if __name__ == "__main__":
    main()
