"""Training CLI, the port's counterpart of ``examples/train_gpt.py``.

    PYTHONPATH=src python -m repro_torch.train --preset full --optimizer slim --backend fused --steps 4
    PYTHONPATH=src python -m repro_torch.train --preset cpu --device cpu --steps 20 --ckpt /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.train --optimizer adafactor --device cpu

Runs on the GPU unless ``--device`` names another device. ``--optimizer``
takes every name of ``OPTIMIZERS`` (the paper's baselines included;
'slim_snr' needs derived rules, so here it raises); ``adam`` measures SNR
and prints the SlimAdam rules it would derive. With
``--ckpt`` the run checkpoints a quarter of the way through, and a rerun
with the same directory and a higher ``--steps`` resumes from the newest
valid checkpoint.
"""
from __future__ import annotations

import argparse

from ..configs import get_config, get_reduced
from ..core import second_moment_savings
from ..data import DataConfig, ZipfLM
from .trainer import OPTIMIZERS, Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train")
    ap.add_argument("--preset", choices=("cpu", "full"), default="cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--optimizer", default="adam", choices=OPTIMIZERS,
                    help="adam (measures SNR) | slim (Table-3 rules) | a baseline (adalayer, adafactor, lion, ...)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--backend", default="jnp", choices=("jnp", "fused", "auto"),
                    help="optimizer execution backend (Adam/SlimAdam family)")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (resumes from it when it holds one)")
    ap.add_argument("--device", default=None, help="default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)

    if args.preset == "full":
        cfg = get_config("gpt_small")          # 124M, paper App. B.1
        seq, batch = 1024, 32
    else:
        cfg = get_reduced("gpt_small")
        seq, batch = 64, 8

    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))
    tc = TrainerConfig(total_steps=args.steps, log_every=max(args.steps // 10, 1),
                       ckpt_every=max(args.steps // 4, 1) if args.ckpt else 0, ckpt_dir=args.ckpt,
                       measure_snr=(args.optimizer == "adam"), snr_early_every=20, backend=args.backend)
    tr = Trainer(cfg, args.optimizer, args.lr, data, tc, device=args.device)
    if tr.step:
        print(f"resumed from checkpoint at step {tr.step}")
    final = tr.run()
    print("final:", final)

    if args.optimizer == "adam" and tr.snr.count:
        rules = tr.derive_slim_rules(cutoff=1.0)
        s = second_moment_savings(tr.params, tr.meta, rules)
        print(f"SNR-derived SlimAdam rules would save {s['saved_fraction']:.1%} of second moments:")
        for name, rule in sorted(rules.items()):
            if rule:
                print(f"  compress {name:50s} along {rule}")


if __name__ == "__main__":
    main()
