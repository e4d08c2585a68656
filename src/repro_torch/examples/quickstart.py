"""Quickstart: swap Adam for SlimAdam on any model in three lines. The
port's twin of ``examples/quickstart.py``: reduced smollm_135m, Table-3
rules, 20 SlimAdam steps on ZipfLM batches of 8 x 32; it prints the same
lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--backend jnp|fused|auto] [--device cpu]

Runs on the GPU unless ``--device`` names another device; ``--backend
fused`` runs the optimizer through the hand-written kernels there. The
weights are the port's own draw from seed 0 unless :func:`run` is given
``params`` (the JAX script's, carried across by ``repro_torch.convert``).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..configs import get_reduced
from ..core import rules_as_tree, second_moment_savings, table3_rules
from ..core.slim_adam import slim_adam
from ..data import DataConfig, ZipfLM
from ..models import Transformer
from ..train.step import make_train_step


def run(backend: str = "jnp", device=None, params: Optional[Dict[str, torch.Tensor]] = None,
        steps: int = 20) -> dict:
    """The quickstart, printing its lines; returns the parameter count, the
    savings and each step's loss and grad norm."""
    device = resolve_device(device)
    cfg = get_reduced("smollm_135m")
    model = Transformer(cfg, device=device, gen=torch.Generator().manual_seed(0))
    if params is not None:
        model.load_params(params)
    meta = model.meta

    # --- the three lines: derive rules, build the optimizer, done -------
    rules = table3_rules(meta)                          # paper Table 3 defaults
    dims = rules_as_tree(rules, model.params, meta)
    tx = slim_adam(3e-4, dims, backend=backend)         # drop-in AdamW recipe
    # ---------------------------------------------------------------------

    s = second_moment_savings(model.params, meta, rules)
    n_params = sum(p.numel() for p in model.params.values())
    print(f"model: {cfg.name} ({n_params:,} params)")
    print(f"second moments stored: {s['stored_second_moments']:,.0f} "
          f"of {s['total_second_moments']:,.0f} ({s['saved_fraction']:.1%} saved)")

    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8))
    step = make_train_step(model, tx)
    opt = tx.init(model.params)
    losses, grad_norms = [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}
        opt, metrics = step(opt, batch)
        losses.append(metrics["loss"])
        grad_norms.append(metrics["grad_norm"])
    losses, grad_norms = [float(x) for x in losses], [float(x) for x in grad_norms]
    print(f"{steps} SlimAdam steps: loss {losses[-1]:.3f} grad_norm {grad_norms[-1]:.3f}")
    return dict(params=n_params, savings=s, losses=losses, grad_norms=grad_norms)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--backend", default="jnp", choices=("jnp", "fused", "auto"),
                    help="optimizer execution backend (fused = the hand-written kernels on the GPU)")
    ap.add_argument("--device", default=None, help="default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    return run(args.backend, args.device)


if __name__ == "__main__":
    main()
