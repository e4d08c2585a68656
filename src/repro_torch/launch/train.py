"""Distributed training driver (port of ``repro/launch/train.py``, same
flags): a mesh, the sharded train loop and checkpointing.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt_small --steps 100 --mesh none
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train --arch gpt_small --mesh single

``--arch`` takes any of the 13 architectures that read tokens alone (the
encoders and the VLM take other inputs and raise). ``--mesh none`` trains
one process on the reduced config; ``single`` and
``multi`` build the production meshes, (data=16, model=16) and (pod=2,
data=16, model=16), with one process per rank: rank, world size and local
rank come from the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for the rendezvous).
Every rank runs the same ``Trainer`` under the mesh's sharding context;
rank 0 prints and writes the checkpoints. Runs on the GPU; ``--device cpu``
(or ``main(argv, device="cpu")``) runs on the CPU (over gloo on a mesh):

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon_mamba_7b --reduced --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import time

from ..configs import ARCH_IDS, get_config, get_reduced
from ..data import DataConfig, ZipfLM
from ..sharding import ShardingContext, use_sharding
from ..train.guard import GuardConfig
from ..train.trainer import OPTIMIZERS, Trainer, TrainerConfig


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm_135m")
    ap.add_argument("--reduced", action="store_true", help="CPU-scale config")
    ap.add_argument("--mesh", choices=("none", "single", "multi"), default="none")
    ap.add_argument("--optimizer", default="slim", choices=OPTIMIZERS)
    ap.add_argument("--backend", choices=("jnp", "fused", "auto"), default="auto",
                    help="Adam/SlimAdam execution path; 'fused' + a mesh runs the kernels on each rank's shards")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--guard", action="store_true",
                    help="fault-tolerant step: in-pass anomaly health, skip poisoned steps, lr backoff on loss "
                         "spikes, rollback to the last checkpoint on repeated faults")
    ap.add_argument("--device", default=None, help="default: the GPU (raises when there is none)")
    args = ap.parse_args(argv)
    device = args.device or device

    cfg = get_reduced(args.arch) if args.reduced or args.mesh == "none" else get_config(args.arch)
    if not cfg.embed_inputs or cfg.extra_embed_len:
        raise ValueError(f"arch {args.arch!r} takes frame embeddings, patches or frontend embeddings; this launcher "
                         "feeds ZipfLM tokens only (train it through train.step.make_train_step)")
    mesh = None
    if args.mesh != "none":
        from .mesh import make_production_mesh

        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), device=device)
    ctx = ShardingContext(mesh) if mesh is not None else None
    lead = mesh is None or mesh.rank == 0

    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    tc = TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                       ckpt_every=max(args.steps // 4, 1) if args.ckpt else 0, ckpt_dir=args.ckpt,
                       backend=args.backend, guard=GuardConfig() if args.guard else None)
    with use_sharding(ctx):
        tr = Trainer(cfg, args.optimizer, args.lr, data, tc, grad_accum=args.grad_accum, device=device)
        start = tr.step
        if start and lead:
            print(f"resumed from step {start}")
        t0 = time.time()
        tr.run()
    if lead:
        for m in tr.metrics_log:
            extra = ""
            if tr.guard is not None:
                extra = (f" skipped {int(m['guard_skipped'])} backoffs {int(m['guard_backoffs'])} rollbacks "
                         f"{int(m['guard_rollbacks'])} lr_scale {m['guard_lr_scale']:.2f}")
            print(f"step {int(m['step'])}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.3f}" + extra)
        print(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s")
        if tr.guard is not None:
            print("guard counters:", tr.guard.counters)


if __name__ == "__main__":
    main()
