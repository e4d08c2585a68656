"""Deterministic fault injection for the resilience substrate (port of
``repro/train/faults.py``).

Everything here is seedless and step-indexed, so an injected run is exactly
reproducible. Injection points:

* **gradients** — :meth:`FaultPlan.grad_scale` returns NaN/Inf multipliers
  for the guarded step's ``controls['grad_scale']`` on the chosen steps
  (the step multiplies the gradients before the update, so the kernels'
  in-pass health stats see it exactly as a real non-finite gradient);
* **loss spikes** — :meth:`FaultPlan.corrupt_loss` scales the host-side
  loss the :class:`repro_torch.train.guard.Guard` observes, driving the
  backoff/rollback policy without touching device state;
* **checkpoint IO** — :func:`inject_checkpoint_io_failure` raises OSError
  from inside ``checkpoint.store.save`` on selected writes;
* **kernel failures** — :func:`inject_kernel_failure` makes the fused
  backend's kernel dispatch raise before launch, exercising the degradation
  to the plain reference math (counted by
  ``optim.fused.kernel_degraded_leaves``);
* **torn checkpoints** — :func:`tear_checkpoint` truncates a written step
  on disk the way a preemption mid-write would.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Step-indexed gradient/loss fault schedule (0-based step numbers,
    matching ``Trainer.step`` *before* the step runs)."""
    nan_grad_steps: Tuple[int, ...] = ()
    inf_grad_steps: Tuple[int, ...] = ()
    spike_steps: Tuple[int, ...] = ()
    spike_scale: float = 1e3

    def grad_scale(self, step: int) -> float:
        """Multiplier for the gradient tree at ``step`` (1.0 = clean).
        NaN/Inf multipliers poison every gradient entry, which the in-pass
        health stats then count."""
        if step in self.nan_grad_steps:
            return float("nan")
        if step in self.inf_grad_steps:
            return float("inf")
        return 1.0

    def corrupt_loss(self, step: int, loss: float) -> float:
        """Host-side loss as the guard should observe it at ``step``."""
        if step in self.spike_steps:
            return loss * self.spike_scale
        return loss

    @property
    def fault_steps(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.nan_grad_steps) | set(self.inf_grad_steps) | set(self.spike_steps)))


@contextlib.contextmanager
def inject_checkpoint_io_failure(fail_on: Tuple[int, ...] = (1,)):
    """Make ``checkpoint.store.save`` raise OSError on its nth call(s)
    within this context (1-based). Yields the counter dict so callers can
    assert how many writes were attempted."""
    from .. import injection
    from ..checkpoint import store

    hook, state = injection.call_counter(fail_on, lambda n: OSError(f"injected checkpoint IO failure (write #{n})"))
    with injection.installed(store.IO_FAULT_POINT, hook):
        yield state


@contextlib.contextmanager
def inject_kernel_failure(match: Optional[str] = None):
    """Make every fused-backend kernel dispatch (or only those whose label
    contains ``match``) raise inside this context, forcing the degradation
    to the plain reference math. Degradation counters are reset on entry;
    read ``optim.fused.kernel_degraded_leaves()`` before exit."""
    from .. import injection
    from ..optim import fused

    def hook(label):
        if match is None or match in label:
            raise RuntimeError(f"injected kernel failure at {label}")

    fused.reset_kernel_degradation()
    with injection.installed(fused.KERNEL_FAULT_POINT, hook):
        yield


def tear_checkpoint(ckpt_dir, step: Optional[int] = None) -> int:
    """Corrupt the checkpoint at ``step`` (default: newest on disk) the way
    a preemption mid-write would: truncate ``arrays.npz`` and scramble the
    manifest's checksums. Returns the torn step number."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        dirs = sorted(ckpt_dir.glob("step_*"))
        if not dirs:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = int(dirs[-1].name.split("_")[1])
    path = ckpt_dir / f"step_{step:08d}"
    npz = path / "arrays.npz"
    raw = npz.read_bytes()
    npz.write_bytes(raw[: max(len(raw) // 2, 1)])
    mpath = path / "manifest.json"
    manifest = json.loads(mpath.read_text())
    for entry in manifest.get("leaves", {}).values():
        if "crc32" in entry:
            entry["crc32"] = (entry["crc32"] + 1) % (1 << 32)
    mpath.write_text(json.dumps(manifest))
    return step
