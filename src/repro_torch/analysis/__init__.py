"""The port's static contracts (the counterpart of ``repro/analysis``),
re-derived for its CUDA kernels on an H100.

Device-free passes (``meta`` tensors, plans, ASTs and the CUDA sources; no
kernel runs):

  * :mod:`.kernelcheck` — every registered wrapper's output signature on
    ``meta`` against ``golden_signatures.json`` (JAX's 119 keys), the
    variants' extra outputs O(kept), and the f32-compute contract on the
    ``.cu`` sources (bf16 read into float, stored from float).
  * :mod:`.races` — every output element of a call written by exactly one
    block of one launch, walked from the planners' grids.
  * :mod:`.shardcheck` — ``ShardLeafPlan`` geometry over the config zoo x
    mesh matrix on a ``SpecMesh``.
  * :mod:`.tracecheck` — the guarded step applies its controls as the JAX
    step does, and the guard's controls keep their keys and types.
  * :mod:`.lint` — RPR001-RPR004 over ``src/repro_torch``.

Card passes (they need the GPU machine and fail where it is absent):

  * ``resources`` — each compiled kernel's registers, spills and shared
    memory from the ptxas report, against ``kernelcheck.RESOURCES``.
  * ``launch-stable`` — the guarded step launches the same kernels with
    controls of 1.0 and 0.5.

Entry point: ``python -m repro_torch.analysis`` (see ``__main__``).
:mod:`.call_tools` holds the dry-run counters (``count_kernel_calls``,
``entry_signature``) and :mod:`.registry` the kernel table.
"""
from __future__ import annotations

from .report import Finding, PassResult  # noqa: F401

DEVICE_FREE = ("kernelcheck", "races", "shardcheck", "tracecheck", "lint")
CARD_PASSES = ("resources", "launch-stable")
PASS_NAMES = DEVICE_FREE + CARD_PASSES
