"""PyTorch port of ``repro`` (SlimAdam, layer-wise SNR, the GPT trainer, the
paged serving engine) for one NVIDIA H100.

The package mirrors ``repro``'s layout and names so each module's
counterpart is easy to find; it imports ``torch`` and numpy and nothing of
JAX or of ``repro``. The optimizer, SNR and paged-attention kernels that
``repro`` writes in Pallas for the TPU are hand-written CUDA here
(``repro_torch.kernels``), each beside a plain PyTorch twin that runs for
CPU tensors.

Entry points (``Trainer``, ``serve.Engine``, the CLIs) run on CUDA unless the caller passes
``device="cpu"``; without a GPU they raise rather than fall back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the named one, else CUDA. Raises
    when none is named and no GPU is present — a CPU run must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch runs on a CUDA GPU unless told otherwise, and no GPU is "
                               "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
