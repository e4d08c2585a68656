"""Architecture registry (port of ``repro/configs``). Each ``<arch>.py``
exposes ``config()`` (full size) and ``reduced()`` (CPU-test size, same
family). Only the architectures listed in ``ARCH_IDS`` are ported so far."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ("gpt_small", "gpt_medium", "smollm_135m", "falcon_mamba_7b", "olmoe_1b_7b", "qwen3_moe_30b_a3b",
            "jamba_v01_52b")


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"architecture {arch!r} is not ported; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str, **overrides):
    cfg = _module(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(arch: str):
    return _module(arch).reduced()
