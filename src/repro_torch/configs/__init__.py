"""Architecture registry (port of ``repro/configs``): the assignment's 10
architectures and the paper's own models. Each ``<arch>.py`` exposes
``config()`` (full size) and ``reduced()`` (CPU-test size, same family).
``input_specs(cfg, shape)`` gives the batch of one shape cell as tensors on
the ``meta`` device: shapes and dtypes, nothing allocated;
``decode_input_specs(cfg, shape)`` does the same for a decode cell's step."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

ARCH_IDS = (
    "falcon_mamba_7b",
    "jamba_v01_52b",
    "qwen3_moe_30b_a3b",
    "olmoe_1b_7b",
    "command_r_35b",
    "deepseek_67b",
    "smollm_135m",
    "qwen15_32b",
    "hubert_xlarge",
    "internvl2_26b",
    # the paper's own models
    "gpt_small",
    "gpt_medium",
    "vit_small",
)

# Shape cells of the assignment: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Families for the skip rules
SSM_OR_HYBRID = {"falcon_mamba_7b", "jamba_v01_52b"}
ENCODER_ONLY = {"hubert_xlarge", "vit_small"}


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable, reason if skipped) by the assignment's skip rules."""
    kind = SHAPES[shape][2]
    if arch in ENCODER_ONLY and kind == "decode":
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and arch not in SSM_OR_HYBRID:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str, **overrides):
    cfg = _module(arch).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_reduced(arch: str):
    return _module(arch).reduced()


def get_optimized(arch: str, *, reduced: bool = False):
    """The architecture's ``optimized()`` variant; with ``reduced``, the
    fields it changes against ``config()`` applied to ``reduced()``. Raises
    ValueError where the architecture has none, as JAX's dry-run does."""
    mod = _module(arch)
    if not hasattr(mod, "optimized"):
        raise ValueError(f"{arch} has no optimized() variant")
    opt = mod.optimized()
    if not reduced:
        return opt
    full = mod.config()
    changed = {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)
               if getattr(opt, f.name) != getattr(full, f.name)}
    return dataclasses.replace(mod.reduced(), **changed)


def input_specs(cfg, shape: str) -> Dict[str, torch.Tensor]:
    """The train or prefill batch of one cell as ``meta`` tensors, by the
    model's input kind: tokens (with the VLM's prepended frontend
    embeddings), patches through ``input_proj``, or raw frame embeddings."""
    seq, gb, kind = SHAPES[shape]
    if kind == "decode":
        raise ValueError("decode cells take a decode step's inputs, not a batch")

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    batch: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        batch["tokens"] = spec((gb, seq), torch.int32)
        batch["labels"] = spec((gb, seq), torch.int32)
        if cfg.extra_embed_len:
            batch["frontend_embeds"] = spec((gb, cfg.extra_embed_len, cfg.d_model), torch.bfloat16)
    elif cfg.input_proj_dim:
        batch["patches"] = spec((gb, seq, cfg.input_proj_dim), torch.bfloat16)
        batch["labels"] = spec((gb, seq), torch.int32)
    else:
        batch["frontend_embeds"] = spec((gb, seq, cfg.d_model), torch.bfloat16)
        batch["labels"] = spec((gb, seq), torch.int32)
    return batch


def decode_input_specs(cfg, shape: str) -> Dict[str, Any]:
    """One decode step of a decode cell on the ``meta`` device: the new
    tokens ``(batch, 1)`` int32 and a ``seq_len``-position decode cache
    (:func:`repro_torch.models.transformer.abstract_decode_cache`)."""
    seq, gb, kind = SHAPES[shape]
    assert kind == "decode"
    from ..models.transformer import abstract_decode_cache

    return {"tokens": torch.empty((gb, 1), dtype=torch.int32, device="meta"),
            "cache": abstract_decode_cache(cfg, gb, seq)}
