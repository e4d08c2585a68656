"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias. Port of ``repro/configs/qwen15_32b.py``
(``config``, ``reduced`` and ``optimized``). [hf:Qwen/Qwen1.5-32B]"""
import dataclasses

import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen15_32b", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27392, vocab_size=152064,
        qkv_bias=True,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen15_32b_reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=211,
        qkv_bias=True, pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
        dtype=torch.float32, remat=False,
    )


def optimized() -> ModelConfig:
    """The serving variant with an int8 KV cache: it halves the cache's bytes
    against bf16. The paged path keeps bf16 pages, so this configuration
    serves through the legacy decode loop."""
    return dataclasses.replace(config(), kv_quant=True)
