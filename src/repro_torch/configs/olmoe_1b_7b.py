"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, MoE 64e top-8. Port of ``repro/configs/olmoe_1b_7b.py``.
[arXiv:2409.02060]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe_1b_7b", n_layers=16, d_model=2048,
        n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        n_experts=64, top_k=8,
        pattern=(LayerSlot("attn", "moe"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe_1b_7b_reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=48, vocab_size=211,
        n_experts=8, top_k=2, pattern=(LayerSlot("attn", "moe"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
        dtype=torch.float32, remat=False,
    )
