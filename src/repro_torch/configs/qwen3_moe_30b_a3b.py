"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4, head_dim=128)
expert d_ff=768, vocab=151936, MoE 128e top-8. Port of
``repro/configs/qwen3_moe_30b_a3b.py``. [hf:Qwen/Qwen3-30B-A3B]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_moe_30b_a3b", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab_size=151936,
        n_experts=128, top_k=8,
        pattern=(LayerSlot("attn", "moe"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3_moe_30b_a3b_reduced", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=48, vocab_size=211,
        n_experts=8, top_k=2, pattern=(LayerSlot("attn", "moe"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
        dtype=torch.float32, remat=False,
    )
