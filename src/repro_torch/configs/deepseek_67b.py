"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch. Port of ``repro/configs/deepseek_67b.py``.
[arXiv:2401.02954]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_67b", n_layers=95, d_model=8192,
        n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=102400,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek_67b_reduced", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=211,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
        dtype=torch.float32, remat=False,
    )
