"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, LayerNorm (no bias), tied embeddings. Port of
``repro/configs/command_r_35b.py``. [hf:CohereForAI/c4ai-command-r-v01]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command_r_35b", n_layers=40, d_model=8192,
        n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22528, vocab_size=256000,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="layernorm", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command_r_35b_reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=211,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="layernorm", tie_embeddings=True,
        dtype=torch.float32, remat=False,
    )
