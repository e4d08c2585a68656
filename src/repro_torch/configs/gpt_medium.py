"""GPT-medium (paper App. B.1): 24L 16H d_model=1024, MLP x4, learned
positions, weight tying, LayerNorm. Port of ``repro/configs/gpt_medium.py``."""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gpt_medium", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=50304,
        gated_mlp=False, pattern=(LayerSlot("attn", "dense"),),
        pos="learned", max_position=1024, norm="layernorm",
        tie_embeddings=True, init_scheme="mitchell",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gpt_medium_reduced", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=211,
        gated_mlp=False, pattern=(LayerSlot("attn", "dense"),),
        pos="learned", max_position=256, norm="layernorm",
        tie_embeddings=True, init_scheme="mitchell",
        dtype=torch.float32, remat=False,
    )
