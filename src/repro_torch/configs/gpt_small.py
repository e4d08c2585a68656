"""GPT-small (paper App. B.1): 12L 12H d_model=768, MLP x4, learned
positions, weight tying, no biases, LayerNorm, GELU. Port of
``repro/configs/gpt_small.py``."""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gpt_small", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=50304,
        gated_mlp=False, pattern=(LayerSlot("attn", "dense"),),
        pos="learned", max_position=1024, norm="layernorm",
        tie_embeddings=True, init_scheme="mitchell",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gpt_small_reduced", n_layers=3, d_model=96,
        n_heads=3, n_kv_heads=3, d_ff=384, vocab_size=211,
        gated_mlp=False, pattern=(LayerSlot("attn", "dense"),),
        pos="learned", max_position=256, norm="layernorm",
        tie_embeddings=True, init_scheme="mitchell",
        dtype=torch.float32, remat=False,
    )
