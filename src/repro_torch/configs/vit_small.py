"""ViT-small (paper App. B.4): 12L 12H d_model=768, a GPT-like trunk for
image classification over patches of 2 on CIFAR (patch dim 2*2*3 = 12),
learned positions, non-causal. Port of ``repro/configs/vit_small.py``."""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="vit_small", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=100,
        causal=False, embed_inputs=False, tie_embeddings=False,
        input_proj_dim=12, gated_mlp=False,
        pattern=(LayerSlot("attn", "dense"),),
        pos="learned", max_position=257, norm="layernorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="vit_small_reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=10,
        causal=False, embed_inputs=False, tie_embeddings=False,
        input_proj_dim=12, gated_mlp=False,
        pattern=(LayerSlot("attn", "dense"),),
        pos="learned", max_position=257, norm="layernorm",
        dtype=torch.float32, remat=False,
    )
