"""internvl2-26b [vlm]: InternLM2-20B language backbone, 48L d_model=6144
48H (GQA kv=8) d_ff=16384 vocab=92553. The InternViT vision tower is a
stub: a batch carries 256 precomputed patch embeddings
(``frontend_embeds``) that the model prepends to the text sequence. Port of
``repro/configs/internvl2_26b.py``. [arXiv:2404.16821]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2_26b", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92553,
        extra_embed_len=256,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2_26b_reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=211,
        extra_embed_len=4, pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=False,
        dtype=torch.float32, remat=False,
    )
