"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, llama-arch small, tied: RoPE, RMSNorm, gated MLP. Port of
``repro/configs/smollm_135m.py`` (``config`` and ``reduced``).
[hf:HuggingFaceTB/SmolLM-135M]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm_135m", n_layers=30, d_model=576,
        n_heads=9, n_kv_heads=3, head_dim=64,
        d_ff=1536, vocab_size=49152,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm_135m_reduced", n_layers=3, d_model=48,
        n_heads=3, n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=211,
        pattern=(LayerSlot("attn", "dense"),),
        pos="rope", norm="rmsnorm", tie_embeddings=True,
        dtype=torch.float32, remat=False,
    )
