"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, llama-arch small, tied: RoPE, RMSNorm, gated MLP. Port of
``repro/configs/smollm_135m.py`` (``config``, ``reduced`` and ``optimized``).
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


def optimized() -> ModelConfig:
    """A 135M model cannot use a 16-way tensor-parallel axis (9 heads do
    not divide it; attention would replicate 16x), so the 'model' axis
    becomes extra data parallelism: pure 256-way data parallelism, as the
    JAX package's ``optimized()`` lays it out."""
    import dataclasses
    return dataclasses.replace(config(), sharding_overrides=(
        ("batch", ("pod", "data", "model")), ("vocab", None), ("mlp", None),
        ("heads", None), ("kv_heads", None), ("act_mlp", None),
        ("act_heads", None), ("seq_sp", None), ("embed", None), ("d_inner", None),
    ))
