"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504,
encoder-only (non-causal), GELU MLP, LayerNorm. The conv waveform frontend
is a stub: a batch carries precomputed frame embeddings
(``frontend_embeds``, (B, S, d_model)) and per-frame labels. Port of
``repro/configs/hubert_xlarge.py``. [arXiv:2106.07447]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert_xlarge", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, vocab_size=504,
        causal=False, embed_inputs=False, tie_embeddings=False,
        gated_mlp=False,
        pattern=(LayerSlot("attn", "dense"),),
        pos="none", norm="layernorm",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert_xlarge_reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=59,
        causal=False, embed_inputs=False, tie_embeddings=False,
        gated_mlp=False, pattern=(LayerSlot("attn", "dense"),),
        pos="none", norm="layernorm", dtype=torch.float32, remat=False,
    )
