"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave (attn at in-period
index 4), MoE FFN on odd layers. No positional encoding (Mamba provides
position). Port of ``repro/configs/jamba_v01_52b.py``; ``ssm_chunk`` sizes
the JAX chunked scan, which the port's scan kernels do not need.
[arXiv:2403.19887]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig

_PATTERN = tuple(
    LayerSlot("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba_v01_52b", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536,
        n_experts=16, top_k=2,
        pattern=_PATTERN,
        pos="none", norm="rmsnorm", tie_embeddings=False,
        ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_chunk=512,
    )


def reduced() -> ModelConfig:
    pat = tuple(
        LayerSlot("attn" if i == 1 else "mamba", "moe" if i % 2 == 1 else "dense")
        for i in range(4)
    )
    return ModelConfig(
        name="jamba_v01_52b_reduced", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=211,
        n_experts=4, top_k=2, pattern=pat,
        pos="none", norm="rmsnorm", tie_embeddings=False,
        ssm_state=4, ssm_chunk=8, dtype=torch.float32, remat=False,
    )
