"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free Mamba-1,
vocab=65024, ssm_state=16. Port of ``repro/configs/falcon_mamba_7b.py``
(``config`` and ``reduced``; ``ssm_chunk`` sizes the JAX chunked scan,
which the port's scan kernels do not need). [arXiv:2410.05355]"""
import torch

from repro_torch.models import LayerSlot, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon_mamba_7b", n_layers=64, d_model=4096,
        n_heads=1, n_kv_heads=1,  # attention-free
        d_ff=0, vocab_size=65024,
        pattern=(LayerSlot("mamba", None),),
        pos="none", norm="rmsnorm", tie_embeddings=True,
        ssm_state=16, ssm_expand=2, ssm_conv=4, ssm_chunk=512,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon_mamba_7b_reduced", n_layers=4, d_model=64,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=211,
        pattern=(LayerSlot("mamba", None),),
        pos="none", norm="rmsnorm", tie_embeddings=True,
        ssm_state=4, ssm_expand=2, ssm_conv=4, ssm_chunk=8,
        dtype=torch.float32, remat=False,
    )
