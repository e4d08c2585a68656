"""Models (port of ``repro/models``): the decoder with attention + MLP
slots and Mamba slots."""
from .transformer import LayerSlot, ModelConfig, Transformer, forward

__all__ = ["LayerSlot", "ModelConfig", "Transformer", "forward"]
