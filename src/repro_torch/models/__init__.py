"""Models (port of ``repro/models``): the dense attention + MLP decoder."""
from .transformer import LayerSlot, ModelConfig, Transformer, forward

__all__ = ["LayerSlot", "ModelConfig", "Transformer", "forward"]
