"""Models (port of ``repro/models``): the decoder with attention + MLP
slots and Mamba slots, and the paper's probes: the two-layer linear LM and
ResNet-18."""
from . import linear_lm, resnet
from .common import ParamModel, ParamSpec, mitchell_residual_init, normal_init, torch_default_init
from .linear_lm import LinearLM, LinearLMConfig
from .resnet import ResNet, ResNetConfig
from .transformer import LayerSlot, ModelConfig, Transformer, forward

__all__ = ["LayerSlot", "ModelConfig", "Transformer", "forward", "ParamModel", "ParamSpec",
           "mitchell_residual_init", "normal_init", "torch_default_init", "LinearLM", "LinearLMConfig",
           "ResNet", "ResNetConfig", "linear_lm", "resnet"]
