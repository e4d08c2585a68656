"""Training loop (port of ``repro/train``)."""
from .step import make_train_step
from .trainer import OPTIMIZERS, Trainer, TrainerConfig, make_optimizer

__all__ = ["make_train_step", "OPTIMIZERS", "Trainer", "TrainerConfig", "make_optimizer"]
