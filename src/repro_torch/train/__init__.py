"""Training loop (port of ``repro/train``)."""
from .faults import FaultPlan, inject_checkpoint_io_failure, inject_kernel_failure, tear_checkpoint
from .guard import Guard, GuardConfig, find_step_health, strip_step_health
from .step import make_eval_step, make_serve_step, make_train_step
from .trainer import OPTIMIZERS, Trainer, TrainerConfig, find_adam_nu, make_optimizer

__all__ = ["make_eval_step", "make_serve_step", "make_train_step", "OPTIMIZERS", "Trainer", "TrainerConfig",
           "find_adam_nu", "make_optimizer", "Guard", "GuardConfig", "find_step_health", "strip_step_health",
           "FaultPlan", "inject_checkpoint_io_failure", "inject_kernel_failure", "tear_checkpoint"]
