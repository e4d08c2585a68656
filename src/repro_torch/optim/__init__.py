"""Optimizer substrate (port of ``repro/optim``)."""
from . import schedules
from .adam import ScaleByAdamState, adamw, scale_by_adam, sgdm
from .base import (BACKENDS, GradientTransformation, MultiStepsState, ScaleState, TraceState, add_decayed_weights,
                   apply_updates, chain, clip_by_global_norm, global_norm, identity, multi_steps, resolve_backend,
                   scale, scale_by_learning_rate, scale_by_schedule, trace)

__all__ = ["ScaleByAdamState", "adamw", "scale_by_adam", "sgdm", "BACKENDS", "GradientTransformation",
           "MultiStepsState", "ScaleState", "TraceState", "add_decayed_weights", "apply_updates", "chain",
           "clip_by_global_norm", "global_norm", "identity", "multi_steps", "resolve_backend", "scale",
           "scale_by_learning_rate", "scale_by_schedule", "schedules", "trace"]
