"""Optimizer substrate (port of ``repro/optim``)."""
from . import schedules
from .adam import ScaleByAdamState, adamw, scale_by_adam
from .base import (BACKENDS, GradientTransformation, add_decayed_weights, apply_updates, chain,
                   clip_by_global_norm, global_norm, resolve_backend, scale_by_learning_rate, scale_by_schedule)

__all__ = ["ScaleByAdamState", "adamw", "scale_by_adam", "BACKENDS", "GradientTransformation",
           "add_decayed_weights", "apply_updates", "chain", "clip_by_global_norm", "global_norm",
           "resolve_backend", "scale_by_learning_rate", "scale_by_schedule", "schedules"]
