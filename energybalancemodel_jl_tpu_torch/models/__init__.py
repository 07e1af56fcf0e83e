"""Physics steppers, registered by name (reference dispatch on ``Val{model}``).

Only the MIZ model is ported so far; Classic follows (ROADMAP Queue 1 M3, M7).
"""
from . import miz  # noqa: F401 — importing registers the model
from .base import ModelSpec, StepConfig, get_model

__all__ = ["ModelSpec", "StepConfig", "get_model", "miz"]
