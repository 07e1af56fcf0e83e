"""Physics steppers, registered by name (reference dispatch on ``Val{model}``):
the MIZ model (:mod:`.miz`) and the WE15 Classic model (:mod:`.classic`)."""
from . import classic, miz  # noqa: F401 — importing registers the models
from .base import ModelSpec, StepConfig, available_models, get_model

__all__ = ["ModelSpec", "StepConfig", "get_model", "available_models", "classic", "miz"]
