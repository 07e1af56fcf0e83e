"""Ensembles on one device (:mod:`.ensemble`). Multi-device data and grid
parallelism is not ported yet (ROADMAP Queue 1 M14)."""
from .ensemble import EnsembleSolutions, batched_parameters, ensemble_integrate, sweep

__all__ = ["EnsembleSolutions", "ensemble_integrate", "sweep", "batched_parameters"]
