"""Model registry — functional analog of the reference's multiple dispatch.

EnergyBalanceModel.jl registers physics steppers as methods of
``Infrastructure.step!`` (``src/miz.jl:150``). Here each model is a
:class:`ModelSpec` of plain functions on tensors that ``integrate``
composes into a year loop:

- ``statics(st, par, dtype, device)`` — per-run precompute (insolation
  factors, stencil bands, scalar combinations).
- ``init_carry(init, st, dtype, device)`` — the step carry from user initial
  conditions.
- ``step(carry, xs, statics, par, cfg)`` — one physics step:
  ``(carry, xs) -> (carry, outputs)``.
- ``step_inputs(statics, fyear, t)`` — the inputs of step ``t`` of a year.
- ``solution_vars`` — variables recorded in Solutions storage (reference
  ``solvars``, ``src/infrastructure.jl:621-624``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

__all__ = [
    "ModelSpec", "StepConfig", "default_step_config", "dtype_name",
    "register_model", "get_model", "available_models",
]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Numerics knobs for a run."""

    solver: str = "pcr"  # tridiagonal solver: 'pcr' | 'thomas'
    newton_max_iter: int = 30
    newton_abstol: float = 1e-8  # reference reltol/abstol (src/miz.jl:58-59)
    newton_reltol: float = 1e-6
    newton_max_step: float = None  # trust-region-style step cap (float32 safeguard)
    spatial_axis: str = None  # mesh axis name when the grid axis is sharded
    # the member axis of a 2-D (members x grid) mesh, or of a member-sharded
    # eager year: the Newton loop CONDITION is OR-reduced over it, so every
    # shard runs the unsharded batch's trip count (per-member norms and
    # tolerances untouched) and the shards' collectives stay in step
    batch_axis: str = None
    # which array axis holds the grid (JAX models/base.py:54; the port's
    # steps keep it last)
    grid_axis: int = -1


def default_step_config(dtype_name: str, solver: str = "pcr",
                        **overrides) -> StepConfig:
    """The per-dtype Newton tolerances every entry point shares (the JAX
    package's values, ``models/base.py:65-70``).

    float64 (the parity config): tighter than the reference's (1e-8, 1e-6) —
    the trajectory is sensitive at the ice edge, so the root is driven near
    the fp floor to keep solver noise out of the dynamics.
    float32: residuals are O(100) W/m^2, so 0.5 absolute is ~eps-limited;
    the step cap guards low-precision iterates (f64 converges unclipped).
    """
    if dtype_name == "float64":
        tol = dict(newton_abstol=1e-11, newton_reltol=1e-9)
    else:
        tol = dict(newton_abstol=0.5, newton_reltol=1e-4, newton_max_step=50.0)
    tol.update(overrides)
    return StepConfig(solver=solver, **tol)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``'float32'`` (the key of
    :func:`default_step_config`)."""
    return str(dtype).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    statics: Callable
    init_carry: Callable
    step: Callable
    step_inputs: Callable
    solution_vars: Tuple[str, ...]
    init_vars: Tuple[str, ...]
    # variables whose stored values are NaN-masked for PRESENTATION in
    # healthy runs (ice-free/ice-covered cells, src/miz.jl:193-194);
    # NaN in any OTHER variable means the run diverged
    presentation_nan_vars: Tuple[str, ...] = ()


_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_model(name: str) -> ModelSpec:
    """Resolve a model by name (``'MIZ'``; ``'miz'`` is accepted too)."""
    key = {"classic": "Classic", "miz": "MIZ"}.get(name, name)
    if key not in _REGISTRY:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_models():
    """The registered model names, sorted (JAX ``models/base.py::available_models``)."""
    return sorted(_REGISTRY)
