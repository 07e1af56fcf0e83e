"""Numeric helpers (port of the JAX package's ``utils/numerics.py``, a
rebuild of EnergyBalanceModel.jl ``src/utilities.jl:389-403``). Each takes
torch tensors, and returns numpy for numpy input."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["crossmean", "hemispheric_mean"]


def crossmean(stack):
    """Mean across the leading (time) axis of a stacked solution array;
    NaNs propagate (reference ``crossmean``, ``utilities.jl:390-395``)."""
    if torch.is_tensor(stack):
        return torch.mean(stack, dim=0)
    return np.mean(np.asarray(stack), axis=0)


def hemispheric_mean(vec, x):
    """Trapezoid integral of ``vec`` over the grid ``x``, over the last
    axis: ``sum_i (v_i + v_{i+1}) (x_{i+1} - x_i) / 2`` (reference
    ``utilities.jl:397-403``). A tensor ``vec`` keeps its dtype and device
    (``x`` is cast to them)."""
    if torch.is_tensor(vec):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                            dtype=vec.dtype, device=vec.device)
        return torch.sum((vec[..., :-1] + vec[..., 1:]) * (x[1:] - x[:-1]) / 2.0, dim=-1)
    vec, x = np.asarray(vec), np.asarray(x)
    return np.sum((vec[..., :-1] + vec[..., 1:]) * (x[1:] - x[:-1]) / 2.0, axis=-1)
