"""Numeric helpers (port of the JAX package's ``utils/numerics.py``, a
rebuild of EnergyBalanceModel.jl ``src/utilities.jl:389-403``). Each takes
torch tensors, and returns numpy for numpy input."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["crossmean", "hemispheric_mean", "condset", "zeroref", "nan_to_zero",
           "np_hemispheric_mean", "flush_subnormal"]


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


def condset(to, value, mask):
    """Pure analog of ``condset!`` (reference ``utilities.jl:406-412``):
    ``to`` with ``value`` where ``mask`` is true."""
    if torch.is_tensor(to):
        return torch.where(torch.as_tensor(mask, device=to.device),
                           torch.as_tensor(value, dtype=to.dtype, device=to.device), to)
    return np.where(mask, value, to)


def zeroref(v, ref):
    """Pure analog of ``zeroref!`` (reference ``utilities.jl:415``): ``v``
    zeroed where ``ref == 0``."""
    if torch.is_tensor(v):
        return torch.where(torch.as_tensor(ref, device=v.device) == 0, torch.zeros_like(v), v)
    return np.where(np.asarray(ref) == 0, np.zeros_like(v), v)


def nan_to_zero(v):
    """``condset!(v, 0.0, isnan)``, the MIZ step's water-temperature clean-up
    (reference ``src/miz.jl:157``)."""
    if torch.is_tensor(v):
        return torch.where(torch.isnan(v), torch.zeros_like(v), v)
    v = np.asarray(v)
    return np.where(np.isnan(v), np.zeros_like(v), v)


def np_hemispheric_mean(vec, x) -> float:
    """NumPy twin of :func:`hemispheric_mean` for one ``(nx,)`` row, as a
    Python float (the host-side plotting paths)."""
    vec, x = np.asarray(vec), np.asarray(x)
    return float(np.sum((vec[:-1] + vec[1:]) * (x[1:] - x[:-1]) / 2.0))


def flush_subnormal(x):
    """``x`` with each subnormal value replaced by a zero of its sign, every
    other value (NaN and infinities too) kept: the flush to zero that XLA's
    CPU backend and the TPU apply to every result, and with which the JAX
    package computes. The MIZ step applies it where a value that decays
    geometrically would otherwise reach a zero test or a division as a
    subnormal (``models/miz.py::step``). The derivative is 1 everywhere but
    at a flushed value, so an exact zero (an ice-free cell's ``Ei``) keeps
    its gradient, as under the backends' flush."""
    return x * ((torch.abs(x) >= torch.finfo(x.dtype).tiny) | (x == 0))
