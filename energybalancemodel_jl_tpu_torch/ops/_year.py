"""Argument handling shared by the whole-year kernel wrappers
(:mod:`.miz_year`, :mod:`.classic_year`)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["member_columns", "check_year_args", "check_width"]


def member_columns(par, names, K: int, dtype, device):
    """name -> ``(K,)`` tensor for each of ``names`` and the virtual ``"F"``
    forcing offset. Each leaf of ``par`` is a scalar (shared) or has shape
    ``(K,)`` (swept); ``"F"`` is optional (a per-member constant added to the
    forcing, 0 when absent)."""
    def col(v):
        v = torch.as_tensor(v, dtype=dtype, device=device)
        if v.ndim == 0:
            return v.expand(K)
        v = v.reshape(-1)
        if v.shape[0] != K:
            raise ValueError(
                f"swept parameter leaves must have shape ({K},), got {tuple(v.shape)}"
            )
        return v

    cols = {n: col(par[n]) for n in names}
    cols["F"] = col(par.get("F", 0.0))
    return cols


def check_year_args(carry, keys, fyear, st, what: str):
    """Check a year's ``(K, nx)`` carry (every field of ``keys`` with one
    shape, dtype and device, on ``st``'s grid) and its ``(nt,)`` forcing
    row; returns ``(K, nx, dtype, device)``."""
    first = carry[keys[0]]
    if first.ndim != 2:
        raise ValueError(f"{what} takes a (K, nx) carry, got shape {tuple(first.shape)}")
    K, nx = first.shape
    if nx != st.nx:
        raise ValueError(f"carry has nx={nx} but the SpaceTime has nx={st.nx}")
    for k in keys:
        v = carry[k]
        if v.shape != first.shape or v.dtype != first.dtype or v.device != first.device:
            raise ValueError(
                f"carry[{k!r}] is {v.dtype} {tuple(v.shape)} on {v.device}; "
                f"expected {first.dtype} {tuple(first.shape)} on {first.device}"
            )
    if tuple(np.shape(fyear)) != (st.nt,):
        raise ValueError(f"fyear must have shape ({st.nt},), got {tuple(np.shape(fyear))}")
    return K, nx, first.dtype, first.device


def check_width(kernel: str, nx: int, max_nx: int, layout: str) -> None:
    """Raise ``ValueError`` when a grid is wider than the kernel runs."""
    if nx > max_nx:
        raise ValueError(
            f"the {kernel} kernel runs {layout} (nx <= {max_nx}); nx={nx} needs "
            "the high-resolution layout of ROADMAP Queue 1 M8"
        )
