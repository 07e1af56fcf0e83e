"""Meridional heat diffusion operator ``D∇²`` as a tridiagonal stencil.

Rebuild of EnergyBalanceModel.jl ``src/infrastructure.jl:477-533``. Both of
the reference's code paths (the cached sparse matrix of the uniform grid and
the flux-form stencil of general grids) are strictly tridiagonal, so each
becomes a set of precomputed stencil *bands* ``(lo, di, up)``, with the
diffusivity ``D`` factored out so ensembles sweep ``D`` without rebuilding
geometry:

    (∇²T)_j = lo_j T_{j-1} + di_j T_j + up_j T_{j+1},   D∇²T = D * ∇²T

with zero-flux boundaries (lo_0 = up_{nx-1} = 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DiffusionGeometry", "diffusion_bands", "neighbor_cells", "apply_diffusion",
           "diffusion"]


@dataclasses.dataclass(frozen=True)
class DiffusionGeometry:
    """Precomputed stencil bands (numpy float64, host-side statics)."""

    lo: np.ndarray  # coefficient on T_{j-1}; lo[0] = 0
    di: np.ndarray  # coefficient on T_j
    up: np.ndarray  # coefficient on T_{j+1}; up[-1] = 0


def diffusion_bands(st) -> DiffusionGeometry:
    """Build the stencil bands for a :class:`SpaceTime`.

    Uniform (``identity``) grid — reference ``get_diffop``
    (``src/infrastructure.jl:480-491``): interior cell edges
    ``x_b = dx .. 1-dx`` carry weights ``lambda_b = (1 - x_b^2)/dx^2``; row j is
    ``lambda_{j-1} T_{j-1} - (lambda_{j-1}+lambda_j) T_j + lambda_j T_{j+1}``
    with ``lambda_0 = lambda_nx = 0``.

    General grid — reference ``diffusion!`` (:505-527): reflective ghost
    extension ``[-x_0; x; 2-x_{nx-1}]``, edge midpoints ``x_{j±1/2}``, weights
    ``(1 - x_{j±1/2}^2)``, divided differences over ``diff(x)`` and
    ``x_{j+1/2} - x_{j-1/2}``.
    """
    nx = st.nx
    if st.grid == "identity":
        dx = 1.0 / nx
        xb = np.arange(1, nx, dtype=np.float64) * dx  # dx .. 1-dx (interior edges)
        lam = (1.0 - xb**2) / dx**2  # (nx-1,)
        lo = np.concatenate(([0.0], lam))
        up = np.concatenate((lam, [0.0]))
        di = -(lo + up)
        return DiffusionGeometry(lo=lo, di=di, up=up)
    x = st.x
    xg = np.concatenate(([-x[0]], x, [2.0 - x[-1]]))  # reflective ghosts (:510)
    diffx = np.diff(xg)  # (nx+1,)
    xxph = (xg[2:] + xg[1:-1]) / 2.0  # x_{j+1/2}, j = 0..nx-1 (:514)
    xxmh = (xg[1:-1] + xg[:-2]) / 2.0  # x_{j-1/2} (:515)
    mxxph = 1.0 - xxph**2  # (:516)
    mxxmh = 1.0 - xxmh**2  # (:517)
    phmmh = xxph - xxmh  # (:518)
    a = mxxph / diffx[1:] / phmmh  # weight on (T_{j+1} - T_j)
    b = mxxmh / diffx[:-1] / phmmh  # weight on (T_j - T_{j-1})
    a[-1] = 0.0  # diffT[end] = 0 — zero-flux (:522)
    b[0] = 0.0  # diffT[1] = 0
    lo = b.copy()
    up = a.copy()
    di = -(a + b)
    return DiffusionGeometry(lo=lo, di=di, up=up)


def neighbor_cells(v: torch.Tensor, axis_name=None, axis: int = -1):
    """``(v_{i-1}, v_{i+1})`` along the grid ``axis`` (default last).

    Single shard: boundary-rolled values (the wrapped entries are multiplied
    by the zero band entries at the boundaries, so the wraparound is
    harmless). With ``axis_name`` (the grid axis sharded over that mesh axis,
    called inside :func:`..parallel.mesh.shard_map`): the one-cell halo
    exchange with the ring neighbours by ``ppermute`` (last axis only), as
    JAX ``ops/diffusion.py:76-100``.
    """
    if axis_name is None:
        return torch.roll(v, 1, dims=axis), torch.roll(v, -1, dims=axis)
    if axis not in (-1, v.ndim - 1):
        raise ValueError("halo exchange is only supported along the last axis")
    from ..parallel.mesh import ring_neighbors

    # the two ppermutes of JAX's exchange (the left neighbour's last cell,
    # the right neighbour's first) as one collective of both edge cells
    left, right = ring_neighbors(torch.stack([v[..., -1:], v[..., :1]]), axis_name)
    return (torch.cat([left[0], v[..., :-1]], dim=-1),
            torch.cat([v[..., 1:], right[1]], dim=-1))


def apply_diffusion(T: torch.Tensor, geom: DiffusionGeometry, D):
    """``D∇²T`` for a temperature field ``T`` of shape ``(..., nx)``."""
    band = lambda b: torch.as_tensor(b, dtype=T.dtype, device=T.device)
    Tm1, Tp1 = neighbor_cells(T)
    return D * (band(geom.lo) * Tm1 + band(geom.di) * T + band(geom.up) * Tp1)


def diffusion(T, st, par):
    """Out-of-place ``D∇²T`` on the grid of ``st`` with ``par["D"]`` (JAX
    ``ops/diffusion.py::diffusion``, the reference's ``diffusion``,
    ``src/infrastructure.jl:529-530``)."""
    T = T if torch.is_tensor(T) else torch.as_tensor(np.asarray(T))
    return apply_diffusion(T, diffusion_bands(st), par["D"])
