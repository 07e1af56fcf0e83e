"""Spatial domain decomposition of the diffusion stencil (halo exchange).

Port of the JAX package's ``parallel/halo.py``. The 3-point meridional
stencil shards over the grid axis: each shard owns a contiguous block of
latitudes and receives one boundary cell from each ring neighbour per
application (:func:`..ops.diffusion.neighbor_cells` with an axis name,
``ppermute`` of :mod:`.mesh`). Worthwhile only at very high resolution; at
nx = 180 the ensemble axis is the one to shard.
"""
from __future__ import annotations

import torch

from ..ops.diffusion import diffusion_bands, neighbor_cells
from ..utils.numerics import fma
from .mesh import Mesh, P, mesh_devices, shard_map

__all__ = ["grid_mesh", "sharded_diffusion"]


def grid_mesh(n_devices=None, axis: str = "x", device=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` shards for the grid axis: the CUDA
    devices, or ``device`` (one device or a sequence), cycled, so one device
    may hold several shards (:func:`.mesh.mesh_devices`)."""
    return Mesh(mesh_devices(n_devices, device), (axis,))


def sharded_diffusion(st, mesh: Mesh):
    """``fn(T, D) -> D∇²T`` with ``T`` sharded over the grid axis: each shard
    applies the local stencil to its block, the two halo cells coming from
    its ring neighbours (the wrapped halo values at the two ends multiply the
    zero boundary bands, so they need no special case)."""
    axis = mesh.axis_names[0]
    if st.nx % mesh.size != 0:
        raise ValueError(f"nx={st.nx} must divide evenly over {mesh.size} devices")
    geom = diffusion_bands(st)

    def local(T, D, lo, di, up):
        Tm1, Tp1 = neighbor_cells(T, axis)
        # the stencil's sum as XLA:CPU contracts the JAX package's (the
        # first product into the first sum, the third into the second)
        return D * fma(up, Tp1, fma(lo, Tm1, di * T))

    smapped = shard_map(local, mesh, in_specs=(P(axis), P(), P(axis), P(axis), P(axis)),
                        out_specs=P(axis))

    def fn(T, D):
        T = torch.as_tensor(T)
        band = lambda b: torch.as_tensor(b, dtype=T.dtype, device=T.device)
        return smapped(T, torch.as_tensor(D, dtype=T.dtype, device=T.device),
                       band(geom.lo), band(geom.di), band(geom.up))

    return fn
