"""Ensembles and multi-device parallelism (port of the JAX package's
``parallel``).

- :mod:`.ensemble` — parameter ensembles on one device.
- :mod:`.mesh` — the mesh of shards, ``shard_map`` and the collectives (the
  counterpart of ``jax.sharding.Mesh`` and ``lax``'s collectives).
- :mod:`.sharding` — data parallelism: ensemble members split over a mesh.
- :mod:`.halo` — the diffusion stencil with the grid axis sharded (halo
  exchange).
- :mod:`.spatial` — grid-sharded single runs (halo exchange and distributed
  SPIKE tridiagonal solves).
- :mod:`.grid2d` — members x grid shards on one ``(k, x)`` mesh.
"""
from .ensemble import EnsembleSolutions, ensemble_integrate, sweep
from .grid2d import ensemble_spatial_integrate, grid2d_mesh
from .sharding import ensemble_mesh, sharded_ensemble_integrate
from .spatial import grid_mesh, spatial_integrate

__all__ = [
    "EnsembleSolutions",
    "ensemble_integrate",
    "sweep",
    "ensemble_mesh",
    "sharded_ensemble_integrate",
    "spatial_integrate",
    "grid_mesh",
    "ensemble_spatial_integrate",
    "grid2d_mesh",
]
