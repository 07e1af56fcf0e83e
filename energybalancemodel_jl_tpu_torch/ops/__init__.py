"""Numerical operators: diffusion stencil, tridiagonal solvers, Newton, and
the fused MIZ year (:mod:`.miz_year`, the CUDA kernel's wrapper)."""
from .diffusion import DiffusionGeometry, apply_diffusion, diffusion_bands, neighbor_cells
from .newton import newton_tridiag
from .tridiag import pcr_solve, thomas_solve, tridiag_solve

__all__ = [
    "DiffusionGeometry",
    "diffusion_bands",
    "apply_diffusion",
    "neighbor_cells",
    "thomas_solve",
    "pcr_solve",
    "tridiag_solve",
    "newton_tridiag",
]
