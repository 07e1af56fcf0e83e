"""Numerical operators: diffusion stencil, tridiagonal solvers, Newton, and
the wrappers of the CUDA kernels: the fused MIZ and Classic years with their
noise modes (:mod:`.miz_year`, :mod:`.classic_year`), the batched PCR solve
(:mod:`.pcr_fused`), the fixed-iteration Newton solve for T0
(:mod:`.newton_t0`) and the weather draws (:mod:`.normal_table`, plain
versions in :mod:`.prng`)."""
from .diffusion import (DiffusionGeometry, apply_diffusion, diffusion, diffusion_bands,
                        neighbor_cells)
from .newton import newton_tridiag
from .tridiag import pcr_solve, thomas_solve, tridiag_matvec, tridiag_solve

__all__ = [
    "DiffusionGeometry",
    "diffusion_bands",
    "apply_diffusion",
    "diffusion",
    "neighbor_cells",
    "thomas_solve",
    "pcr_solve",
    "tridiag_solve",
    "tridiag_matvec",
    "newton_tridiag",
]
