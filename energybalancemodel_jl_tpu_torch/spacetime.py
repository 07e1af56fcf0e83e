"""Space-time discretization (rebuild of ``SpaceTime{F}``
EnergyBalanceModel.jl src/infrastructure.jl:109-166).

The grid and time vectors are precomputed host-side as static float64 numpy
arrays; the integrator converts them to tensors of the run's dtype and
device once per run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import numpy as np

__all__ = ["SpaceTime"]

_GRID_FNS = {
    "identity": lambda u: u,
    "sin": np.sin,
}


def _resolve_grid(grid) -> Tuple[str, Callable]:
    if callable(grid):
        name = getattr(grid, "__name__", repr(grid))
        return name, grid
    if grid in _GRID_FNS:
        return grid, _GRID_FNS[grid]
    raise ValueError(f"Unknown grid map {grid!r}; use 'identity', 'sin', or a callable")


@dataclasses.dataclass(frozen=True)
class SpaceTime:
    """Spatial and temporal grid.

    A uniform grid ``u`` of ``nx`` cell midpoints on ``urange`` is mapped to
    the model grid ``x = F(u)`` (reference :125-127). ``F='identity'`` with
    ``urange=(0,1)`` gives a grid uniform in ``x``; ``F='sin'`` with
    ``urange=(0, pi/2)`` gives a grid uniform in latitude, ``x`` = sine
    latitude. ``nt`` timesteps per year, ``dur`` years, ``dt = 1/nt``
    (reference :128). ``winter``/``summer`` are the in-year times of the
    seasonal peaks; their snapshot step indices are ``round(nt*winter)`` /
    ``round(nt*summer)`` (1-based in the reference :131-132; stored here both
    1-based, matching the reference's ``ti == inx`` comparison).

    Construct with :meth:`identity` or :meth:`sin` for the reference's
    convenience constructors (:139-141)::

        st = SpaceTime.sin(180, 2000, 30)
    """

    nx: int
    nt: int
    dur: int
    grid: str = "identity"
    urange: Tuple[float, float] = (0.0, 1.0)
    winter: float = 0.26125
    summer: float = 0.77375

    def __post_init__(self):
        _resolve_grid(self.grid)  # validate early
        if self.nx <= 0 or self.nt <= 0 or self.dur <= 0:
            raise ValueError("nx, nt and dur must be positive")

    # -- constructors ---------------------------------------------------
    @classmethod
    def identity(cls, nx: int, nt: int, dur: int, **kw) -> "SpaceTime":
        """``SpaceTime{identity}(nx, nt, dur)`` — uniform grid on (0, 1)."""
        return cls(nx, nt, dur, grid="identity", urange=(0.0, 1.0), **kw)

    @classmethod
    def sin(cls, nx: int, nt: int, dur: int, **kw) -> "SpaceTime":
        """``SpaceTime{sin}(nx, nt, dur)`` — uniform-latitude grid,
        x = sine latitude, urange (0, pi/2)."""
        return cls(nx, nt, dur, grid="sin", urange=(0.0, math.pi / 2.0), **kw)

    # -- derived arrays (cached lazily; frozen dataclass => object.__setattr__)
    @property
    def dx(self) -> float:
        return (self.urange[1] - self.urange[0]) / self.nx

    @property
    def u(self) -> np.ndarray:
        """Uniform grid of cell midpoints (reference :126)."""
        return self.urange[0] + (np.arange(self.nx, dtype=np.float64) + 0.5) * self.dx

    @property
    def x(self) -> np.ndarray:
        """Model grid ``F(u)`` (reference :127)."""
        _, fn = _resolve_grid(self.grid)
        return np.asarray(fn(self.u), dtype=np.float64)

    @property
    def dt(self) -> float:
        return 1.0 / self.nt

    @property
    def t(self) -> np.ndarray:
        """In-year midpoint times, ``dt/2 .. 1-dt/2`` (reference :129)."""
        return np.linspace(self.dt / 2.0, 1.0 - self.dt / 2.0, self.nt)

    @property
    def T(self) -> np.ndarray:
        """Full simulation time series ``dt/2 : dt : dur - dt/2`` (reference :130)."""
        return (np.arange(self.dur * self.nt, dtype=np.float64) + 0.5) * self.dt

    @property
    def winter_inx(self) -> int:
        """1-based in-year step index of the winter snapshot,
        ``round(nt*winter)`` with banker's rounding (reference :131)."""
        return _round_half_even(self.nt * self.winter)

    @property
    def summer_inx(self) -> int:
        """1-based in-year step index of the summer snapshot (reference :132)."""
        return _round_half_even(self.nt * self.summer)

    def __repr__(self):
        return f"SpaceTime.{self.grid}({self.nx}, {self.nt}, {self.dur})"


def _round_half_even(v: float) -> int:
    """Julia's ``round(Int, x)`` — round to nearest, ties to even."""
    return int(np.round(v))
