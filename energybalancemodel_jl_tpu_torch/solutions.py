"""Solution storage (rebuild of ``Solutions{F,C}``
EnergyBalanceModel.jl src/infrastructure.jl:333-404 and the recording logic
``savesol!``/``annual_mean`` :536-591).

The reference stores vectors-of-vectors filled step by step; here storage is
dense arrays produced by the year loop: ``raw`` holds ``(n_ts, nx)`` per variable
(all ``dur*nt`` steps, or only the final year when ``lastonly``), and
``seasonal`` holds per-year ``(dur, nx)`` winter/summer snapshots (state after
the step at the winter/summer tick indices) and annual means (mean over the
year's steps — NaNs propagate, matching ``Statistics.mean`` over stored raw
states).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .forcing import Forcing
from .spacetime import SpaceTime
from .utils.collection import Collection

__all__ = ["Seasonal", "Solutions", "annual_mean"]


class Seasonal(NamedTuple):
    winter: Collection
    summer: Collection
    avg: Collection


@dataclasses.dataclass
class Solutions:
    """Results of an :func:`~energybalancemodel_jl_tpu_torch.integrate` run.

    Fields mirror the reference (EnergyBalanceModel.jl src/infrastructure.jl:333-344):
    ``spacetime``, ``ts`` (stored times), ``forcing``, ``parameters``,
    ``initconds``, ``lastonly``, ``debug``, ``raw`` and ``seasonal``.
    ``raw.E`` is an array of shape ``(len(ts), nx)``; ``raw.E[i]`` is the
    state at time ``ts[i]``. ``seasonal.avg.T`` has shape ``(dur, nx)``;
    index ``[y]`` is year ``y+1`` (the reference indexes years 1-based).
    """

    spacetime: SpaceTime
    ts: np.ndarray
    forcing: Forcing
    parameters: Collection
    initconds: Collection
    lastonly: bool
    debug: Optional[object]
    raw: Collection
    seasonal: Seasonal

    @staticmethod
    def stored_times(st: SpaceTime, lastonly: bool) -> np.ndarray:
        """Times of stored raw states (reference :352-356): the final year's
        ``nt`` midpoints when ``lastonly``, else all ``dur*nt``."""
        if lastonly:
            return (st.dur - 1.0) + (np.arange(st.nt, dtype=np.float64) + 0.5) * st.dt
        return st.T

    @property
    def variables(self) -> Tuple[str, ...]:
        return tuple(sorted(self.raw.keys()))

    def __repr__(self):
        nts = len(self.ts)
        if nts == 0:
            # raw_mode='none' runs store no per-step states — only seasonal
            return (
                f"Solutions({self.spacetime.nx}x0 (seasonal only, "
                f"{self.spacetime.dur} years), {self.variables})"
            )
        return (
            f"Solutions({self.spacetime.nx}x{nts}"
            f"@({self.ts[0]}:{self.spacetime.dt}:{self.ts[-1]}), {self.variables})"
        )


def annual_mean(obj, st: SpaceTime = None, year: int = None):
    """Annual means.

    - ``annual_mean(raw_collection)`` — elementwise mean over the leading
      (time) axis of each stored variable (rebuild of
      ``annual_mean(annusol)`` EnergyBalanceModel.jl src/infrastructure.jl:536-544).
    - ``annual_mean(forcing, st, year)`` — mean forcing over (1-based)
      ``year`` (reference :546-547).
    """
    if isinstance(obj, Forcing):
        return obj.annual_mean(st, year)
    return Collection({k: np.mean(np.asarray(v), axis=0) for k, v in obj.items()})
