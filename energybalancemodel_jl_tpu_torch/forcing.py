"""Climate forcing F(t) (rebuild of ``Forcing{C}``
EnergyBalanceModel.jl src/infrastructure.jl:208-307).

Constant forcing or a 5-segment ramp: hold ``base`` -> warm at ``rates[0] > 0``
-> hold ``peak`` -> cool at ``rates[1] < 0`` -> hold ``cool``. ``domain`` holds
the 5 breakpoint years. Evaluation is branch-free (``np.where`` chain) so a
whole run's forcing can be tabulated once and fed to the year loop as a
per-step input.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["Forcing"]


@dataclasses.dataclass(frozen=True)
class Forcing:
    """Callable climate forcing.

    ``Forcing(base)`` is constant (reference :217-219). The ramp constructor
    ``Forcing(base, peak, cool, holdyrs, rates)`` validates that the warming
    time ``(peak-base)/rates[0]`` and cooling time ``(cool-peak)/rates[1]``
    are positive integers (reference :221-240).

    Examples
    --------
    >>> f = Forcing(0.0, 5.0, -5.0, (10, 10), (0.5, -0.5))
    >>> f.domain
    (0, 10, 20, 30, 50)
    >>> f(17.57)
    3.785
    """

    base: float
    peak: float = None  # type: ignore[assignment]
    cool: float = None  # type: ignore[assignment]
    holdyrs: Tuple[int, int] = (0, 0)
    rates: Tuple[float, float] = (0.0, 0.0)
    constant: bool = dataclasses.field(init=False, default=True)
    domain: Tuple[int, int, int, int, int] = dataclasses.field(
        init=False, default=(0, 0, 0, 0, 0)
    )

    def __post_init__(self):
        if self.peak is None and self.cool is None:
            # constant forcing
            object.__setattr__(self, "peak", float(self.base))
            object.__setattr__(self, "cool", float(self.base))
            object.__setattr__(self, "constant", True)
            object.__setattr__(self, "domain", (0, 0, 0, 0, 0))
            return
        if self.peak is None or self.cool is None:
            raise TypeError("Provide base only (constant) or base, peak, cool, holdyrs, rates")
        domain = [0, 0, 0, 0, 0]
        for i in range(1, 5):  # hold at base
            domain[i] += self.holdyrs[0]
        warming = (self.peak - self.base) / self.rates[0]
        if not (self.rates[0] > 0 and float(warming).is_integer()):
            raise ValueError(f"Warming time must be positive integer. Got {warming} y.")
        for i in range(2, 5):
            domain[i] += int(warming)
        for i in range(3, 5):  # hold at peak
            domain[i] += self.holdyrs[1]
        cooling = (self.cool - self.peak) / self.rates[1]
        if not (self.rates[1] < 0 and float(cooling).is_integer()):
            raise ValueError(f"Cooling time must be positive integer. Got {cooling} y.")
        domain[4] += int(cooling)
        object.__setattr__(self, "constant", False)
        object.__setattr__(self, "domain", tuple(domain))

    # -- evaluation ------------------------------------------------------
    def __call__(self, T):
        """Evaluate the forcing at time ``T`` (years); scalar or array.
        Piecewise evaluation mirrors reference :294-307, vectorized
        branch-free."""
        if self.constant:
            if np.ndim(T) == 0:
                return float(self.base)
            return np.full(np.shape(T), self.base, dtype=np.float64)
        T = np.asarray(T, dtype=np.float64)
        d = self.domain
        out = np.where(
            T < d[1],
            self.base,
            np.where(
                T < d[2],
                self.base + self.rates[0] * (T - d[1]),
                np.where(
                    T < d[3],
                    self.peak,
                    np.where(T < d[4], self.peak + self.rates[1] * (T - d[3]), self.cool),
                ),
            ),
        )
        return float(out) if out.ndim == 0 else out

    def table(self, st) -> np.ndarray:
        """Tabulate the forcing over every step of a run as a ``(dur, nt)``
        float64 array — the year loop's per-step forcing input."""
        return self(st.T).reshape(st.dur, st.nt) if not self.constant else np.full(
            (st.dur, st.nt), self.base, dtype=np.float64
        )

    def annual_mean(self, st, year: int) -> float:
        """Mean forcing over (1-based) ``year`` (rebuild of
        ``annual_mean(forcing, st, year)``
        EnergyBalanceModel.jl src/infrastructure.jl:546-547)."""
        return float(np.mean(self(year - 1 + st.t)))

    def __repr__(self):
        """Lossless: ``base/peak/cool`` plus ``domain`` fully determine the
        ramp (holdyrs and rates are recoverable from the breakpoint years),
        so two different forcings can never share a repr — the checkpoint
        config keys embed this string to refuse cross-configuration resumes
        (reference save/overwrite-safety intent,
        EnergyBalanceModel.jl src/io.jl:37-52)."""
        if self.constant:
            return f"Forcing({self.base}) (constant forcing)"
        return (
            f"Forcing({self.base} ↗ {self.peak} ↘ {self.cool}, "
            f"domain={self.domain})"
        )
