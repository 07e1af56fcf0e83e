"""Classic diffusive EBM with sea ice (Wagner & Eisenman 2015, "WE15").

Port of the JAX package's ``models/classic.py`` (itself a rebuild of
EnergyBalanceModel.jl ``src/classic.jl``): one enthalpy field ``E(x,t)``
with seasonal insolation, A+BT outgoing longwave, ice-albedo switching, an
implicit "ghost layer" surface temperature ``Tg``, and meridional heat
diffusion. The per-step sparse solve for ``Tg`` (reference :55-63) is a
tridiagonal solve; everything else is elementwise arithmetic.

Reference quirks reproduced deliberately (JAX ``models/classic.py:10-18``):

- The albedo switch ``alpha = aw*(E>0) + ai*(E<0)`` is **zero at E == 0**
  (reference :47): initial ``E = 0`` states absorb no solar on step 1.
- The diffusion operator is always the *uniform-grid* operator
  ``get_diffop(nx)`` (reference :21 calls it regardless of the grid map),
  so the classic model uses uniform-grid geometry even on a sin grid.
- ``T`` stored in solutions is computed from the *pre-update* ``E``
  (reference :51 before :53), while the ``Tg`` solve uses the updated ``E``.

The classic step has no Newton solve, so its outputs carry no convergence
flag. The fused year (``ops/classic_year.py``, the CUDA kernel
``csrc/classic_year.cu``) repeats :func:`step` operation for operation.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.diffusion import DiffusionGeometry
from ..ops.tridiag import tridiag_solve
from ..utils.collection import Collection
from ..utils.numerics import fma, host_cos
from .base import ModelSpec, StepConfig, register_model

__all__ = ["CLASSIC", "uniform_bands", "member_scalars", "cos_table"]


def uniform_bands(nx: int) -> DiffusionGeometry:
    """Uniform-grid diffusion bands, matching ``get_diffop``
    (EnergyBalanceModel.jl ``src/infrastructure.jl:480-491``)."""
    dx = 1.0 / nx
    xb = np.arange(1, nx, dtype=np.float64) * dx
    lam = (1.0 - xb**2) / dx**2
    lo = np.concatenate(([0.0], lam))
    up = np.concatenate((lam, [0.0]))
    di = -(lo + up)
    return DiffusionGeometry(lo=lo, di=di, up=up)


def member_scalars(par, dt: torch.Tensor) -> Collection:
    """The scalar combinations of ``get_statics`` (reference
    ``src/classic.jl:12-34``) and the band scale ``dt*D``, from parameter
    leaves that are scalars or per-member columns. ``dt`` is a tensor on
    the run's device, so ``dt / tau`` is a true division (PyTorch divides a
    Python scalar by a tensor as reciprocal-then-multiply). The fused year's
    member stack comes from this same code."""
    cg_tau = par["cg"] / par["tau"]
    dt_tau = dt / par["tau"]
    return Collection(
        cg_tau=cg_tau,
        dt_tau=dt_tau,
        dc=dt_tau * cg_tau,
        M=par["B"] + cg_tau,
        kLf=par["k"] * par["Lf"],
        dtD=dt * par["D"],
    )


def cos_table(st, dtype) -> torch.Tensor:
    """``cos(2 pi t)`` of every step plus the wraparound entry
    ``cos[nt] == cos[0]`` (reference :23-25), ``(nt + 1,)`` on the host; a
    device's cos may round differently, so the table is built here once for
    the eager step and the kernel alike."""
    t = torch.as_tensor(st.t, dtype=dtype)
    cosv = host_cos(2.0 * math.pi * t)
    return torch.cat([cosv, cosv[:1]])


def statics(st, par, dtype, device):
    """Per-run precompute (rebuild of ``get_statics``): the scalar
    combinations, water coalbedo, the cos-independent insolation factor
    ``S0 - S2 x^2`` and the implicit matrix ``kappa = (1 + dt/tau) I -
    dt D diffop / cg`` as tridiagonal bands over the uniform-grid operator.
    Parameters may be scalars or ``(K, 1)`` per-member columns, table
    parameters included: the insolation rows of a step are built at use
    (:func:`step_inputs`), with the grouping of the reference's table
    ``S = (S0 - S2 x^2) - (S1 cos(2 pi t)) x``."""
    x = torch.as_tensor(st.x, dtype=dtype, device=device)
    x2 = x * x
    dt = torch.as_tensor(st.dt, dtype=dtype, device=device)
    s = member_scalars(par, dt)
    geom = uniform_bands(st.nx)
    band = lambda b: torch.as_tensor(b, dtype=dtype, device=device)
    return Collection(
        s,
        aw=fma(-par["a2"], x2, par["a0"]),
        SA=fma(-par["S2"], x2, par["S0"]),
        S1=par["S1"],
        x=x,
        cosv=cos_table(st, dtype).to(device),
        klo=-s.dtD * band(geom.lo) / par["cg"],
        kdi=(1.0 + s.dt_tau) - s.dtD * band(geom.di) / par["cg"],
        kup=-s.dtD * band(geom.up) / par["cg"],
        dt=dt,
    )


def init_carry(init, st, dtype, device):
    """Step carry from initial conditions; classic needs ``E`` and ``Tg``
    (reference ``src/infrastructure.jl:604-605``)."""
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return Collection(E=t(init["E"]), Tg=t(init["Tg"]))


def step_inputs(stat, fyear, t: int):
    """The inputs of step ``t``: insolation row ``t``, row ``t + 1`` (the
    implicit step reads the wraparound row, reference :61), the forcing, and
    whether ``t`` is the year's first step."""
    return dict(
        S_i=fma(-(stat.S1 * stat.cosv[t]), stat.x, stat.SA),
        S_ip1=fma(-(stat.S1 * stat.cosv[t + 1]), stat.x, stat.SA),
        f=fyear[t],
        first=t == 0,
    )


def step(carry, xs, stat, par, cfg: StepConfig):
    """One WE15 step (rebuild of ``step!(::Val{:Classic})``,
    ``src/classic.jl:37-71``; line for line the JAX package's
    ``classic.step``, with the fused multiply-adds XLA:CPU makes of it,
    listed in :mod:`..utils.numerics`)."""
    E, Tg = carry["E"], carry["Tg"]
    S_i, S_ip1, f = xs["S_i"], xs["S_ip1"], xs["f"]
    dtype = E.dtype
    where = torch.where

    pos = (E > 0.0).to(dtype)
    neg = (E < 0.0).to(dtype)
    nonneg = (E >= 0.0).to(dtype)
    alpha = stat.aw * pos + par["ai"] * neg  # WE15 Eq. (4); zero at E == 0 (:47)
    # XLA:CPU contracts alpha S in the scan body, cg_tau Tg in the year's
    # first step, which the JAX package's scan peels (``xs["first"]``)
    if xs.get("first", False):
        C = fma(stat.cg_tau, Tg, alpha * S_i) - par["A"] + f  # (:48)
    else:
        C = fma(alpha, S_i, stat.cg_tau * Tg) - par["A"] + f
    # E == 0 lanes: the reference's kLf/0 = inf gives T0 = -+0.0, whose only
    # use is through the (T0 < 0) mask — false for both signed zeros — so
    # pinning T0 = 0 there is output-identical (double-where pattern)
    zeroE = E == 0.0
    T0 = where(zeroE, 0.0, C / (stat.M - stat.kLf / where(zeroE, 1.0, E)))  # WE15 Eq. (A3) (:50)
    T = E / par["cw"] * nonneg + T0 * (neg * (T0 < 0.0).to(dtype))  # WE15 Eq. (9) (:51)
    E_new = fma(fma(-stat.M, T, C) + par["Fb"], stat.dt, E)  # WE15 Eq. (A2) (:53)

    # Implicit Euler for Tg (WE15 Eq. (A1), :55-63) — masks use the *updated*
    # E. E_new == 0 lanes have mask == 0, so the guarded denominator is again
    # output-identical.
    zeroEn = E_new == 0.0
    negn = (E_new < 0.0).to(dtype)
    nonnegn = (E_new >= 0.0).to(dtype)
    t0neg = (T0 < 0.0).to(dtype)
    denom = stat.M - stat.kLf / where(zeroEn, 1.0, E_new)
    mask = t0neg * negn
    kdi = stat.kdi - stat.dc / denom * mask
    rhs = fma(stat.dt_tau,
              E_new / par["cw"] * nonnegn + (fma(par["ai"], S_ip1, -par["A"]) + f) / denom * mask,
              Tg)
    if cfg.spatial_axis is not None:
        method = "spike"  # the grid sharded over a mesh axis
    else:
        method = "pcr" if cfg.solver == "pallas" else cfg.solver
    Tg_new = tridiag_solve(stat.klo, kdi, stat.kup, rhs, method=method,
                           axis_name=cfg.spatial_axis, axis=cfg.grid_axis)

    # diagnostic ice thickness (:65); XLA selects where the mask is 0, so an
    # ice-free cell's h is +0
    h = torch.where(E_new < 0.0, -E_new / par["Lf"], 0.0)

    carry = Collection(E=E_new, Tg=Tg_new)
    out = Collection(E=E_new, T=T, h=h)
    return carry, out


CLASSIC = register_model(
    ModelSpec(
        name="Classic",
        statics=statics,
        init_carry=init_carry,
        step=step,
        step_inputs=step_inputs,
        solution_vars=("E", "T", "h"),
        init_vars=("E", "Tg"),
    )
)
