"""Plain Classic (WE15) year (Wagner & Eisenman 2015; EnergyBalanceModel.jl
``src/classic.jl:37-71``): one enthalpy field with seasonal insolation,
A + BT outgoing longwave, the ice-albedo switch, and an implicit ghost-layer
surface temperature solved as a tridiagonal system each step.

Every fused multiply-add sits where the models' fused loops put one (see
:func:`.common.fma`), so a float32 year rounds as the port's plain float32
year does.
"""
from __future__ import annotations

import math

import torch

from .common import Grid, Replay, Seasonal, bands_uniform, fma, host_cos, pcr_solve

PARAMS = ("cg", "tau", "B", "k", "Lf", "D", "ai", "A", "Fb", "cw", "S0", "S1", "S2", "a0",
          "a2")
CARRY = ("E", "Tg")
OUT_VARS = ("E", "T", "h")


def statics(grid: Grid, par, dtype, device):
    """``get_statics`` (``src/classic.jl:12-34``): scalar combinations, the
    water coalbedo, the cos-free insolation factor, the ``cos(2 pi t)`` table
    with its wraparound entry, and the implicit matrix
    ``(1 + dt/tau) I - dt D diffop / cg`` as bands of the uniform-grid
    operator (the reference uses it on every grid)."""
    x = torch.as_tensor(grid.x, dtype=dtype, device=device)
    x2 = x * x
    dt = torch.as_tensor(grid.dt, dtype=dtype, device=device)
    cg_tau = par["cg"] / par["tau"]
    dt_tau = dt / par["tau"]
    dtD = dt * par["D"]
    t = torch.as_tensor(grid.t, dtype=dtype)
    cosv = host_cos(2.0 * math.pi * t)
    lo, di, up = (torch.as_tensor(b, dtype=dtype, device=device)
                  for b in bands_uniform(grid.nx))
    return dict(
        cg_tau=cg_tau, dt_tau=dt_tau, dc=dt_tau * cg_tau, M=par["B"] + cg_tau,
        kLf=par["k"] * par["Lf"],
        aw=fma(-par["a2"], x2, par["a0"]),
        SA=fma(-par["S2"], x2, par["S0"]),
        x=x,
        cosv=torch.cat([cosv, cosv[:1]]).to(device),
        klo=-dtD * lo / par["cg"],
        kdi=(1.0 + dt_tau) - dtD * di / par["cg"],
        kup=-dtD * up / par["cg"],
        dt=dt,
    )


def step(carry, t, first: bool, f, st, par):
    """One WE15 step (``src/classic.jl:37-71``) on ``(K, nx)`` fields at step
    ``t`` (a one-element index tensor); the year's first step contracts ``cg/tau Tg``,
    the others ``alpha S``."""
    E, Tg = carry["E"], carry["Tg"]
    S_i = fma(-(par["S1"] * st["cosv"].index_select(0, t)), st["x"], st["SA"])
    S_ip1 = fma(-(par["S1"] * st["cosv"].index_select(0, t + 1)), st["x"], st["SA"])
    dtype, where = E.dtype, torch.where

    pos = (E > 0.0).to(dtype)
    neg = (E < 0.0).to(dtype)
    nonneg = (E >= 0.0).to(dtype)
    alpha = st["aw"] * pos + par["ai"] * neg
    if first:
        C = fma(st["cg_tau"], Tg, alpha * S_i) - par["A"] + f
    else:
        C = fma(alpha, S_i, st["cg_tau"] * Tg) - par["A"] + f
    zeroE = E == 0.0
    T0 = where(zeroE, 0.0, C / (st["M"] - st["kLf"] / where(zeroE, 1.0, E)))
    T = E / par["cw"] * nonneg + T0 * (neg * (T0 < 0.0).to(dtype))
    E_new = fma(fma(-st["M"], T, C) + par["Fb"], st["dt"], E)

    zeroEn = E_new == 0.0
    negn = (E_new < 0.0).to(dtype)
    nonnegn = (E_new >= 0.0).to(dtype)
    t0neg = (T0 < 0.0).to(dtype)
    denom = st["M"] - st["kLf"] / where(zeroEn, 1.0, E_new)
    mask = t0neg * negn
    kdi = st["kdi"] - st["dc"] / denom * mask
    rhs = fma(st["dt_tau"],
              E_new / par["cw"] * nonnegn + (fma(par["ai"], S_ip1, -par["A"]) + f) / denom * mask,
              Tg)
    Tg_new = pcr_solve(st["klo"], kdi, st["kup"], rhs)
    h = torch.where(E_new < 0.0, -E_new / par["Lf"], 0.0)
    return dict(E=E_new, Tg=Tg_new), dict(E=E_new, T=T, h=h)


class Year:
    """Model years of ``K`` members from ``carry``; each step one
    :class:`.common.Replay` (the first step of a year its own)."""

    def __init__(self, grid: Grid, par, f_rows, carry, newton_cfg, dtype, device):
        self.grid, self.par, self.f_rows = grid, par, f_rows
        self.st = statics(grid, par, dtype, device)
        self.carry = {k: carry[k].clone() for k in CARRY}
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        self.out = {k: torch.zeros_like(self.carry["E"]) for k in OUT_VARS}
        self.seasonal = Seasonal(grid, self.out)
        state = list(self.carry.values()) + list(self.out.values()) + list(
            self.seasonal.acc.values())
        self.steps = {first: Replay(lambda first=first: self._step(first), state)
                      for first in (True, False)}

    def _step(self, first: bool):
        f = self.f_rows.index_select(0, self.t)[0]
        carry, out = step(self.carry, self.t, first, f, self.st, self.par)
        for k, v in carry.items():
            self.carry[k].copy_(v)
        for k, v in out.items():
            self.out[k].copy_(v)
        self.seasonal.add(first)

    def run(self) -> dict:
        """One model year; returns its seasonal stores."""
        stores = {}
        for t in range(self.grid.nt):
            self.t.fill_(t)
            self.steps[t == 0]()
            self.seasonal.snapshot(t, stores)
        return self.seasonal.average(stores)
