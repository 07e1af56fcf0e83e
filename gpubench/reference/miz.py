"""Plain MIZ year (EnergyBalanceModel.jl ``src/miz.jl:150-196``): separate
ice and water enthalpies, ice concentration, floe size and thickness, and a
per-step Newton solve of the ice surface temperature with a tridiagonal
Jacobian.

Each member runs its own Newton iteration, as a single run of the reference
does: a member stops updating once its residual meets its tolerance, while
the others go on. Every fused multiply-add sits where the models' fused
loops put one (see :func:`.common.fma`), so a float32 year rounds as the
port's plain float32 year does; in float64 it is the parity reference.
"""
from __future__ import annotations

import math

import torch

from .common import (Grid, Replay, Seasonal, bands_general, flush, fma, host_cos, neighbors,
                     pcr_solve)

PARAMS = ("k", "Tm", "A", "B", "ai", "Fb", "cw", "m1", "m2", "Lf", "alpha", "rl", "Dmin",
          "Dmax", "hmin", "kappa", "D", "S0", "S1", "S2", "a0", "a2")
CARRY = ("Ei", "Ew", "h", "D", "phi", "T0")
OUT_VARS = ("E", "T", "h", "Ei", "Ew", "Ti", "Tw", "D", "phi", "n")


def statics(grid: Grid, par, dtype, device):
    """Per-run tables: the insolation factors, water coalbedo, stencil bands."""
    x = torch.as_tensor(grid.x, dtype=dtype, device=device)
    x2 = x * x
    t = torch.as_tensor(grid.t, dtype=dtype)
    lo, di, up = (torch.as_tensor(b, dtype=dtype, device=device) for b in bands_general(grid.x))
    return dict(
        S0=par["S0"], S1x=par["S1"] * x, S2=par["S2"], x2=x2,
        cosv=host_cos(2.0 * math.pi * t).to(device),
        aw=fma(-par["a2"], x2, par["a0"]),
        glo=lo, gdi=di, gup=up,
        dt=torch.as_tensor(grid.dt, dtype=dtype, device=device),
        Tm_pow_m2=par["Tm"] ** par["m2"],
    )


def _stencil(glo, gdi, gup, vm1, v, vp1):
    return fma(gup, vp1, fma(glo, vm1, gdi * v))


def _residual(T0, a, ai_insol=None):
    """The ice surface energy balance ``T0eq`` (``src/miz.jl:33-45``)."""
    Ti = torch.minimum(T0, a["Tm"])
    Tb = fma(Ti, a["phi"], (1.0 - a["phi"]) * a["Tw"])
    r = a["k"] * (a["Tm"] - T0) / a["hp"]
    r = fma(a["ai"], a["insol"], r) if ai_insol is None else r + ai_insol
    r = r + fma(-a["B"], T0 - a["Tm"], -a["A"])
    Tbm1, Tbp1 = neighbors(Tb)
    r = fma(a["D"], _stencil(a["glo"], a["gdi"], a["gup"], Tbm1, Tb, Tbp1), r)
    return r + a["f"]


def _bands(T0, a):
    """The residual's analytic tridiagonal Jacobian."""
    g = a["phi"] * (T0 < a["Tm"]).to(T0.dtype)
    gm1, gp1 = neighbors(g)
    jlo = a["D"] * a["glo"] * gm1
    jdi = fma(a["D"] * a["gdi"], g, -a["k"] / a["hp"] - a["B"])
    jup = a["D"] * a["gup"] * gp1
    return jlo, jdi, jup


def _args(insol, hp, Tw, phi, f, st, par):
    return dict(insol=insol, hp=hp, Tw=Tw, phi=phi, f=f, glo=st["glo"], gdi=st["gdi"],
                gup=st["gup"], k=par["k"], Tm=par["Tm"], A=par["A"], B=par["B"], ai=par["ai"],
                D=par["D"])


def newton_start(T0, a, newton_cfg):
    """The warm start's residual, Jacobian bands, norm, tolerance
    ``max(abstol, reltol |r0|)`` and which members iterate."""
    r, bands = _residual(T0, a), _bands(T0, a)
    rnorm = torch.amax(torch.abs(r), dim=-1)
    tol = torch.maximum(newton_cfg["abstol_t"], newton_cfg["reltol"] * rnorm)
    return r, bands, rnorm, tol, rnorm > tol


def newton_update(T0, r, bands, rnorm, tol, active, a, newton_cfg):
    """One Newton update of the members still iterating: each stops once its
    residual's max norm meets its tolerance (a member's own iteration, as a
    single run computes it). The update is capped at ``max_step``; a
    non-finite one is dropped."""
    delta = pcr_solve(*bands, -r, negated=True)
    delta = torch.clamp(delta, -newton_cfg["max_step"], newton_cfg["max_step"])
    delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
    T_new = T0 + delta
    r_new = _residual(T_new, a, a["ai"] * a["insol"])
    bands_new = _bands(T_new, a)
    keep = active[:, None]
    rnorm = torch.where(active, torch.amax(torch.abs(r_new), dim=-1), rnorm)
    return (torch.where(keep, T_new, T0), torch.where(keep, r_new, r),
            tuple(torch.where(keep, n, o) for n, o in zip(bands_new, bands)), rnorm,
            active & (rnorm > tol))


def before_newton(carry, par):
    """The water temperature and the thickness the solve divides by."""
    phi, Ew, h, where = carry["phi"], carry["Ew"], carry["h"], torch.where
    den = (1.0 - phi) * par["cw"]
    zden = den == 0.0
    Tw = par["Tm"] + where(zden, 0.0, Ew / where(zden, 1.0, den))
    Tw = where(torch.isnan(Tw), 0.0, Tw)
    return Tw, torch.where(h == 0.0, par["hmin"], h)


def after_newton(carry, T0, insol, f, Tw, st, par):
    """The rest of the MIZ step (``src/miz.jl:159-196``) from the solved ice
    surface temperature ``T0`` on ``(K, nx)`` fields."""
    Ei, Ew, h, Df, phi = carry["Ei"], carry["Ew"], carry["h"], carry["D"], carry["phi"]
    dt, Tm, where = st["dt"], par["Tm"], torch.where
    Ti = torch.minimum(T0, Tm)
    Ti = where(h == 0.0, 0.0, Ti)

    zeroD = Df == 0.0
    n = phi / where(zeroD, 1.0, par["alpha"] * (Df * Df))
    n = flush(where(zeroD, 0.0, n))

    Tb = fma(Ti, phi, (1.0 - phi) * Tw)
    L = fma(par["B"], Tb - Tm, par["A"])
    Tbm1, Tbp1 = neighbors(Tb)
    lap = _stencil(st["glo"], st["gdi"], st["gup"], Tbm1, Tb, Tbp1)
    base_i = fma(par["ai"], insol, -L)
    base_w = fma(st["aw"], insol, -L)
    dTb = par["D"] * lap
    Fvi = base_i + dTb + par["Fb"] + f
    Fvw = base_w + dTb + par["Fb"] + f
    Fvi_1 = fma(par["D"], lap, base_i) + par["Fb"] + f
    Fvw_1 = fma(par["D"], lap, base_w) + par["Fb"] + f
    wl = par["m1"] * (Tw - st["Tm_pow_m2"])
    Flat = phi * h * par["Lf"] * wl * math.pi / where(zeroD, 1.0, par["alpha"] * Df)
    Flat = where(zeroD, 0.0, Flat)

    rEi = fma(fma(phi, Fvi, Flat), dt, Ei)
    rEw = fma(fma(1.0 - phi, Fvw, -Flat), dt, Ew)
    rEw_1 = fma(fma(1.0 - phi, Fvw_1, -Flat), dt, Ew)
    zero = torch.zeros_like(rEi)
    cEi = torch.minimum(rEi, zero)
    cEw = torch.maximum(rEw, zero)
    Ei1 = flush(cEi + (rEw - cEw))
    Ew1 = flush(cEw + (rEi - cEi))

    Drl = Df + 2.0 * par["rl"]
    ring = par["alpha"] * n * fma(Drl, Drl, -(Df * Df))
    Al = torch.minimum(ring, 1.0 - phi)
    psiEw = (rEw_1 - torch.maximum(rEw_1, zero)) * (1.0 / dt)
    phi_one = phi == 1.0
    Ql = Al / where(phi_one, 1.0, 1.0 - phi) * psiEw
    Ql = where(phi_one, 0.0, Ql)
    Qp = psiEw - Ql
    q = -Qp / (par["Lf"] * par["alpha"] * (par["Dmin"] * par["Dmin"]) * par["hmin"])

    lat_melt_c = -math.pi / 2.0 * par["alpha"]
    lg_den = flush(2.0 * par["Lf"] * h * phi)
    zlg = lg_den == 0.0
    lat_grow = -Df / where(zlg, 1.0, lg_den) * Ql
    lat_grow = where(zlg, 0.0, lat_grow)
    lat_grow = where(h == 0.0, 0.0, lat_grow)
    weld_c = par["kappa"] * par["alpha"] / 4.0 * phi
    rD = fma(fma(weld_c, Df * Df * Df, fma(lat_melt_c, wl, lat_grow)), dt, Df)
    total = flush(fma(q, dt, n))
    zero_total = total == 0.0
    D1 = fma(q, par["Dmin"] * dt, n * rD) / where(zero_total, 1.0, total)
    D1 = where(zero_total, 0.0, D1)
    D1 = torch.minimum(torch.maximum(D1, par["Dmin"]), par["Dmax"])
    D1 = where(Ei1 == 0.0, 0.0, D1)

    rh = fma(-1.0 / par["Lf"] * Fvi_1, dt, h)
    rh = torch.maximum(rh, zero)
    h1 = fma(q, par["hmin"] * dt, n * rh) / where(zero_total, 1.0, total)
    h1 = flush(where(zero_total, 0.0, h1))

    zero_h1 = h1 == 0.0
    phi1 = -Ei1 / where(zero_h1, 1.0, par["Lf"] * h1)
    phi1 = flush(where(zero_h1, 0.0, phi1))
    phi1 = where(phi1 > 1.0, 1.0, phi1)

    Ei1 = where(h1 == 0.0, 0.0, Ei1)
    E = fma(phi1, Ei1, (1.0 - phi1) * Ew1)
    T = fma(Ti, phi1, (1.0 - phi1) * Tw)
    Ti_out = where(Ei1 == 0.0, math.nan, Ti)
    Tw_out = where(phi1 > 0.99, math.nan, Tw)

    carry = dict(Ei=Ei1, Ew=Ew1, h=h1, D=D1, phi=phi1, T0=T0)
    out = dict(E=E, T=T, h=h1, Ei=Ei1, Ew=Ew1, Ti=Ti_out, Tw=Tw_out, D=D1, phi=phi1, n=n)
    return carry, out


class Year:
    """Model years of ``K`` members from ``carry``, step by step: the part
    before the Newton solve, each Newton update and the part after it are
    each one :class:`.common.Replay`, between which the host reads whether
    any member still iterates. ``counter`` holds the members' updates."""

    def __init__(self, grid: Grid, par, f_rows, carry, newton_cfg, dtype, device):
        self.grid, self.par, self.f_rows = grid, par, f_rows
        self.st = statics(grid, par, dtype, device)
        self.cfg = dict(newton_cfg, abstol_t=torch.as_tensor(newton_cfg["abstol"], dtype=dtype,
                                                             device=device))
        self.carry = {k: carry[k].clone() for k in CARRY}
        like = self.carry["Ei"]
        K = like.shape[0]
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        z = lambda: torch.zeros_like(like)
        self.b = dict(insol=z(), Tw=z(), hp=z(), f=torch.zeros((K, 1), dtype=dtype, device=device),
                      T=z(), r=z(), lo=z(), di=z(), up=z(),
                      rnorm=torch.zeros(K, dtype=dtype, device=device),
                      tol=torch.zeros(K, dtype=dtype, device=device),
                      active=torch.zeros(K, dtype=torch.bool, device=device))
        self.counter = torch.zeros((), dtype=torch.long, device=device)
        self.out = {k: z() for k in OUT_VARS}
        self.seasonal = Seasonal(grid, self.out)
        newton_state = [self.b[k] for k in ("T", "r", "lo", "di", "up", "rnorm", "active")]
        self.start = Replay(self._start, list(self.b.values()))
        self.update = Replay(self._update, newton_state + [self.counter])
        state = list(self.carry.values()) + list(self.out.values()) + list(
            self.seasonal.acc.values())
        self.finish = {first: Replay(lambda first=first: self._finish(first), state)
                       for first in (True, False)}

    def _a(self):
        b = self.b
        return _args(b["insol"], b["hp"], b["Tw"], self.carry["phi"], b["f"], self.st, self.par)

    def _start(self):
        st, b = self.st, self.b
        cos_t = st["cosv"].index_select(0, self.t)
        insol = fma(-st["S2"], st["x2"], fma(-st["S1x"], cos_t, st["S0"]))
        b["insol"].copy_(insol)
        b["f"].copy_(self.f_rows.index_select(0, self.t)[0])
        Tw, hp = before_newton(self.carry, self.par)
        b["Tw"].copy_(Tw)
        b["hp"].copy_(hp)
        r, bands, rnorm, tol, active = newton_start(self.carry["T0"], self._a(), self.cfg)
        for k, v in zip(("T", "r", "lo", "di", "up", "rnorm", "tol", "active"),
                        (self.carry["T0"], r, *bands, rnorm, tol, active)):
            b[k].copy_(v)

    def _update(self):
        b = self.b
        self.counter.add_(b["active"].sum())
        T, r, bands, rnorm, active = newton_update(
            b["T"], b["r"], (b["lo"], b["di"], b["up"]), b["rnorm"], b["tol"], b["active"],
            self._a(), self.cfg)
        for k, v in zip(("T", "r", "lo", "di", "up", "rnorm", "active"),
                        (T, r, *bands, rnorm, active)):
            b[k].copy_(v)

    def _finish(self, first: bool):
        b = self.b
        carry, out = after_newton(self.carry, b["T"], b["insol"], b["f"], b["Tw"], self.st,
                                  self.par)
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
            self.start()
            it = 0
            while it < self.cfg["max_iter"] and bool(self.b["active"].any()):
                self.update()
                it += 1
            self.finish[t == 0]()
            self.seasonal.snapshot(t, stores)
        return self.seasonal.average(stores)
