"""Extended EBM with a Marginal Ice Zone (MIZ).

Port of the JAX package's ``models/miz.py`` (itself a rebuild of
EnergyBalanceModel.jl ``src/miz.jl``): separate ice/water enthalpies
``Ei, Ew``, ice concentration ``phi``, floe size ``D``, floe number ``n``,
ice thickness ``h``, lateral melt/growth, pancake-ice formation, floe
welding, and a per-step nonlinear solve for the ice surface temperature by
warm-started Newton with an analytic tridiagonal Jacobian.

Reference quirks reproduced deliberately (JAX ``models/miz.py:14-24``):

- ``D_t``'s lateral-melt term is ``-(pi/2)*alpha*wlat`` — Julia operator
  precedence in ``-pi / 2.0*par.alpha * wlat`` (reference :141).
- ``wlat = m1*(Tw - Tm^m2)`` — the exponent binds to ``Tm`` only (:71);
  ``Tm^m2`` is hoisted into the statics as ``Tm_pow_m2``.
- NaNs are presentation-only: ``Ti``/``Tw`` are NaN-masked at the *end* of a
  step for storage (:193-194) and ``Tw`` NaNs are zeroed at the start of the
  next (:157). The carry stays NaN-free.
- ``n`` stored per step is computed from the *pre-update* ``D`` and ``phi``
  (:160).

``solver='pallas'`` solves a ``(K, nx)`` batch's ``T0`` with the
fixed-iteration Newton kernel (:mod:`..ops.newton_t0`), as the JAX package
does; a single run's ``(nx,)`` state keeps the adaptive Newton.

The Newton root is reverse-differentiable by the implicit function theorem
(:class:`_NewtonRoot`, JAX ``:128-190``): gradients flow through the root,
never through the iterations, so the eager year has a VJP (the equilibrium
layer's ``stability``, ``sensitivity`` and ``calibrate``). The fixed-iteration
``solver='pallas'`` kernel has none: it raises on inputs that require grad.
"""
from __future__ import annotations

import math

import torch

from ..ops.diffusion import diffusion_bands, neighbor_cells
from ..ops.newton import newton_tridiag
from ..ops.newton_t0 import newton_t0
from ..ops.tridiag import tridiag_solve
from ..utils.collection import Collection
from ..utils.numerics import flush_subnormal as flush
from ..utils.numerics import fma, host_cos
from .base import ModelSpec, StepConfig, register_model

__all__ = ["MIZ", "insolation"]


def statics(st, par, dtype, device):
    """Per-run precompute: the factors of the insolation rows, water
    coalbedo, stencil bands (geometry is parameter-free; diffusivity ``D``
    multiplies at use). Table parameters (``S0, S1, S2, a0, a2``) may be
    scalars or ``(K, 1)`` per-member columns; the insolation row of a step is
    built at use (:func:`insolation`), so a swept table parameter costs no
    ``(nt, K, nx)`` table."""
    x = torch.as_tensor(st.x, dtype=dtype, device=device)
    x2 = x * x
    # cos(2 pi t) is built on the host, as the kernel's table is: a device's
    # cos may round differently
    t = torch.as_tensor(st.t, dtype=dtype)
    geom = diffusion_bands(st)
    band = lambda b: torch.as_tensor(b, dtype=dtype, device=device)
    return Collection(
        S0=par["S0"],
        S1x=par["S1"] * x,
        S2=par["S2"],
        x2=x2,
        cosv=host_cos(2.0 * math.pi * t).to(device),
        aw=fma(-par["a2"], x2, par["a0"]),  # water coalbedo (:14)
        glo=band(geom.lo),
        gdi=band(geom.di),
        gup=band(geom.up),
        # a tensor on the run's device: ``psiEwdt / dt`` is then a true
        # division everywhere (PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds differently)
        dt=torch.as_tensor(st.dt, dtype=dtype, device=device),
        # scalar Tm^m2 of ``wlat`` (:71) hoisted out of the step
        Tm_pow_m2=par["Tm"] ** par["m2"],
    )


def insolation(stat, t: int):
    """The insolation bracket of step ``t``, shared by ice and water solar
    terms (reference :11,14): ``(S0 - (S1 x) cos(2 pi t)) - S2 x^2``, the
    same products in the same order as the JAX package's table."""
    return fma(-stat.S2, stat.x2, fma(-stat.S1x, stat.cosv[t], stat.S0))


def init_carry(init, st, dtype, device):
    """Step carry: the five prognostic fields plus the Newton warm start
    ``T0`` (reference ``@persistent T0`` zeros, ``src/miz.jl:47-53``)."""
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return Collection(
        Ei=t(init["Ei"]),
        Ew=t(init["Ew"]),
        h=t(init["h"]),
        D=t(init["D"]),
        phi=t(init["phi"]),
        T0=torch.zeros(st.nx, dtype=dtype, device=device),
    )


def step_inputs(stat, fyear, t: int):
    """The inputs of step ``t``: its insolation row and forcing ``fyear[t]``."""
    return dict(insol=insolation(stat, t), f=fyear[t])


def _dstencil(stat, par, v, axis_name=None, axis=-1):
    """``D∇²v`` via the precomputed bands (reference ``diffusion!``,
    ``src/infrastructure.jl:505-527``); the halo exchange when the grid axis
    is sharded over the mesh axis ``axis_name``."""
    vm1, vp1 = neighbor_cells(v, axis_name, axis)
    return par["D"] * (stat.glo * vm1 + stat.gdi * v + stat.gup * vp1)


def _stencil_sum(glo, gdi, gup, vm1, v, vp1):
    """``glo v_{i-1} + gdi v_i + gup v_{i+1}`` as XLA:CPU contracts it: the
    first product into the first sum, the third into the second."""
    return fma(gup, vp1, fma(glo, vm1, gdi * v))


def _t0_residual(T0, args, axis_name=None, axis=-1, ai_insol=None):
    """The ``T0eq`` residual (reference ``src/miz.jl:33-45``). Inside the
    JAX package's Newton loop ``ai * insol`` is a rounded loop invariant;
    given as ``ai_insol`` it is added as such, else it is contracted, as in
    the residual of the warm start. ``axis_name``: the grid is sharded over
    that mesh axis (halo exchange)."""
    insol, hp, Tw, phi, f, glo, gdi, gup, k, Tm, A, B, ai, D = args
    Ti = torch.minimum(T0, Tm)
    Tb = fma(Ti, phi, (1.0 - phi) * Tw)  # (1 - phi) Tw is rounded (materialised)
    r = k * (Tm - T0) / hp
    r = fma(ai, insol, r) if ai_insol is None else r + ai_insol
    r = r + fma(-B, T0 - Tm, -A)
    Tbm1, Tbp1 = neighbor_cells(Tb, axis_name, axis)
    r = fma(D, _stencil_sum(glo, gdi, gup, Tbm1, Tb, Tbp1), r)
    r = r + f
    return r


def _t0_bands(T0, args, axis_name=None, axis=-1):
    """Analytic tridiagonal Jacobian bands of :func:`_t0_residual`."""
    insol, hp, Tw, phi, f, glo, gdi, gup, k, Tm, A, B, ai, D = args
    g = phi * (T0 < Tm).to(T0.dtype)
    gm1, gp1 = neighbor_cells(g, axis_name, axis)
    jlo = D * glo * gm1
    jdi = fma(D * gdi, g, -k / hp - B)
    jup = D * gup * gp1
    return jlo, jdi, jup


def _t0_residual_vjp(T0, args, u, need):
    """``u^T dr/d args[i]`` of :func:`_t0_residual` for each ``i`` in
    ``need`` (None for the others), each summed to its argument's shape;
    written out, so a backward pass builds no graph of the residual, and
    linear in ``u`` by differentiable operations. At ``T0 == Tm`` the
    ``min(T0, Tm)`` derivative splits half and half, as torch.minimum's and
    jnp.minimum's do."""
    insol, hp, Tw, phi, f, glo, gdi, gup, k, Tm, A, B, ai, D = args
    Ti = torch.minimum(T0, Tm)
    Tb = Ti * phi + (1.0 - phi) * Tw
    Tbm1, Tbp1 = neighbor_cells(Tb)
    Du = D * u
    # the stencil's transpose: Tbm1 = roll(Tb, 1), so its cotangent rolls back
    gTb = torch.roll(Du * glo, -1, -1) + Du * gdi + torch.roll(Du * gup, 1, -1)
    dT = Tm - T0
    tie = (T0 > Tm).to(T0.dtype) + 0.5 * (T0 == Tm).to(T0.dtype)
    terms = (
        lambda: ai * u,                                          # insol
        lambda: -(k * dT) / (hp * hp) * u,                       # hp
        lambda: gTb * (1.0 - phi),                               # Tw
        lambda: gTb * (Ti - Tw),                                 # phi
        lambda: u,                                               # f
        lambda: Du * Tbm1,                                       # glo
        lambda: Du * Tb,                                         # gdi
        lambda: Du * Tbp1,                                       # gup
        lambda: dT / hp * u,                                     # k
        lambda: (k / hp + B) * u + gTb * phi * tie,              # Tm
        lambda: -u,                                              # A
        lambda: dT * u,                                          # B
        lambda: insol * u,                                       # ai
        lambda: (glo * Tbm1 + gdi * Tb + gup * Tbp1) * u,        # D
    )
    out = [None] * len(args)
    for i in need:
        g = terms[i]()
        out[i] = g if g.shape == args[i].shape else g.sum_to_size(args[i].shape)
    return out


def _solver_method(cfg: StepConfig) -> str:
    if cfg.spatial_axis is not None:
        return "spike"  # the grid sharded over a mesh axis
    # 'pallas' names the fixed-iteration kernel; its other solves are PCR
    return "pcr" if cfg.solver == "pallas" else cfg.solver


def _newton_root(T0_warm, args, cfg: StepConfig):
    insol, ai = args[0], args[12]
    ai_insol = ai * insol
    ax, g = cfg.spatial_axis, cfg.grid_axis
    return newton_tridiag(
        lambda T0: (_t0_residual(T0, args, ax, g, ai_insol=ai_insol), _t0_bands(T0, args, ax, g)),
        T0_warm,
        initial=lambda T0: (_t0_residual(T0, args, ax, g), _t0_bands(T0, args, ax, g)),
        abstol=cfg.newton_abstol,
        reltol=cfg.newton_reltol,
        max_iter=cfg.newton_max_iter,
        method=_solver_method(cfg),
        axis_name=ax,
        cond_axis_name=cfg.batch_axis,
        axis=g,
        max_step=cfg.newton_max_step,
    )


class _NewtonRoot(torch.autograd.Function):
    """The Newton root ``T0*`` of ``r(T0, args) = 0`` with the
    implicit-function VJP of JAX ``_newton_root`` (``models/miz.py:128-190``):
    ``dL/dargs = -lam^T dr/dargs`` where ``J^T lam = dL/dT0*``, ``J`` the
    tridiagonal ``dr/dT0`` at the root, and a zero cotangent for the warm
    start. The forward runs the Newton loop without a graph; the backward is
    built of differentiable operations, so a second backward through it (the
    ``J v`` products of ``stability(side='right')``) is exact: it is linear in
    the cotangent, whose derivative it keeps."""

    @staticmethod
    def forward(ctx, cfg, iters, T0_warm, *args):
        with torch.no_grad():
            T0, converged, it = _newton_root(T0_warm, args, cfg)
        iters.append(it)
        ctx.cfg = cfg
        ctx.save_for_backward(T0, *args)
        ctx.mark_non_differentiable(converged)
        return T0, converged

    @staticmethod
    def backward(ctx, gT0, _gconv):
        if ctx.cfg.spatial_axis is not None:
            # the backward runs outside the shards' threads, where no halo
            # exchange or SPIKE solve can reach the other shards
            raise RuntimeError("the MIZ Newton root of a grid-sharded step has no gradient; "
                               "differentiate an unsharded run")
        T0, *args = ctx.saved_tensors
        # the residual is linearised at the root: T0 and the primal args are
        # constants here, the cotangent stays differentiable
        T0 = T0.detach()
        consts = [a.detach() for a in args]
        jlo, jdi, jup = _t0_bands(T0, consts)
        # transposed bands: (J^T)lo[i] = jup[i-1], (J^T)up[i] = jlo[i+1]; the
        # rolled-in boundary entries multiply the zero boundary bands
        jup_m1, _ = neighbor_cells(jup)
        _, jlo_p1 = neighbor_cells(jlo)
        lam = tridiag_solve(jup_m1, jdi, jlo_p1, gT0, method=_solver_method(ctx.cfg))
        need = [i for i in range(len(args)) if ctx.needs_input_grad[3 + i]]
        grads = _t0_residual_vjp(T0, consts, -lam, need)
        return (None, None, None, *grads)


def solve_T0(T0_warm, insol, h, Tw, phi, f, stat, par, cfg: StepConfig):
    """Ice surface temperature from the single-column energy balance
    (reference ``solveTi``'s inner solve, ``src/miz.jl:47-64``)::

        k (Tm - T0)/h + ai S(x,t) - A - B (T0 - Tm)
          + D∇²( phi min(T0,Tm) + (1-phi) Tw ) + f

    with ``h -> hmin`` where ``h == 0`` (:51), solved by warm-started Newton.
    Returns ``(T0, converged, iterations)``; the root carries the
    implicit-function VJP (:class:`_NewtonRoot`).

    With ``solver='pallas'`` a ``(K, nx)`` batch goes to the fixed-iteration
    Newton kernel (:func:`_solve_T0_pallas`); a single run's ``(nx,)`` state
    keeps the adaptive Newton with PCR, as in the JAX package (its
    ``models/miz.py:208``); so does a grid sharded over a mesh axis (SPIKE).
    """
    hp = torch.where(h == 0.0, par["hmin"], h)
    if cfg.solver == "pallas" and T0_warm.ndim >= 2 and cfg.spatial_axis is None:
        return _solve_T0_pallas(T0_warm, insol, hp, Tw, phi, f, stat, par, cfg)
    ref = T0_warm
    args = tuple(
        v if torch.is_tensor(v) else torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
        for v in (insol, hp, Tw, phi, f, stat.glo, stat.gdi, stat.gup,
                  par["k"], par["Tm"], par["A"], par["B"], par["ai"], par["D"])
    )
    iters = []
    T0, converged = _NewtonRoot.apply(cfg, iters, T0_warm, *args)
    return T0, converged, iters[0]


def _solve_T0_pallas(T0_warm, insol, hp, Tw, phi, f, stat, par, cfg: StepConfig):
    """The batched path of ``solver='pallas'``: ``min(newton_max_iter, 6)``
    fixed Newton iterations in one launch of the K10 kernel
    (:func:`..ops.newton_t0.newton_t0`), then one residual evaluation for the
    convergence diagnostic, ``max |r| <= 4 abstol`` per member (JAX
    ``models/miz.py:218-258``). The kernel takes one value of ``k, Tm, A, B,
    ai`` and of the forcing ``f`` per call: a swept one raises (sweep it with
    ``solver='pcr'``); per-member ``D`` is fine."""
    K, nx = T0_warm.shape[0], T0_warm.shape[-1]

    def scalar(name, v):
        if torch.as_tensor(v).ndim != 0:
            raise ValueError(
                f"solver='pallas' requires a scalar {name}; sweep it with solver='pcr'"
            )
        return v

    sc = {n: scalar(f"parameter {n!r}", par[n]) for n in ("k", "Tm", "A", "B", "ai")}
    bt = lambda v: torch.as_tensor(v).expand(K, nx)
    iters = min(cfg.newton_max_iter, 6)
    T0 = newton_t0(
        T0_warm, bt(hp), bt(Tw), bt(phi), bt(insol), stat.glo, stat.gdi, stat.gup,
        par["D"], sc["k"], sc["Tm"], sc["A"], sc["B"], sc["ai"],
        scalar("forcing f (a per-member F)", f),
        max_step=cfg.newton_max_step or 50.0, iters=iters,
    )
    Ti = torch.minimum(T0, par["Tm"])
    Tb = Ti * phi + (1.0 - phi) * Tw
    r = par["k"] * (par["Tm"] - T0) / hp + par["ai"] * insol
    r = r + ((-par["A"]) - par["B"] * (T0 - par["Tm"]))
    r = r + _dstencil(stat, par, Tb) + f
    converged = torch.amax(torch.abs(r), dim=-1) <= cfg.newton_abstol * 4.0
    return T0, converged, iters


def step(carry, xs, stat, par, cfg: StepConfig):
    """One MIZ step (rebuild of ``step!(::Val{:MIZ})``,
    ``src/miz.jl:150-196``, preserving the reference's exact update order
    and masking semantics; line-for-line the JAX package's ``miz.step``,
    with the fused multiply-adds XLA:CPU makes of it, listed in
    :mod:`..utils.numerics`, so the scan engine's first step is JAX's
    bitwise).

    The JAX package computes on backends that flush subnormal results to
    zero (XLA's CPU backend, the TPU); PyTorch and the CUDA kernels keep
    them. Where ice melts away, ``Ei`` and ``phi`` decay by a factor of a few
    hundred per step, through the subnormal range: kept there, ``lg_den``
    and ``total`` become subnormal divisors and ``lat_grow`` reads
    ``-inf * 0``, a NaN. So the step flushes, as those backends do, the
    values that reach a zero test or a division, and the fields it stores
    (``flush``, :func:`..utils.numerics.flush_subnormal`); on normal numbers
    it changes nothing."""
    Ei, Ew, h, Df, phi = carry["Ei"], carry["Ew"], carry["h"], carry["D"], carry["phi"]
    insol, f = xs["insol"], xs["f"]
    dt = stat.dt
    Tm = par["Tm"]
    where = torch.where

    # -- temperatures (:156-158) ---------------------------------------
    # water_temp (:30) with a guarded denominator: a lane with phi == 1 and
    # Ew > 0 would give +inf and cascade to NaN through Tbar's 0*inf (only
    # reachable by float32 rounding); the guard is exact everywhere else
    den = (1.0 - phi) * par["cw"]
    zden = den == 0.0
    Tw = Tm + where(zden, 0.0, Ew / where(zden, 1.0, den))
    Tw = where(torch.isnan(Tw), 0.0, Tw)  # condset!(Tw, 0, isnan) (:157)
    T0, converged, _ = solve_T0(carry["T0"], insol, h, Tw, phi, f, stat, par, cfg)
    Ti = torch.minimum(T0, Tm)  # ice_temp (:31,65)
    Ti = where(h == 0.0, 0.0, Ti)  # zeroref!(Ti, h) (:66)

    # -- floe number from pre-update D, phi (:160, num :83-87) ---------
    # masked divisions guard the denominator with the same mask that
    # discards the lane, so the kept lanes are bitwise compute-then-mask
    zeroD = Df == 0.0
    n = phi / where(zeroD, 1.0, par["alpha"] * (Df * Df))
    n = flush(where(zeroD, 0.0, n))

    # -- fluxes (:162-164) ---------------------------------------------
    Tb = fma(Ti, phi, (1.0 - phi) * Tw)  # Tbar (:21-28)
    L = fma(par["B"], Tb - Tm, par["A"])  # OLR (:99)
    Tbm1, Tbp1 = neighbor_cells(Tb, cfg.spatial_axis, cfg.grid_axis)
    lap = _stencil_sum(stat.glo, stat.gdi, stat.gup, Tbm1, Tb, Tbp1)
    base_i = fma(par["ai"], insol, -L)
    base_w = fma(stat.aw, insol, -L)
    # dTb = D lap: rounded where the JAX step needs both fluxes at once (its
    # product then has two uses), contracted where it needs one
    dTb = par["D"] * lap
    Fvi = base_i + dTb + par["Fb"] + f  # vert_flux ice (:96-101)
    Fvw = base_w + dTb + par["Fb"] + f  # vert_flux water
    Fvi_1 = fma(par["D"], lap, base_i) + par["Fb"] + f
    Fvw_1 = fma(par["D"], lap, base_w) + par["Fb"] + f
    wl = par["m1"] * (Tw - stat["Tm_pow_m2"])  # wlat (:71) — exponent binds to Tm
    Flat = phi * h * par["Lf"] * wl * math.pi / where(zeroD, 1.0, par["alpha"] * Df)  # lat_flux (:103-107)
    Flat = where(zeroD, 0.0, Flat)

    # -- enthalpy forward Euler + redistribution (:166-170, :109-117) --
    rEi = fma(fma(phi, Fvi, Flat), dt, Ei)  # Ei_t (:137)
    rEw = fma(fma(1.0 - phi, Fvw, -Flat), dt, Ew)  # Ew_t (:138)
    # the water enthalpy as the floe-size update reads it, from Fvw alone
    rEw_1 = fma(fma(1.0 - phi, Fvw_1, -Flat), dt, Ew)
    # minimum/maximum, not clamp: the same values, and at a tie (rEi == 0 in
    # every ice-free cell) the gradient splits half and half, as JAX's
    # jnp.minimum/maximum split it; clamp would pass all of it
    zero = torch.zeros_like(rEi)
    cEi = torch.minimum(rEi, zero)  # clamp(rEi, -Inf, 0)
    cEw = torch.maximum(rEw, zero)  # clamp(rEw, 0, Inf)
    psiEidt = rEi - cEi  # >= 0
    psiEwdt = rEw - cEw  # <= 0
    Ei1 = flush(cEi + psiEwdt)
    Ew1 = flush(cEw + psiEidt)

    # -- floe size/thickness updates (:172-181) ------------------------
    Drl = Df + 2.0 * par["rl"]
    ring = par["alpha"] * n * fma(Drl, Drl, -(Df * Df))  # area_lead (:90-93)
    Al = torch.minimum(ring, 1.0 - phi)
    psiEw = (rEw_1 - torch.maximum(rEw_1, zero)) * (1.0 / dt)
    phi_one = phi == 1.0
    Ql = Al / where(phi_one, 1.0, 1.0 - phi) * psiEw  # split_psiEw (:120-125)
    Ql = where(phi_one, 0.0, Ql)  # condset!(Ql, 0, isone, phi)
    Qp = psiEw - Ql
    # psinplus (:127): dn = q dt, contracted into each sum that reads it
    q = -Qp / (par["Lf"] * par["alpha"] * (par["Dmin"] * par["Dmin"]) * par["hmin"])

    # D_t (:140-146) — the reference's operator-precedence quirk:
    # lat_melt = ((-pi)/2.0*alpha)*wlat = -(pi/2) alpha wlat
    lat_melt_c = -math.pi / 2.0 * par["alpha"]
    # guard on the full denominator (h or phi zero): such lanes are always
    # rescued by the zeroref(D, Ei) below — final outputs unchanged
    lg_den = flush(2.0 * par["Lf"] * h * phi)
    zlg = lg_den == 0.0
    lat_grow = -Df / where(zlg, 1.0, lg_den) * Ql
    lat_grow = where(zlg, 0.0, lat_grow)
    lat_grow = where(h == 0.0, 0.0, lat_grow)  # zeroref!(lat_grow, h) (:144)
    weld_c = par["kappa"] * par["alpha"] / 4.0 * phi
    rD = fma(fma(weld_c, Df * Df * Df, fma(lat_melt_c, wl, lat_grow)), dt, Df)
    total = flush(fma(q, dt, n))
    zero_total = total == 0.0
    # average new pancakes (:129-134,176)
    D1 = fma(q, par["Dmin"] * dt, n * rD) / where(zero_total, 1.0, total)
    D1 = where(zero_total, 0.0, D1)
    D1 = torch.minimum(torch.maximum(D1, par["Dmin"]), par["Dmax"])  # clamp (:177)
    D1 = where(Ei1 == 0.0, 0.0, D1)  # zeroref!(D, Ei) (:178)

    rh = fma(-1.0 / par["Lf"] * Fvi_1, dt, h)  # h_t (:139,179)
    rh = torch.maximum(rh, zero)  # clamp!(rh, 0, Inf) (:180)
    h1 = fma(q, par["hmin"] * dt, n * rh) / where(zero_total, 1.0, total)  # (:181)
    h1 = flush(where(zero_total, 0.0, h1))

    # -- concentration (:183, concentration :74-80) --------------------
    zero_h1 = h1 == 0.0
    phi1 = -Ei1 / where(zero_h1, 1.0, par["Lf"] * h1)
    phi1 = flush(where(zero_h1, 0.0, phi1))
    phi1 = where(phi1 > 1.0, 1.0, phi1)

    # -- totals (:185-187) ---------------------------------------------
    Ei1 = where(h1 == 0.0, 0.0, Ei1)  # zeroref!(Ei, h)
    E = fma(phi1, Ei1, (1.0 - phi1) * Ew1)
    T = fma(Ti, phi1, (1.0 - phi1) * Tw)  # Tbar(Ti, Tw, phi) with updated phi

    # -- NaN masking for storage only (:193-194) -----------------------
    Ti_out = where(Ei1 == 0.0, math.nan, Ti)
    Tw_out = where(phi1 > 0.99, math.nan, Tw)

    carry = Collection(Ei=Ei1, Ew=Ew1, h=h1, D=D1, phi=phi1, T0=T0)
    out = Collection(
        E=E, T=T, h=h1, Ei=Ei1, Ew=Ew1, Ti=Ti_out, Tw=Tw_out, D=D1, phi=phi1, n=n,
        # float (1.0 = all converged), min over the batch
        newton_converged=torch.amin(converged.to(Ei.dtype)),
    )
    return carry, out


MIZ = register_model(
    ModelSpec(
        name="MIZ",
        statics=statics,
        init_carry=init_carry,
        step=step,
        step_inputs=step_inputs,
        solution_vars=("E", "T", "h", "Ei", "Ew", "Ti", "Tw", "D", "phi", "n"),
        presentation_nan_vars=("Ti", "Tw"),
        init_vars=("Ei", "Ew", "h", "D", "phi"),
    )
)
