"""Gradient-based parameter calibration.

Port of the JAX package's ``calibrate.py``: the eager year is
reverse-differentiable end to end (the MIZ Newton root carries an
implicit-function VJP, masked divisions are cotangent-safe), so physical
parameters can be fit to target diagnostics by gradient descent, here with
``torch.optim.Adam`` where the JAX package uses ``optax.adam``::

    import energybalancemodel_jl_tpu_torch as ebt

    result = ebt.calibrate(
        "MIZ", st, ebt.Forcing(0.0), par, ebt.zeros_init(st),
        target={"T": T_obs},          # seasonal annual-mean targets, (nx,)
        vary=("D", "A"),              # parameters to fit
        steps=150, dtype="float64", device="cpu",
    )
    result.params["D"]                # fitted values
    result.par                        # full fitted parameter Collection

Caveats (JAX ``calibrate.py:25-39``): the system is chaotic, so calibrate
against one-to-few-year seasonal means, or against the equilibrium
(``equilibrium=True``); MIZ misfit landscapes are jagged in the parameters,
so locate the basin with a sweep and polish with ``calibrate``
(``n_starts``/``theta0`` run several starts as one lockstep batch).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .forcing import Forcing
from .integrate import default_dtype, make_year_fn, resolve_device, resolve_dtype
from .models.base import default_step_config, dtype_name, get_model
from .solutions import Seasonal
from .spacetime import SpaceTime
from .utils.collection import Collection

__all__ = ["calibrate", "CalibrationResult"]


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of :func:`calibrate` (JAX ``CalibrationResult``).

    ``params``: fitted values of the varied parameters; ``par``: the full
    parameter Collection with them substituted; ``losses``: ``(steps,)``,
    ``losses[i]`` the loss after ``i + 1`` optimizer steps (the last one
    evaluated at the returned parameters); ``grads``: the gradient there.
    Multi-start runs report the best start (smallest finite final loss with
    finite fitted values) and fill ``best``, ``start_params`` and
    ``start_losses``.
    """

    params: Collection
    par: Collection
    losses: np.ndarray
    grads: Collection
    best: Optional[int] = None
    start_params: Optional[Collection] = None
    start_losses: Optional[np.ndarray] = None

    def __repr__(self):
        fitted = ", ".join(f"{k}={float(v):.6g}" for k, v in self.params.items())
        starts = (f", best of {len(self.start_losses)} starts"
                  if self.start_losses is not None else "")
        if len(self.losses) == 0:
            return f"CalibrationResult({fitted}; 0 steps{starts})"
        return (f"CalibrationResult({fitted}; loss {self.losses[0]:.3e} -> "
                f"{self.losses[-1]:.3e} in {len(self.losses)} steps{starts})")


def _default_loss(target: Dict[str, np.ndarray], nan_ok: Sequence[str] = ()):
    """Mean-squared misfit of the final year's seasonal annual means against
    ``target`` (JAX ``calibrate.py:101``): for presentation-NaN variables
    (``nan_ok``) cells NaN on either side are masked out; for every other
    variable a NaN prediction where the target is finite means the run
    diverged, and scores an infinite loss. NaN target cells are excluded."""
    nan_ok = frozenset(nan_ok)

    def loss(seasonal):
        total = 0.0
        for k, v in target.items():
            pred = seasonal.avg[k]
            v = torch.as_tensor(np.asarray(v), dtype=pred.dtype, device=pred.device)
            tgt_ok = ~torch.isnan(v)
            if k in nan_ok:
                valid = tgt_ok & ~torch.isnan(pred)
            else:
                valid = tgt_ok
                diverged = torch.any(torch.isnan(pred) & tgt_ok)
                total = total + torch.where(diverged, float("inf"), 0.0).to(pred.dtype)
            diff = torch.nan_to_num(pred) - torch.nan_to_num(v)
            total = total + torch.mean(torch.where(valid, diff, 0.0) ** 2)
        return total

    return loss


def calibrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    target: Optional[Dict[str, np.ndarray]] = None,
    vary: Sequence[str] = ("D",),
    loss: Optional[Callable] = None,
    steps: int = 100,
    learning_rate: float = 1e-2,
    optimizer=None,
    newton_max_iter: int = 30,
    dtype=None,
    equilibrium: bool = False,
    equilibrium_tol: float = 1e-9,
    equilibrium_max_years: int = 500,
    n_starts: Optional[int] = None,
    start_spread: float = 0.1,
    seed: int = 0,
    theta0: Optional[Dict[str, np.ndarray]] = None,
    device=None,
) -> CalibrationResult:
    """Fit the parameters named in ``vary`` so the run's final-year seasonal
    diagnostics match ``target`` (or minimize a custom ``loss``; JAX
    ``calibrate``).

    ``target`` maps solution variables to arrays compared against the final
    simulated year's ``seasonal.avg`` under mean-squared error; ``loss`` is a
    callable ``Seasonal -> scalar`` on one member's store (NaN is
    presentation in ``T``/``Ti``/``Tw``). Exactly one of them is given. The
    forward model runs ``st.dur`` eager years and backpropagates through all
    of them, or with ``equilibrium=True`` solves the year-map fixed point to
    ``equilibrium_tol`` within ``equilibrium_max_years`` and differentiates
    it by the implicit-function adjoint
    (:func:`.equilibrium.make_equilibrium_seasonal_fn`; constant forcing).

    ``optimizer``: a callable mapping the list of fitted parameter tensors
    to a ``torch.optim.Optimizer`` (default ``torch.optim.Adam(params,
    lr=learning_rate)``, the update rule of ``optax.adam``); ``steps``
    updates are run. ``n_starts=S`` perturbs each varied parameter by a
    factor ``1 + U(-start_spread, start_spread)`` (start 0 unperturbed;
    additive for a zero base value), ``theta0`` gives explicit ``(S,)``
    starts; the S starts run as one lockstep batch of members with an
    optimizer over ``(S,)`` tensors, elementwise, so each start is its own
    optimization. ``dtype`` defaults to :func:`..integrate.default_dtype`
    (float32 warns), ``device`` to the CUDA device (``"cpu"`` for the CPU).
    """
    if (target is None) == (loss is None):
        raise ValueError("pass exactly one of target= or loss=")
    spec = get_model(model)
    missing = [n for n in vary if n not in par]
    if missing:
        raise ValueError(f"vary names {missing} not in par")
    if target is not None:
        unknown = [k for k in target if k not in spec.solution_vars]
        if unknown:
            raise ValueError(f"target variables {unknown} not in {spec.solution_vars}")
        loss = _default_loss(target, nan_ok=spec.presentation_nan_vars)
    if dtype is None:
        dtype = default_dtype()
        if dtype != torch.float64:
            warnings.warn(
                "calibrating in float32 (the default dtype): f32 Newton-solve gradient "
                "noise is comparable to small parameter sensitivities — pass "
                "dtype='float64' (or torch.set_default_dtype(torch.float64)) for "
                "reliable fits")
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter)
    as_t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                                     device=device)
    base = Collection({k: as_t(v) for k, v in par.items()})
    init_carry = spec.init_carry(init, st, dtype, device)
    f_tab = as_t(forcing.table(st))

    multi = (n_starts is not None) or (theta0 is not None)
    if theta0 is not None:
        missing = [n for n in vary if n not in theta0]
        if missing:
            raise ValueError(f"theta0 missing varied names {missing}")
        th0 = {n: np.atleast_1d(np.asarray(theta0[n], dtype=np.float64)) for n in vary}
        sizes = {v.shape[0] for v in th0.values()}
        if len(sizes) != 1:
            raise ValueError(f"theta0 leaves must share one length, got {sorted(sizes)}")
        S = sizes.pop()
        if n_starts is not None and int(n_starts) != S:
            raise ValueError(f"n_starts={n_starts} conflicts with theta0 length {S}")
    elif multi:
        S = int(n_starts)
        if S < 1:
            raise ValueError("n_starts must be >= 1")
        rng = np.random.default_rng(seed)
        th0 = {}
        for n in vary:
            val = float(np.asarray(par[n]))
            u = rng.uniform(-1.0, 1.0, S)
            pert = val * (1.0 + start_spread * u) if val != 0.0 else start_spread * u
            pert[0] = val
            th0[n] = pert
    else:
        th0 = {n: np.asarray(par[n], dtype=np.float64) for n in vary}
    theta = {n: as_t(v).requires_grad_(True) for n, v in th0.items()}

    if multi:
        # the S starts as S members: (S, 1) parameter columns, (S, nx) state
        carry0 = Collection({k: v.expand(S, st.nx) for k, v in init_carry.items()})

        def params(th):
            p = Collection(base)
            for n in vary:
                p[n] = th[n][:, None]
            return p

        def member_losses(seasonal):
            return torch.stack([
                loss(Seasonal(*(Collection({k: v[i] for k, v in c.items()})
                                for c in seasonal)))
                for i in range(S)])
    else:
        carry0 = init_carry

        def params(th):
            p = Collection(base)
            p.update(th)
            return p

        member_losses = loss

    if equilibrium:
        if not forcing.constant:
            raise ValueError("equilibrium=True needs constant forcing (equilibria do not "
                             "exist under a ramp)")
        from .equilibrium import make_equilibrium_seasonal_fn

        eq_fn = make_equilibrium_seasonal_fn(model, st, cfg, dtype_name(dtype),
                                             tol=float(equilibrium_tol),
                                             max_years=int(equilibrium_max_years))

        def final_seasonal(p):
            return eq_fn(p, f_tab[0], carry0)
    else:
        year = make_year_fn(model, st, cfg, False)

        def final_seasonal(p):
            c, seasonal = carry0, None
            for frow in f_tab:
                c, seasonal, _conv, _ = year(c, p, frow)
            return seasonal

    def value_and_grad(th):
        with torch.enable_grad():
            val = member_losses(final_seasonal(params(th)))
            grads = torch.autograd.grad(val.sum(), [th[n] for n in vary], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(th[n]))
                 for n, g in zip(vary, grads)}
        return val.detach(), grads

    leaves = [theta[n] for n in vary]
    opt = (torch.optim.Adam(leaves, lr=learning_rate) if optimizer is None
           else optimizer(leaves))
    losses = []
    for _ in range(int(steps)):
        val, grads = value_and_grad(theta)
        for n in vary:
            theta[n].grad = grads[n]
        opt.step()
        losses.append(val)
    final_val, grads = value_and_grad(theta)
    losses.append(final_val)
    losses = losses[1:]  # (steps,): drop the pre-fit initial loss
    losses = (np.stack([v.cpu().numpy() for v in losses]).astype(np.float64) if losses
              else np.zeros((0,) + ((S,) if multi else ())))
    theta = {n: v.detach().cpu().numpy() for n, v in theta.items()}
    grads = {n: g.detach().cpu().numpy() for n, g in grads.items()}
    full = Collection({k: np.asarray(v) for k, v in par.items()})
    if multi:
        best = 0
        if len(losses):
            final = losses[-1]
            ok = np.isfinite(final)
            for v in theta.values():
                ok &= np.isfinite(v)
            if ok.any():
                best = int(np.argmin(np.where(ok, final, np.inf)))
            else:
                warnings.warn(
                    "all calibration starts diverged (non-finite loss or fitted values); "
                    "reporting start 0 — shrink learning_rate/start_spread or check the "
                    "configuration")
        start_losses = losses[-1] if len(losses) else np.full(S, np.nan)
        fitted = Collection({k: v[best] for k, v in theta.items()})
        full.update(fitted)
        return CalibrationResult(
            params=fitted, par=full,
            losses=losses[:, best] if len(losses) else losses.reshape(0),
            grads=Collection({k: v[best] for k, v in grads.items()}),
            best=best, start_params=Collection(theta), start_losses=np.asarray(start_losses))
    fitted = Collection(theta)
    full.update(fitted)
    return CalibrationResult(params=fitted, par=full, losses=losses, grads=Collection(grads))
