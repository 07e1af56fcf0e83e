"""Equilibrium parameter sensitivities in one reverse pass.

Port of the JAX package's ``sensitivity.py``. The equilibrium seasonal
state is a differentiable function of the parameters
(:func:`.equilibrium.make_equilibrium_seasonal_fn`, the implicit-function
adjoint through the year-map fixed point), so the derivative of a scalar
climate diagnostic with respect to every parameter costs one reverse pass.
:class:`SensitivityResult` reports raw gradients and elasticities
(``p * dg/dp``), with ``.top()`` ranking the influential knobs.

Caveats inherited from the adjoint: the MIZ year map carries exact neutral
frozen-cell modes, so leaves whose true equilibrium sensitivity diverges
(the constant forcing level is one) return their best truncated value.
float64 is strongly recommended.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .equilibrium import _ensemble_size, _virtual_F, make_equilibrium_seasonal_fn
from .forcing import Forcing
from .integrate import default_dtype, resolve_device, resolve_dtype
from .models.base import default_step_config, dtype_name, get_model
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.numerics import hemispheric_mean

__all__ = ["sensitivity", "SensitivityResult"]


@dataclasses.dataclass
class SensitivityResult:
    """Result of :func:`sensitivity` (JAX ``SensitivityResult``).

    ``value`` is the objective at the equilibrium; ``grads`` maps each
    parameter name to ``dg/dp`` (and ``"F"`` to the constant-forcing
    sensitivity, the summed forcing-row cotangent). ``elasticity(name)`` is
    ``p * dg/dp`` (the raw gradient where ``p == 0``); ``top(n)`` ranks
    parameters by its magnitude. Elasticities compare fractional changes,
    misleading for offset-scaled parameters such as ``Tm`` (Kelvin): read
    the raw gradient there.
    """

    of: str
    value: Union[float, np.ndarray]
    grads: Collection
    par: Collection

    def elasticity(self, name: str):
        g = np.asarray(self.grads[name], dtype=np.float64)
        p = (np.asarray(self.par[name], dtype=np.float64)
             if name in self.par else np.zeros(()))
        e = np.where(p != 0.0, g * p, g)
        return float(e) if e.ndim == 0 else e

    def top(self, n: int = 10):
        """The ``n`` most influential parameters as ``(name, dg/dp,
        elasticity)``, by descending ``|elasticity|`` (ensembles rank by the
        worst member)."""
        rows = [(k, self.grads[k], self.elasticity(k)) for k in self.grads]
        rows.sort(key=lambda r: -float(np.max(np.abs(r[2]))))
        return rows[:n]

    def __repr__(self):
        def mag(e):
            return float(np.max(np.abs(np.atleast_1d(e))))

        lead = ", ".join(f"{k}: {mag(e):.3g}" for k, _, e in self.top(3))
        v = np.atleast_1d(np.asarray(self.value, dtype=np.float64))
        val = (f"{float(v[0]):.6g}" if v.size == 1
               else f"{v.size} members, mean {float(v.mean()):.6g}")
        return f"SensitivityResult({self.of} = {val}; top |elasticities| {lead})"


def objective_fn(of: str, var: Optional[str], spec, st: SpaceTime):
    """The scalar diagnostic ``seasonal store -> value`` of :func:`sensitivity`
    (per member for a ``(K, nx)`` store): ``2 pi <phi>`` for
    ``of="ice_area"``, the normalized hemispheric mean of ``var`` for
    ``of="mean"``; presentation NaNs count zero."""
    if of == "ice_area":
        if "phi" not in spec.solution_vars:
            raise ValueError(
                "of='ice_area' needs the MIZ phi field; the classic ice indicator "
                "(E < 0) has zero gradient a.e. — use of='mean' with var='T' or var='E'")

        def objective(coll):
            return 2.0 * math.pi * hemispheric_mean(torch.nan_to_num(coll["phi"]), st.x)
    elif of == "mean":
        if var is None or var not in spec.solution_vars:
            raise ValueError(f"of='mean' needs var= one of {sorted(spec.solution_vars)}")

        def objective(coll):
            v = coll[var]
            x = torch.as_tensor(st.x, dtype=v.dtype, device=v.device)
            return hemispheric_mean(torch.nan_to_num(v), x) / (x[-1] - x[0])
    else:
        raise ValueError(f"unknown objective {of!r}; 'ice_area' or 'mean'")
    return objective


def sensitivity(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    of: str = "ice_area",
    var: Optional[str] = None,
    season: str = "avg",
    wrt: Optional[Sequence[str]] = None,
    tol: float = 1e-9,
    max_years: int = 500,
    dtype=None,
    newton_max_iter: int = 30,
    device=None,
) -> SensitivityResult:
    """Differentiate a scalar equilibrium diagnostic with respect to every
    parameter (JAX ``sensitivity``).

    ``of``: ``"ice_area"`` (``2 pi <phi>``, MIZ only) or ``"mean"`` (the
    hemispheric mean of ``var`` normalized by ``x[-1] - x[0]``), on the
    equilibrium's ``season`` store. ``wrt`` restricts the reported names
    (default: every ``par`` key plus the constant forcing level ``"F"``).
    The fixed point is solved to ``tol`` within ``max_years``; the gradient
    is the implicit-function adjoint (up to 500 VJP years), never an
    unroll. ``par`` leaves of shape ``(K,)``, the virtual ``"F"`` included,
    make a lockstep ensemble whose gradients come back ``(K,)``, each member
    as its solo run; ``init`` may be ``(nx,)`` or ``(K, nx)``. ``dtype``
    defaults to :func:`..integrate.default_dtype` (float32 warns), ``device``
    to the CUDA device (``"cpu"`` for the CPU).
    """
    spec = get_model(model)
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("sensitivity needs constant forcing (equilibria do not exist "
                         "under a ramp)")
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    device = resolve_device(device)
    if dtype != torch.float64:
        warnings.warn(
            "sensitivity at float32: the adjoint composes many reverse years and "
            "frozen-cell lanes carry spurious f32 gain (stability docstring) — "
            "float64 strongly recommended.")

    par = Collection(par)
    par.pop("__K__", None)
    K = _ensemble_size(par, init, None, None,
                       lambda sizes: f"inconsistent ensemble sizes {sorted(sizes)}")
    F_off, forcing = _virtual_F(par, forcing, K)
    objective = objective_fn(of, var, spec, st)
    if wrt is not None:  # checked before the solve: the names are known
        unknown = [k for k in wrt if k not in par and k != "F"]
        if unknown:
            raise ValueError(f"wrt names {unknown} not in {sorted(list(par) + ['F'])}")

    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter)
    eq_fn = make_equilibrium_seasonal_fn(model, st, cfg, dtype_name(dtype), tol=float(tol),
                                         max_years=int(max_years))
    as_t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                                     device=device)
    frow = as_t(forcing.table(st)[0])
    carry0 = spec.init_carry(init, st, dtype, device)
    if K is None:
        par_t = Collection({k: as_t(v).requires_grad_(True) for k, v in par.items()})
        frow_t = frow.clone().requires_grad_(True)
    else:
        # a lockstep ensemble: every leaf per member, forcing rows carrying
        # the virtual "F" offsets, (nt, K, 1) time leading
        par_t = Collection({k: as_t(np.full((K,), np.asarray(v, np.float64)))[:, None]
                            .contiguous().requires_grad_(True) for k, v in par.items()})
        rows = frow[:, None].expand(st.nt, K)
        if F_off is not None:
            rows = rows + as_t(F_off)[None, :]
        frow_t = rows[:, :, None].contiguous().requires_grad_(True)
        carry0 = Collection({k: (v if v.ndim > 1 else v.expand(K, st.nx))
                             for k, v in carry0.items()})
    with torch.enable_grad():
        value = objective(getattr(eq_fn(par_t, frow_t, carry0), season))
        grads = torch.autograd.grad(value.sum(), list(par_t.values()) + [frow_t],
                                    allow_unused=True)
    zero = lambda x: torch.zeros_like(x)
    out = {k: (g if g is not None else zero(v)).detach().cpu().numpy()
           for (k, v), g in zip(par_t.items(), grads[:-1])}
    fbar = grads[-1] if grads[-1] is not None else zero(frow_t)
    # constant forcing enters every step additively: dg/dF is the summed
    # forcing-row cotangent
    out["F"] = fbar.detach().cpu().numpy().sum(axis=0).reshape(-1) if K is not None \
        else fbar.detach().cpu().numpy().sum()
    out = {k: (float(v) if K is None else np.asarray(v).reshape(K)) for k, v in out.items()}
    if wrt is not None:
        out = {k: out[k] for k in wrt}
    rep_par = Collection(par)
    rep_par["F"] = (float(forcing.base) if F_off is None
                    else float(forcing.base) + np.asarray(F_off, np.float64))
    value = value.detach().cpu().numpy()
    return SensitivityResult(
        of=of if of == "ice_area" else f"mean({var})",
        value=float(value) if value.ndim == 0 else value,
        grads=Collection(out),
        par=rep_par,
    )
