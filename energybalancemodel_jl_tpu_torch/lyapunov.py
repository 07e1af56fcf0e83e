"""Finite-time Lyapunov spectra along trajectories of the year map.

Port of the JAX package's ``lyapunov.py``: the Benettin/QR recipe

    x_{n+1} = Y(x_n),   V <- J(x_n) V,   V = QR,  accumulate log|diag R|

with exact Jacobian-vector products of the eager year
(:func:`..integrate.make_year_fn`). Each year builds one graph of the year at
the current state; its output advances the trajectory, and ``J v`` is a
second backward through the year's VJP, which is linear in its cotangent
(:class:`..equilibrium._Linearization`, where JAX transposes the pullback
with ``jax.linear_transpose``). The MIZ Newton root's VJP keeps its
cotangent's derivative for this (``models/miz.py::_NewtonRoot``). The CUDA
year kernels have no VJP, so this runs the eager year on whichever device it
is given, as the JAX package runs its XLA year graph.

At a converged equilibrium the exponents converge to ``log |lambda_i|`` of
:func:`..equilibrium.stability`'s spectrum; along a transient or a wobbling
attractor they are finite-time averages over the visited states.

MIZ caveat: fully ice-covered cells carry frozen coordinates (``Ew``,
``phi``) that neither grow nor decay, so healthy MIZ attractors report a
leading exponent of 0; ``project=("Ew", "phi")`` zeroes those families, per
year, against the current state's ice mask.

Wide float32 ensembles: a few members per mille may sit on clamp knife-edges
where the f32 reverse year gives NaN growths; the NaN stays in those members
(per-member QR). Screen with ``np.isfinite(result.exponents)``.

``mesh=`` (a 1-D :class:`.parallel.mesh.Mesh`) builds each year graph on
member shards (:func:`.parallel.sharding.shard_member_year`), bitwise the
unsharded run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .convert import to_numpy
from .equilibrium import (_Linearization, _constant, _ensemble_carry, _ensemble_size,
                          _mesh_and_device, _virtual_F, _year_inputs, _year_map)
from .forcing import Forcing
from .integrate import _as_tensor, default_dtype, make_year_fn, resolve_device, resolve_dtype
from .models.base import default_step_config, dtype_name, get_model
from .spacetime import SpaceTime
from .utils.collection import Collection

__all__ = ["lyapunov", "LyapunovResult"]


@dataclasses.dataclass
class LyapunovResult:
    """Result of :func:`lyapunov` (JAX ``LyapunovResult``).

    ``exponents`` are the finite-time Lyapunov exponents in 1/year — the
    mean of ``log |diag R|`` over the counted (post-``transient``) years;
    shape ``(n_modes,)`` for a solo run, ``(K, n_modes)`` for ensembles.
    ``history`` holds every year's log growths, the transient included,
    ``(years, n_modes)`` or ``(years, K, n_modes)``. ``modes`` is the final
    orthonormal tangent block (mode-leading under ``n_modes > 1``), ``state``
    the trajectory's final carry.
    """

    exponents: np.ndarray
    history: np.ndarray
    state: Collection
    modes: Collection
    transient: int
    n_modes: int
    years: int

    def running(self) -> np.ndarray:
        """Cumulative post-transient mean after each counted year; leading
        ``(years - transient,)`` axis."""
        h = self.history[self.transient:]
        n = np.arange(1, h.shape[0] + 1, dtype=np.float64)
        return np.cumsum(h, axis=0) / n.reshape((-1,) + (1,) * (h.ndim - 1))

    @property
    def sem(self) -> np.ndarray:
        """Standard error of the per-year growths over counted years."""
        h = self.history[self.transient:]
        n = max(h.shape[0], 1)
        return np.std(h, axis=0) / np.sqrt(n)

    def __repr__(self):
        lead = np.asarray(self.exponents)[..., 0]
        lam = np.array2string(np.atleast_1d(lead), precision=4)
        return (f"LyapunovResult(lambda_1 = {lam} /yr over "
                f"{self.years - self.transient} counted years "
                f"(+{self.transient} transient), n_modes={self.n_modes})")


def lyapunov(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    years: int = 50,
    n_modes: int = 1,
    transient: int = 0,
    project: Sequence[str] = (),
    seed: int = 0,
    v0: Optional[Collection] = None,
    dtype=None,
    newton_max_iter: int = 30,
    years_per_dispatch: Optional[int] = None,
    member_chunk: Optional[int] = None,
    mesh=None,
    device=None,
) -> LyapunovResult:
    """Finite-time Lyapunov exponents of the year map along a trajectory
    (JAX ``lyapunov``).

    Starts at ``init`` (an init or carry Collection; an
    :func:`..equilibrium.equilibrate` result's ``.state`` measures the
    attractor itself) and runs ``years`` years, propagating ``n_modes``
    orthonormal tangent directions through the exact year-map Jacobian with
    a QR re-orthonormalization each year (``torch.linalg.qr``, batched over
    members). ``exponents[i]`` is the mean of ``log max(|r_ii|, tiny)`` over
    the years after ``transient``.

    ``par`` leaves of shape ``(K,)`` (the virtual ``"F"`` included) make a
    lockstep ensemble. ``project`` names MIZ carry leaves zeroed in fully
    ice-covered cells (``phi >= 0.99`` of the current state, each year).
    ``v0`` seeds the tangent block (mode-leading under ``n_modes > 1``); by
    default ``np.random.default_rng(seed)`` draws it leaf by leaf in carry
    order, as the JAX package does, and the QR stacks the leaves in sorted
    order.

    ``member_chunk=C`` (ensembles; C divides K) advances the trajectory with
    one forward year of the whole ensemble and propagates the tangents slab
    by slab, each slab on a year graph of its own: memory is one slab's
    graph. The year map couples no members, so one slab (C == K) is the
    unchunked run bitwise; on the eager year the MIZ Newton loop runs in
    lockstep over a slab, so several slabs differ at round-off.
    ``years_per_dispatch`` sets how many years run between host reads of
    the growth history (default: all); the result is bitwise the same for
    any value. ``dtype`` defaults to :func:`..integrate.default_dtype`
    (float64 strongly recommended), ``device`` to the CUDA device. ``mesh``
    (a 1-D :class:`..parallel.mesh.Mesh`; an ensemble with ``K``, and each
    slab of ``member_chunk``, divisible by its size) runs each year graph on
    member shards; ``device`` then defaults to the mesh's first device.
    """
    mesh, device = _mesh_and_device(mesh, device)
    spec = get_model(model)
    forcing = _constant(forcing, "lyapunov needs constant forcing (an autonomous year map); "
                                 "sweep levels across members via par['F']")
    years = int(years)
    if years < 1:
        raise ValueError("years must be >= 1")
    transient = int(transient)
    if not 0 <= transient < years:
        raise ValueError("transient must satisfy 0 <= transient < years")
    if years_per_dispatch is not None and int(years_per_dispatch) < 1:
        raise ValueError("years_per_dispatch must be >= 1")
    dtype = default_dtype() if dtype is None else resolve_dtype(dtype)
    device = resolve_device(device)

    par = Collection(par)
    par.pop("__K__", None)
    K = _ensemble_size(par, init, None, None,
                       lambda sizes: f"inconsistent ensemble sizes {sorted(sizes)}")
    ensemble = K is not None
    F_off, forcing = _virtual_F(par, forcing, K)
    cfg = default_step_config(dtype_name(dtype), newton_max_iter=newton_max_iter)
    carry = _ensemble_carry(spec, init, st, dtype, device, K)
    par_t, frow = _year_inputs(par, F_off, K, forcing, st, dtype, device)

    bad = [n for n in project if n not in carry]
    if bad:
        raise ValueError(f"project names {bad} not in the {spec.name} carry "
                         f"{tuple(carry.keys())}")
    if project and "phi" not in carry:
        raise ValueError("project needs a 'phi' carry field to locate fully "
                         "ice-covered cells (MIZ only)")
    project = frozenset(project)
    m = int(n_modes)
    if m < 1:
        raise ValueError("n_modes must be >= 1")
    keys = tuple(carry.keys())
    keys_order = tuple(sorted(keys))
    widths = tuple(int(carry[k].shape[-1]) for k in keys_order)
    if m > sum(widths):
        raise ValueError(f"n_modes={m} exceeds the state dimension {sum(widths)}")
    if member_chunk is not None:
        member_chunk = int(member_chunk)
        if not ensemble:
            raise ValueError(
                "member_chunk= slabs the ensemble tangent propagation; "
                "it needs (K,) par leaves or a member-batched init")
        if member_chunk < 1 or int(K) % member_chunk != 0:
            raise ValueError(
                f"member_chunk={member_chunk} must divide the member count {K}")
    tiny = torch.finfo(dtype).tiny

    def proj(t, frozen):
        if not project:
            return t
        return Collection({k: (torch.where(frozen, 0.0, v) if k in project else v)
                           for k, v in t.items()})

    def to_mat(t):
        return torch.cat([t[k] for k in keys_order], dim=-1)

    def from_mat(x):
        out, i = {}, 0
        for k, w in zip(keys_order, widths):
            out[k] = x[..., i:i + w]
            i += w
        return Collection({k: out[k] for k in keys})

    def fit(t):
        """The normalized block and its growth column: ``(1,)``/``(K, 1)``
        for one mode, ``|diag R|`` of a (per-member) QR for several."""
        if m == 1:
            nrm = torch.clamp(torch.sqrt(sum(torch.sum(x * x, dim=-1) for x in t.values())),
                              min=tiny)
            return Collection({k: x / nrm[..., None] for k, x in t.items()}), nrm[..., None]
        q, r = torch.linalg.qr(torch.movedim(to_mat(t), 0, -1))  # (n, m) solo, (K, n, m)
        lam = torch.abs(torch.diagonal(r, dim1=-2, dim2=-1))
        return from_mat(torch.movedim(q, -1, 0)), lam

    rng = np.random.default_rng(seed)
    want = {k: (tuple(v.shape) if m == 1 else (m,) + tuple(v.shape)) for k, v in carry.items()}
    if v0 is None:
        v0 = Collection({k: rng.standard_normal(shape) for k, shape in want.items()})
    else:
        miss = {k for k in want if k not in v0 or tuple(np.shape(v0[k])) != want[k]}
        if miss:
            raise ValueError(
                f"v0 leaves {sorted(miss)} missing or mis-shaped; expected "
                f"{ {k: want[k] for k in sorted(want)} }")
    # numpy leaves are copied: another package's results may be read-only
    v = Collection({k: _as_tensor(v0[k] if torch.is_tensor(v0[k]) else np.array(v0[k]), dtype,
                                  device) for k in want})
    frozen0 = (carry["phi"] >= 0.99) if project else None
    v = fit(proj(v, frozen0))[0]

    year = _year_map(spec, st, cfg, mesh, K)

    def tangents(lin, t):
        """``J t`` on a linearization: one second backward per mode."""
        if m == 1:
            return lin.right(t)
        cols = [lin.right(Collection({k: x[j] for k, x in t.items()})) for j in range(m)]
        return Collection({k: torch.stack([c[k] for c in cols]) for k in t})

    v_ax = 1 if m > 1 else 0  # the tangent block's member axis

    def slab(i, t, ax=0):
        """Members ``i*C .. (i+1)*C`` of ``t`` along axis ``ax``."""
        s = slice(i * member_chunk, (i + 1) * member_chunk)
        return Collection({k: x[(slice(None),) * ax + (s,)] for k, x in t.items()})

    def par_slab(i):
        s = slice(i * member_chunk, (i + 1) * member_chunk)
        p = Collection({k: (x[s] if x.ndim >= 2 else x) for k, x in par_t.items()})
        return p, (frow[:, s] if frow.ndim >= 3 else frow)

    def one_year(carry, v):
        frozen = (carry["phi"] >= 0.99) if project else None
        if member_chunk is None:
            lin = _Linearization(year, carry, par_t, frow, keys, "right")
            new = Collection({k: o.detach() for k, o in zip(keys, lin.outs)})
            jv = tangents(lin, v)
        else:
            # the trajectory advances on a forward year of the whole
            # ensemble; each slab's tangents on a year graph of its own
            with torch.no_grad():
                new = year(carry, par_t, frow)[0]
            parts = []
            for i in range(int(K) // member_chunk):
                p_s, f_s = par_slab(i)
                lin = _Linearization(year, slab(i, carry), p_s, f_s, keys, "right")
                parts.append(tangents(lin, slab(i, v, v_ax)))
                del lin  # one slab's graph at a time
            jv = Collection({k: torch.cat([p[k] for p in parts], dim=v_ax) for k in keys})
        with torch.no_grad():
            v, lam = fit(proj(jv, frozen))
            return new, v, torch.log(torch.clamp(lam, min=tiny))

    chunk = years if years_per_dispatch is None else int(years_per_dispatch)
    hist, done = [], 0
    while done < years:
        k = min(chunk, years - done)
        logs = []
        for _ in range(k):
            carry, v, loglam = one_year(carry, v)
            logs.append(loglam)
        hist.append(to_numpy(torch.stack(logs)))  # one host read per chunk
        done += k
    history = np.concatenate(hist, axis=0).astype(np.float64)
    exponents = history[transient:].mean(axis=0)
    return LyapunovResult(
        exponents=np.asarray(exponents), history=history, state=to_numpy(carry),
        modes=to_numpy(v), transient=transient, n_modes=m, years=years)
